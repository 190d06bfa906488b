// One-shot causal prefill attention on Hopper's tensor cores.
//
// Replaces the TPU kernel `flash_attention` of kivi_tpu/kernels/flash.py
// (body `_flash_kernel`).  Contract: kivi_tpu_torch/kernels/flash.py
// `flash_attention_plain` (the `impl="jnp"` prefill attention of
// kivi_tpu/core/attention.py).
//
// Query row t of head h attends key positions p of KV head h / r with
// p <= t, p >= pad_b (left pad of batch row b) and, with a sliding
// window, p > t - window.  A query row with no admitted key (a padded
// row, t < pad_b) comes out exactly 0.  Unlike the extend kernel, the
// causal diagonal is NOT exempt from the pad mask: prefill zeroes padded
// rows, extend keeps them finite through the diagonal.
//
// Rounding: both products take bf16 operands with f32 accumulation, as
// the Pallas kernel's MXU products do (q, k, v are bf16 already; p is
// rounded to bf16 before PV, `p.astype(v.dtype)` there).  The softmax and
// its sums stay f32; the output is rounded to bf16 once.
//
// Bound on the H100: bytes, barely.  At the main path's shapes (B=8,
// H=32, T=1024, D=128) it reads q, k, v and writes out, 4 x 67.1 MB =
// 268 MB, 0.080 ms at 3.35 TB/s; its 4*B*H*D*T(T+1)/2 = 6.9e10 FLOPs take
// 0.070 ms at the bf16 tensor-core rate (989 TFLOP/s).  The f32 CUDA-core
// version (67 TFLOP/s peak) could not come within 15x of that.
//
// Design (attn_wgmma.cuh): a block of 256 threads owns 128 query rows of
// one (batch, head), two warpgroups of 64 rows each, so each staged K/V
// chunk feeds 128 rows.  Blocks run longest causal tiles first (the grid's
// fast axis is the head, its slow axis the tile, in reverse).  The block
// walks key chunks of CK = 128 (64 ran 11% slower on the H100) from
// max(pad_b, first row - window + 1) to its last row only; K and V of KV
// head h / r are read by index, never expanded per query head.  Chunk
// n+1's K and V are in flight (cp.async into the second of two buffers)
// while chunk n is multiplied: S = Q K^T by wgmma from shared memory, the
// online softmax on S's accumulator fragment (masks from each element's
// row and column; exp2 with the scale folded in), P converted in registers
// to the A operand of O += P V, V read transposed by its descriptor.  A
// warpgroup skips a chunk none of its rows can see; a warp masks only a
// chunk that straddles one of its rows' bounds.  T not a multiple of the
// tile is zero-filled and masked; so are the tile's columns past D (any
// D <= 128 with D % 16 == 0 runs in the 128-column tiles).

#include "attn_wgmma.cuh"

namespace {

constexpr int QROWS = 128;   // query rows per block: two warpgroups
constexpr int NT = 256;
constexpr int DP = 128;      // tile columns (D zero-padded)
constexpr int CK = 128;      // keys per staged chunk

__global__ void __launch_bounds__(NT, 1)
flash_prefill_kernel(const __nv_bfloat16* __restrict__ q,
                     const __nv_bfloat16* __restrict__ k,
                     const __nv_bfloat16* __restrict__ v,
                     const int* __restrict__ pad_ptr,
                     __nv_bfloat16* __restrict__ out, int Hq, int Hkv,
                     int T, int D, int sw, float sm_scale) {
    extern __shared__ __align__(128) uint8_t smem[];
    constexpr uint32_t KV_BYTES = 2 * CK * DP * 2;   // a buffer: K, then V
    const uint32_t s_q = wg::smem_addr(smem);
    const uint32_t s_kv = s_q + QROWS * DP * 2;

    const int bh = blockIdx.x, b = bh / Hq, h = bh % Hq;
    const int row0 = (gridDim.y - 1 - blockIdx.y) * QROWS;
    const long long kvh = (long long)b * Hkv + h / (Hq / Hkv);
    const int tid = threadIdx.x;
    const int pad = pad_ptr ? max(pad_ptr[b], 0) : 0;
    const __nv_bfloat16* kb = k + kvh * T * D;
    const __nv_bfloat16* vb = v + kvh * T * D;

    // live keys of the block: [c_first, hi)
    const int hi = min(row0 + QROWS, T);
    int lo = pad;
    if (sw > 0) lo = max(lo, row0 - sw + 1);
    const int c_first = (lo / CK) * CK;

    auto stage_chunk = [&](int c0, int buf) {
        const uint32_t kt = s_kv + buf * KV_BYTES;
        const long long o = (long long)c0 * D;
        wg::stage_rows<DP>(kt, kb + o, CK, T - c0, D, tid, NT);
        wg::stage_rows<DP>(kt + CK * DP * 2, vb + o, CK, T - c0, D, tid,
                           NT);
    };
    wg::stage_rows<DP>(s_q, q + ((long long)bh * T + row0) * D, QROWS,
                       T - row0, D, tid, NT);
    if (c_first < hi) stage_chunk(c_first, 0);
    wg::cp_commit();

    // this warpgroup's 64 rows, this thread's two, and this warp's 16
    const int wgi = tid >> 7, warp = (tid >> 5) & 3;
    const int wrow0 = row0 + 64 * wgi;
    const int wg_hi = min(wrow0 + 64, T);   // keys it can see: < wg_hi
    int wg_lo = pad;                        // ... and >= wg_lo
    if (sw > 0) wg_lo = max(wg_lo, wrow0 - sw + 1);
    const int row[2] = {wrow0 + wg::frag_row(0), wrow0 + wg::frag_row(2)};
    const int r_first = wrow0 + 16 * warp, r_last = r_first + 15;

    float m[2] = {KIVI_NEG_INF, KIVI_NEG_INF}, l[2] = {0.f, 0.f};
    float o[DP / 2];
#pragma unroll
    for (int i = 0; i < DP / 2; ++i) o[i] = 0.f;

    int it = 0;
    for (int c0 = c_first; c0 < hi; c0 += CK, ++it) {
        wg::cp_wait_all();
        wg::fence_async_smem();
        __syncthreads();   // chunk it landed; every reader of it - 1 done
        if (c0 + CK < hi) stage_chunk(c0 + CK, (it + 1) & 1);
        wg::cp_commit();
        if (c0 >= wg_hi || c0 + CK <= wg_lo) continue;   // warpgroup-uniform

        const uint32_t kt = s_kv + (it & 1) * KV_BYTES;
        float s[CK / 2];
        wg::fence_regs(s);
        wg::arrive();
        wg::qk<DP, CK>(s, s_q + wgi * 64 * DP * 2, kt);
        wg::commit();
        wg::wait_all();
        wg::fence_regs(s);

        auto ok = [&](int i) {
            const int t = row[(i >> 1) & 1], pos = c0 + wg::frag_col(i);
            return t < T && pos <= t && pos >= pad
                   && (sw <= 0 || pos > t - sw);
        };
        // every key of the chunk admitted for every row of this warp?
        const bool full = r_last < T && c0 + CK - 1 <= r_first && c0 >= pad
                          && (sw <= 0 || c0 > r_last - sw);
        uint32_t pf[CK / 4];
        if (full)
            wg::softmax_step<CK, DP / 2, false>(s, ok, sm_scale, m, l, o, pf);
        else
            wg::softmax_step<CK, DP / 2, true>(s, ok, sm_scale, m, l, o, pf);

        wg::fence_regs(o);
        wg::arrive();
        wg::pv<DP, CK>(o, pf, kt + CK * DP * 2);
        wg::commit();
        wg::wait_all();
        wg::fence_regs(o);
    }
    wg::cp_wait_all();   // a block with no live chunk still staged Q

    // a row with no admitted key has l == 0 and o == 0: exact 0
    float inv[2];
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
        const float lr = wg::quad_sum(l[hh]);
        inv[hh] = lr > 0.f ? 1.f / lr : 0.f;
    }
#pragma unroll
    for (int i = 0; i < DP / 2; i += 2) {
        const int hh = (i >> 1) & 1, t = row[hh], col = wg::frag_col(i);
        if (t < T && col < D)
            *reinterpret_cast<uint32_t*>(out + ((long long)bh * T + t) * D
                                         + col) =
                wg::pack_bf16(o[i] * inv[hh], o[i + 1] * inv[hh]);
    }
}

int launch(const void* q, const void* k, const void* v, const void* pad,
           void* out, int B, int Hq, int Hkv, int T, int D, int sw,
           float sm_scale, cudaStream_t stream) {
    const int smem = QROWS * DP * 2 + 2 * (2 * CK * DP * 2);
    auto kern = flash_prefill_kernel;
    cudaError_t e = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return (int)e;
    dim3 grid(B * Hq, (T + QROWS - 1) / QROWS);
    kern<<<grid, NT, smem, stream>>>(
        (const __nv_bfloat16*)q, (const __nv_bfloat16*)k,
        (const __nv_bfloat16*)v, (const int*)pad, (__nv_bfloat16*)out, Hq,
        Hkv, T, D, sw, sm_scale);
    return (int)cudaGetLastError();
}

// The tile machinery alone (a card test): one warpgroup computes
//   mode 0: out (64, n) = a (64, DP) b^T, b (n, DP): qk<DP, n>;
//   mode 1: out (64, DP) = bf16(a) (64, n) b, b (n, DP): pv<DP, n>, a
//           taken through the accumulator fragment and packed as P is.
template <int N, int MODE>
__global__ void __launch_bounds__(128)
wgmma_tile_kernel(const __nv_bfloat16* __restrict__ a,
                  const __nv_bfloat16* __restrict__ bm,
                  float* __restrict__ out) {
    extern __shared__ __align__(128) uint8_t smem[];
    const uint32_t ta = wg::smem_addr(smem), tb = ta + 64 * DP * 2;
    const int tid = threadIdx.x;
    if (MODE == 0) {
        wg::stage_rows<DP>(ta, a, 64, 64, DP, tid, 128);
        wg::stage_rows<DP>(tb, bm, N, N, DP, tid, 128);
    } else {
        wg::stage_rows<DP>(tb, bm, N, N, DP, tid, 128);
    }
    wg::cp_commit();
    wg::cp_wait_all();
    wg::fence_async_smem();
    __syncthreads();
    if (MODE == 0) {
        float d[N / 2];
        wg::fence_regs(d);
        wg::arrive();
        wg::qk<DP, N>(d, ta, tb);
        wg::commit();
        wg::wait_all();
        wg::fence_regs(d);
#pragma unroll
        for (int i = 0; i < N / 2; ++i)
            out[wg::frag_row(i) * N + wg::frag_col(i)] = d[i];
    } else {
        float s[N / 2], d[DP / 2];
        uint32_t pf[N / 4];
#pragma unroll
        for (int i = 0; i < N / 2; ++i)
            s[i] = to_f(a[wg::frag_row(i) * N + wg::frag_col(i)]);
#pragma unroll
        for (int x = 0; x < N / 4; ++x)
            pf[x] = wg::pack_bf16(s[2 * x], s[2 * x + 1]);
#pragma unroll
        for (int i = 0; i < DP / 2; ++i) d[i] = 0.f;
        wg::fence_regs(d);
        wg::arrive();
        wg::pv<DP, N>(d, pf, tb);
        wg::commit();
        wg::wait_all();
        wg::fence_regs(d);
#pragma unroll
        for (int i = 0; i < DP / 2; ++i)
            out[wg::frag_row(i) * DP + wg::frag_col(i)] = d[i];
    }
}

template <int N, int MODE>
int launch_tile(const void* a, const void* b, void* out,
                cudaStream_t stream) {
    const int smem = (64 + 128) * DP * 2;
    auto kern = wgmma_tile_kernel<N, MODE>;
    cudaError_t e = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return (int)e;
    kern<<<1, 128, smem, stream>>>((const __nv_bfloat16*)a,
                                   (const __nv_bfloat16*)b, (float*)out);
    return (int)cudaGetLastError();
}

}  // namespace

extern "C" int kivi_flash_prefill(const void* q, const void* k,
                                  const void* v, const void* pad, void* out,
                                  int B, int Hq, int Hkv, int T, int D,
                                  int sliding_window, float sm_scale,
                                  void* stream) {
    if (Hkv <= 0 || Hq % Hkv || D > DP || D % 16 || T <= 0)
        return (int)cudaErrorInvalidValue;
    return launch(q, k, v, pad, out, B, Hq, Hkv, T, D, sliding_window,
                  sm_scale, (cudaStream_t)stream);
}

// n and mode as the two kernels use the tile: S = Q K^T over 16 (qhist's
// zero-point rows), 64 or 128 keys; O += P V over 64 or 128.
extern "C" int kivi_wgmma_tile(const void* a, const void* b, void* out,
                               int n, int mode, void* stream) {
    cudaStream_t st = (cudaStream_t)stream;
#define KIVI_TILE(N_, M_)                                        \
    if (n == N_ && mode == M_) return launch_tile<N_, M_>(a, b, out, st);
    KIVI_TILE(16, 0) KIVI_TILE(64, 0) KIVI_TILE(128, 0)
    KIVI_TILE(64, 1) KIVI_TILE(128, 1)
#undef KIVI_TILE
    return (int)cudaErrorInvalidValue;
}

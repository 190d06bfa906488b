// Extend (chunked-prefill) attention over the KIVI cache on Hopper's
// tensor cores.
//
// Replaces the TPU kernel `flash_extend_attention` of
// kivi_tpu/kernels/flash_extend.py (body `_full_kernel`).  Contract:
// kivi_tpu_torch/kernels/flash_extend.py `flash_extend_attention_plain`
// (the `impl="jnp"` extend attention of kivi_tpu/core/attention.py).
//
// T1 suffix queries (R = r*T1 folded rows, row rr*T1 + i holds query
// position T0 + i, T0 = n_k_quant + n_k_win) attend, in one online
// softmax, the packed K/V history [0, n_k_quant), the fp K window
// [n_k_quant, T0) and their own causal self block (k_new/v_new).  V is
// routed by position: positions < n_v_quant read the V store, the rest
// of the history reads v_win row pos - n_v_quant.  A per-row lower bound
// (left pad, sliding window) masks the history; the causal diagonal is
// exempt inside the predicate, so a fully padded row never empties
// (unlike flash.cu, which zeroes padded rows).
//
// Rounding, as the Pallas kernel at its default compute_dtype=bf16
// (kivi_tpu/kernels/flash_extend.py:373-379): both products take bf16
// operands with f32 accumulation.  History K^ is code * scale rounded to
// bf16 once, its zero point apart as a product q . mn of its own (mn in
// hi + lo bf16 rows, hist_tile.cuh); history V^ is code * scale + mn
// rounded once; window and new rows are bf16 already; p is rounded to
// bf16 before PV.  m, l and the output stay f32.
//
// Bound on the H100: at the main path's shapes (B=8, H=32, T1=128,
// D=128, 896 cached tokens) the bytes read (live codes, scales, windows
// and the bf16 queries and new K/V, ~40 MB) take ~12 us at 3.35 TB/s,
// and the 4*R*positions*D FLOPs per head (16.1 GFLOP) ~16 us at the bf16
// tensor-core rate: operations, barely.  The f32 CUDA-core version ran
// 89x that bound.
//
// Design (attn_wgmma.cuh, hist_tile.cuh): one block of 256 threads (two
// warpgroups of 64 query rows) per (128-row query tile, batch * KV
// head).  The block walks its positions from its rows' lowest bound
// (rounded down to a chunk) to its last causal position in chunks of
// CK = 64 positions; chunks wholly below every row's bound or past the
// tile's last row are never visited, and a warpgroup skips the chunks
// none of its rows sees.  Chunk n+1 is in flight while chunk n is dequantized
// and multiplied: its packed K/V words and scales (history positions)
// by cp.async into the second of two raw buffers, its fp rows (k_win /
// v_win / k_new / v_new, zeros past the end) by cp.async straight into
// the second of two operand buffers.  Chunk n's history rows are then
// dequantized into its operand buffer, and S = Q K^T and Z = Q mn^T run
// on wgmma; the groups' q . mn is added to S through a quad shuffle,
// the online softmax runs on the accumulator fragment (every mask from
// an element's row and column), and O += P V reads V transposed.

#include <limits.h>

#include "hist_tile.cuh"

namespace {

using hq::DP;
using hq::NT;
constexpr int QROWS = 128;   // query rows per block: two warpgroups
// Positions per chunk.  128 ran 11% faster at the main path's shapes on
// the H100 (0.1508 vs 0.1694 ms) but needs 236-244 KB of shared memory at
// 8 bits (more than the 227 KB a block may hold) and 16 zero-point rows
// at group size 8; 64 serves every case.
constexpr int CK = 64;
constexpr int OPB = 2 * CK * DP * 2;   // one operand buffer: K^, then V^

int smem_bytes(const hq::Raw& rl) {   // Q, two operand buffers, Z, raw
    return QROWS * DP * 2 + 2 * OPB + 16 * DP * 2 + 2 * rl.bytes;
}

// cp.async the fp rows [max(c0, start), c0 + CK) of a chunk into an
// operand tile: position pos < T0 reads row pos - start of `win`, pos <
// Tend row pos - T0 of `fresh`, later ones are zero-filled (as are the
// columns past D).  Lanes 0-7 fill one core matrix, as wg::stage_rows.
__device__ __forceinline__ void stage_fp(uint32_t tile, int c0, int start,
                                         int T0, int Tend,
                                         const __nv_bfloat16* win,
                                         const __nv_bfloat16* fresh, int D) {
    const int kj0 = max(start - c0, 0);
    if (kj0 >= CK) return;   // a chunk of history rows only
    for (int idx = threadIdx.x; idx < CK * (DP / 8); idx += NT) {
        const int r8 = idx & 7, cc = (idx >> 3) % (DP / 8);
        const int kj = ((idx >> 3) / (DP / 8)) * 8 + r8, pos = c0 + kj;
        if (kj < kj0) continue;
        const __nv_bfloat16* src = nullptr;
        if (pos < T0)
            src = win + (long long)(pos - start) * D;
        else if (pos < Tend)
            src = fresh + (long long)(pos - T0) * D;
        const bool ok = src != nullptr && cc * 8 < D;
        wg::cp16(tile + wg::tile_off<DP>(kj, cc * 8),
                 ok ? (const void*)(src + cc * 8) : (const void*)fresh, ok);
    }
}

template <typename ST>
__global__ void __launch_bounds__(NT, 1)
flash_extend_kernel(const __nv_bfloat16* __restrict__ q,
                    const uint32_t* __restrict__ k_codes,
                    const ST* __restrict__ k_scale,
                    const ST* __restrict__ k_mn,
                    const uint32_t* __restrict__ v_codes,
                    const ST* __restrict__ v_scale,
                    const ST* __restrict__ v_mn,
                    const __nv_bfloat16* __restrict__ k_win,
                    const __nv_bfloat16* __restrict__ v_win,
                    const __nv_bfloat16* __restrict__ k_new,
                    const __nv_bfloat16* __restrict__ v_new,
                    const int* __restrict__ pad_ptr,
                    float* __restrict__ out, int H, int R, int T1, int D,
                    int Tmax, int W, int gs, int k_bits, int v_bits,
                    int nkq, int nkw, int nvq, int sw, float sm_scale) {
    extern __shared__ __align__(128) uint8_t smem[];
    __shared__ int lo_s[2], hi_s[2];
    constexpr int SB = sizeof(ST);
    uint8_t* const p_q = smem;
    uint8_t* const p_op = p_q + QROWS * DP * 2;   // two operand buffers
    uint8_t* const p_z = p_op + 2 * OPB;
    uint8_t* const p_raw = p_z + 16 * DP * 2;     // two raw buffers

    const int tid = threadIdx.x, lane = tid & 31, wgi = tid >> 7;
    const int bh = blockIdx.y, b = bh / H;
    const int row0 = blockIdx.x * QROWS;
    const int T0 = nkq + nkw, Tend = T0 + T1;
    const int hist_end = max(nkq, nvq);   // chunks below it stage words
    const int KDw = D / (32 / k_bits), VDw = D / (32 / v_bits);
    const int gsh = __ffs(gs) - 1;        // gs is a power of two
    const int Tg = Tmax >> gsh, Dg = D >> gsh, ngk = max(1, CK >> gsh);
    const int pad = pad_ptr ? max(pad_ptr[b], 0) : 0;
    const hq::Raw rl = hq::raw_layout<CK>(KDw, VDw, ngk, D, Dg, SB);
    const __nv_bfloat16* const kw_b = k_win + (long long)bh * W * D;
    const __nv_bfloat16* const vw_b = v_win + (long long)bh * W * D;
    const __nv_bfloat16* const kn_b = k_new + (long long)bh * T1 * D;
    const __nv_bfloat16* const vn_b = v_new + (long long)bh * T1 * D;

    // this thread's two rows: query position, lower bound
    int row[2], qpos[2], rlo[2];
    bool live[2];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
        row[h] = row0 + 64 * wgi + wg::frag_row(2 * h);
        live[h] = row[h] < R;
        qpos[h] = T0 + row[h] % T1;
        rlo[h] = sw > 0 ? max(pad, qpos[h] - (sw - 1)) : pad;
    }
    if (tid < 2) {
        lo_s[tid] = INT_MAX;
        hi_s[tid] = 0;
    }
    // the operand tiles' columns past D stay 0 (dequant writes d < D)
    for (int i = tid; i < (2 * OPB + 16 * DP * 2) / 16; i += NT)
        *(uint4*)(p_op + 16 * i) = make_uint4(0u, 0u, 0u, 0u);
    __syncthreads();
#pragma unroll
    for (int h = 0; h < 2; ++h) {
        if (live[h] && (lane & 3) == 0) {
            atomicMin(&lo_s[wgi], min(rlo[h], qpos[h]));
            atomicMax(&hi_s[wgi], qpos[h] + 1);
        }
    }
    __syncthreads();
    // positions a warpgroup sees: [wg_lo, wg_hi); the block walks both
    const int wg_lo = lo_s[wgi], wg_hi = hi_s[wgi];
    const int c_end = max(hi_s[0], hi_s[1]);
    const int c_first = (min(lo_s[0], lo_s[1]) / CK) * CK;

    auto stage_chunk = [&](int c0, int buf) {
        if (c0 < hist_end)
            hq::stage_raw<CK>(wg::smem_addr(p_raw) + buf * rl.bytes, rl,
                              k_codes, k_scale, k_mn, v_codes, v_scale, v_mn,
                              (long long)bh, c0, KDw, VDw, D, Dg, Tmax, Tg,
                              ngk, gsh, nkq, nvq);
        const uint32_t t = wg::smem_addr(p_op) + buf * OPB;
        stage_fp(t, c0, nkq, T0, Tend, kw_b, kn_b, D);
        stage_fp(t + CK * DP * 2, c0, nvq, T0, Tend, vw_b, vn_b, D);
    };

    wg::stage_rows<DP>(wg::smem_addr(p_q),
                       q + ((long long)bh * R + row0) * D, QROWS, R - row0,
                       D, tid, NT);
    if (c_first < c_end) stage_chunk(c_first, 0);
    wg::cp_commit();

    const uint32_t t_q = wg::smem_addr(p_q) + wgi * 64 * DP * 2;
    const uint32_t t_z = wg::smem_addr(p_z);
    float m[2] = {KIVI_NEG_INF, KIVI_NEG_INF}, l[2] = {0.f, 0.f};
    float o[DP / 2];
#pragma unroll
    for (int i = 0; i < DP / 2; ++i) o[i] = 0.f;

    int it = 0;
    for (int c0 = c_first; c0 < c_end; c0 += CK, ++it) {
        wg::cp_wait_all();
        __syncthreads();   // chunk it landed; chunk it - 1's products done
        if (c0 + CK < c_end) stage_chunk(c0 + CK, (it + 1) & 1);
        wg::cp_commit();
        uint8_t* const p_k = p_op + (it & 1) * OPB;
        if (c0 < hist_end)
            hq::dequant_chunk<CK, ST>(p_k, p_k + CK * DP * 2, p_z,
                                      p_raw + (it & 1) * rl.bytes, rl, c0,
                                      nkq, nvq, D, ngk, gsh, k_bits, v_bits);
        wg::fence_async_smem();   // dequantized and landed fp rows
        __syncthreads();          // operand tiles written
        if (c0 >= wg_hi || c0 + CK <= wg_lo) continue;   // warpgroup-uniform

        const uint32_t t_k = wg::smem_addr(p_k), t_v = t_k + CK * DP * 2;
        float s[CK / 2], z[8];
        wg::fence_regs(s);
        wg::fence_regs(z);
        wg::arrive();
        wg::qk<DP, CK>(s, t_q, t_k);
        wg::qk<DP, 16>(z, t_q, t_z);
        wg::commit();
        wg::wait_all();
        wg::fence_regs(s);
        wg::fence_regs(z);
        if (c0 < nkq) hq::add_qmn<CK>(s, z, c0, gs, gsh);

        // causal, and above the row's bound or on its diagonal
        auto ok = [&](int i) {
            const int h = (i >> 1) & 1, pos = c0 + wg::frag_col(i);
            return live[h] && pos <= qpos[h]
                   && (pos >= rlo[h] || pos == qpos[h]);
        };
        // every position of the chunk admitted for every row of the warp?
        const bool full = __all_sync(
            0xffffffffu, live[0] && live[1]
                             && c0 + CK - 1 <= min(qpos[0], qpos[1])
                             && c0 >= max(rlo[0], rlo[1]));
        uint32_t pf[CK / 4];
        if (full)
            wg::softmax_step<CK, DP / 2, false>(s, ok, sm_scale, m, l, o, pf);
        else
            wg::softmax_step<CK, DP / 2, true>(s, ok, sm_scale, m, l, o, pf);

        wg::fence_regs(o);
        wg::arrive();
        wg::pv<DP, CK>(o, pf, t_v);
        wg::commit();
        wg::wait_all();
        wg::fence_regs(o);
    }
    wg::cp_wait_all();   // a block with no live chunk still staged Q

    // every live row admits its diagonal, so l > 0
    float inv[2];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
        const float lr = wg::quad_sum(l[h]);
        inv[h] = lr > 0.f ? 1.f / lr : 0.f;
    }
#pragma unroll
    for (int i = 0; i < DP / 2; i += 2) {
        const int h = (i >> 1) & 1, col = wg::frag_col(i);
        if (live[h] && col < D)
            *(float2*)(out + ((long long)bh * R + row[h]) * D + col) =
                make_float2(o[i] * inv[h], o[i + 1] * inv[h]);
    }
}

template <typename ST>
int launch(const void* q, const void* kc, const void* ks, const void* km,
           const void* vc, const void* vs, const void* vm, const void* kw,
           const void* vw, const void* kn, const void* vn, const void* pad,
           void* out, int B, int H, int R, int T1, int D, int Tmax, int W,
           int gs, int kb, int vb, int nkq, int nkw, int nvq, int sw,
           float sm_scale, cudaStream_t stream) {
    const hq::Raw rl = hq::raw_layout<CK>(
        D / (32 / kb), D / (32 / vb), CK / gs > 1 ? CK / gs : 1, D, D / gs,
        (int)sizeof(ST));
    const int smem = smem_bytes(rl);
    auto kern = flash_extend_kernel<ST>;
    cudaError_t e = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return (int)e;
    dim3 grid((R + QROWS - 1) / QROWS, B * H);
    kern<<<grid, NT, smem, stream>>>(
        (const __nv_bfloat16*)q, (const uint32_t*)kc, (const ST*)ks,
        (const ST*)km, (const uint32_t*)vc, (const ST*)vs, (const ST*)vm,
        (const __nv_bfloat16*)kw, (const __nv_bfloat16*)vw,
        (const __nv_bfloat16*)kn, (const __nv_bfloat16*)vn,
        (const int*)pad, (float*)out, H, R, T1, D, Tmax, W, gs, kb, vb, nkq,
        nkw, nvq, sw, sm_scale);
    return (int)cudaGetLastError();
}

}  // namespace

extern "C" int kivi_flash_extend(const void* q, const void* k_codes,
                                 const void* k_scale, const void* k_mn,
                                 const void* v_codes, const void* v_scale,
                                 const void* v_mn, const void* k_win,
                                 const void* v_win, const void* k_new,
                                 const void* v_new, const void* pad,
                                 void* out, int B, int H, int R, int T1,
                                 int D, int Tmax, int W, int gs, int k_bits,
                                 int v_bits, int n_k_quant, int n_k_win,
                                 int n_v_quant, int sliding_window,
                                 int scale_is_f32, float sm_scale,
                                 void* stream) {
    if (D > DP || D % 16 || gs < 8 || (gs & (gs - 1)) || Tmax % gs
        || n_k_quant % gs)
        return (int)cudaErrorInvalidValue;
    cudaStream_t st = (cudaStream_t)stream;
#define KIVI_EXTEND(ST_)                                                      \
    return launch<ST_>(q, k_codes, k_scale, k_mn, v_codes, v_scale, v_mn,    \
                       k_win, v_win, k_new, v_new, pad, out, B, H, R, T1, D,  \
                       Tmax, W, gs, k_bits, v_bits, n_k_quant, n_k_win,       \
                       n_v_quant, sliding_window, sm_scale, st)
    if (scale_is_f32) KIVI_EXTEND(float);
    KIVI_EXTEND(__nv_bfloat16);
#undef KIVI_EXTEND
}

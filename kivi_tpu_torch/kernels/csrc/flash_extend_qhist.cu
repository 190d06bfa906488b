// Partial flash state of extend queries over the quantized history, split
// over T, on Hopper's tensor cores.
//
// Replaces the TPU kernel `flash_extend_qhist` of
// kivi_tpu/kernels/flash_extend.py (body `_kernel`).  Contract:
// kivi_tpu_torch/kernels/flash_extend.py `flash_extend_qhist_plain`.
//
// R = r*T1 folded query rows (row rr*T1 + i holds query position
// seq_len + i) against the history [0, n_k_quant): logits scaled by
// sm_scale, masked by pos < n_k_quant and the per-row lower bound (left
// pad, sliding window); V from the packed store below n_v_quant and from
// v_win row pos - n_v_quant above it.  Returns the UNNORMALIZED flash
// state (acc (R, D), m (R), l (R)); a row that sees nothing gives the
// neutral element (0, -1e30, 0).  The caller merges it with the window
// and causal self logits (core.attention._extend_attention_qhist).
//
// Rounding, as the Pallas kernel at its default compute_dtype=bf16
// (kivi_tpu/kernels/flash_extend.py:72-77, 132-157): the products take
// bf16 operands with f32 accumulation.  K's operand is code * scale
// rounded to bf16 once; its zero point stays apart, q . mn added to the
// f32 logits per group row (folding mn into the bf16 operand would round
// it with the far larger code*scale + mn).  q . mn is a product of its
// own whose mn operand is split into two bf16 terms (hi + lo), so it
// keeps f32-class accuracy for f32 scales too.  V's operand is
// code * scale + mn (or the v_win row) rounded to bf16 once; p is rounded
// to bf16 before PV.  m, l and the merge stay f32.
//
// Bound on the H100: operations at the slice's shapes.  At batch 1, 8 KV
// heads, R = 4*128 rows, D = 128 and 12K cached tokens the products are
// 4*R*12K*D per head, ~25 GFLOP, ~26 us at the bf16 tensor-core rate,
// against ~9 MB of live store (~3 us at 3.35 TB/s).  The f32 CUDA-core
// version (67 TFLOP/s peak) ran 86x this bound.
//
// Design (attn_wgmma.cuh): blocks over (128-row query tiles, batch * KV
// head, SPLIT-position splits of the history); a split wholly below
// every row's lower bound exits at once with l = 0.  A block of 256
// threads is two warpgroups of 64 rows (the registers of the two f32
// accumulators bound the rows a block can hold, so each of the R/128
// query tiles of a split dequantizes the split again: 4x at the slice).
// It walks its split in chunks of CK = 64 positions.  Chunk n+1's packed
// K/V words and scales are in flight (cp.async into the second of two
// raw buffers) while chunk n is dequantized by the block's threads into
// bf16 operand tiles (hist_tile.cuh, shared with the full extend kernel:
// K: code*scale; V: code*scale + mn below n_v_quant, here v_win rows
// above and zeros past n_k_quant; the zero-point rows hi/lo) and
// multiplied: S = Q K^T and Z = Q mn^T by wgmma, the
// groups' q . mn added to S in registers (a quad shuffle), the online
// softmax on the fragment, O += P V with V read transposed.  A second
// kernel merges the splits of each row in order: m = max m_s over splits
// with l_s > 0, l = sum l_s exp(m_s - m), acc = sum acc_s exp(m_s - m)
// (bit-reproducible runs).

#include <limits.h>

#include "hist_tile.cuh"

namespace {

using hq::DP;
using hq::NT;
constexpr int SPLIT = 512;     // history positions per block (multiple of CK)
constexpr int CK = 64;         // positions per chunk
constexpr int QROWS = 128;     // query rows per block: two warpgroups
constexpr int MERGE_ROWS = 4;  // rows per merge block, one warp each

constexpr int tiles_bytes() {   // Q (QROWS), K^ and V^ (CK), Z (16 rows)
    return (QROWS + 2 * CK + 16) * DP * 2;
}

template <typename ST>
__global__ void __launch_bounds__(NT, 1)
qhist_split_kernel(const __nv_bfloat16* __restrict__ q,
                   const uint32_t* __restrict__ k_codes,
                   const ST* __restrict__ k_scale,
                   const ST* __restrict__ k_mn,
                   const uint32_t* __restrict__ v_codes,
                   const ST* __restrict__ v_scale,
                   const ST* __restrict__ v_mn,
                   const __nv_bfloat16* __restrict__ v_win,
                   const int* __restrict__ pad_ptr,
                   float* __restrict__ part_acc, float* __restrict__ part_m,
                   float* __restrict__ part_l, int H, int R, int T1, int D,
                   int Tmax, int W, int gs, int k_bits, int v_bits, int nkq,
                   int nvq, int t0tot, int sw, int nsplit, float sm_scale) {
    extern __shared__ __align__(128) uint8_t smem[];
    __shared__ int range_lo;
    constexpr int SB = sizeof(ST);
    uint8_t* const p_q = smem;
    uint8_t* const p_k = p_q + QROWS * DP * 2;
    uint8_t* const p_v = p_k + CK * DP * 2;
    uint8_t* const p_z = p_v + CK * DP * 2;
    uint8_t* const p_raw = p_z + 16 * DP * 2;

    const int tid = threadIdx.x, lane = tid & 31, wgi = tid >> 7;
    const int bh = blockIdx.y, b = bh / H, sp = blockIdx.z;
    const int row0 = blockIdx.x * QROWS;
    const int s0 = sp * SPLIT, s1 = min(s0 + SPLIT, nkq);
    const int KDw = D / (32 / k_bits), VDw = D / (32 / v_bits);
    const int gsh = __ffs(gs) - 1;   // gs is a power of two
    const int Tg = Tmax >> gsh, Dg = D >> gsh, ngk = max(1, CK >> gsh);
    const int pad = pad_ptr ? pad_ptr[b] : 0;
    const long long prow = ((long long)bh * nsplit + sp) * R;
    const hq::Raw rl = hq::raw_layout<CK>(KDw, VDw, ngk, D, Dg, SB);

    // this thread's two rows and their lower bounds
    int row[2], rlo[2];
    bool live[2];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
        row[h] = row0 + 64 * wgi + wg::frag_row(2 * h);
        live[h] = row[h] < R;
        int lo = max(pad, 0);
        if (sw > 0) lo = max(lo, t0tot + row[h] % T1 - (sw - 1));
        rlo[h] = lo;
    }
    if (tid == 0) range_lo = INT_MAX;
    __syncthreads();
#pragma unroll
    for (int h = 0; h < 2; ++h)
        if (live[h] && (lane & 3) == 0) atomicMin(&range_lo, rlo[h]);
    __syncthreads();
    const int c_begin = max(s0, (range_lo / CK) * CK);
    if (c_begin >= s1) {   // no row of the tile sees this split
#pragma unroll
        for (int h = 0; h < 2; ++h) {
            if (live[h] && (lane & 3) == 0) {
                part_m[prow + row[h]] = KIVI_NEG_INF;
                part_l[prow + row[h]] = 0.f;
            }
        }
        return;
    }

    // ---- raw staging of chunk c0 into buffer buf (cp.async) ----
    auto stage_raw = [&](int c0, int buf) {
        hq::stage_raw<CK>(wg::smem_addr(p_raw) + buf * rl.bytes, rl, k_codes,
                          k_scale, k_mn, v_codes, v_scale, v_mn, bh, c0, KDw,
                          VDw, D, Dg, Tmax, Tg, ngk, gsh, nkq, nvq);
    };

    // ---- dequantize raw buffer buf into the bf16 operand tiles ----
    auto dequant = [&](int c0, int buf) {
        hq::dequant_chunk<CK, ST>(p_k, p_v, p_z, p_raw + buf * rl.bytes, rl,
                                  c0, nkq, nvq, D, ngk, gsh, k_bits, v_bits);
        // V^ at and above n_v_quant: v_win rows, zeros past n_k_quant
        const int wlo = min(max(c0, nvq) - c0, CK);
        for (int idx = tid; idx < (CK - wlo) * (D / 8); idx += NT) {
            const int kj = wlo + idx / (D / 8), cc = idx % (D / 8);
            const int pos = c0 + kj;
            uint4 x = make_uint4(0u, 0u, 0u, 0u);
            if (pos < nkq)
                x = *(const uint4*)(v_win + ((long long)bh * W + pos - nvq) * D
                                    + cc * 8);
            *(uint4*)(p_v + wg::tile_off<DP>(kj, cc * 8)) = x;
        }
    };

    wg::stage_rows<DP>(wg::smem_addr(p_q),
                       q + ((long long)bh * R + row0) * D, QROWS, R - row0,
                       D, tid, NT);
    stage_raw(c_begin, 0);
    wg::cp_commit();
    // the operand tiles' columns past D stay 0
    for (int i = tid; i < (2 * CK + 16) * DP * 2 / 16; i += NT)
        *(uint4*)(p_k + 16 * i) = make_uint4(0u, 0u, 0u, 0u);

    const uint32_t t_q = wg::smem_addr(p_q) + wgi * 64 * DP * 2;
    const uint32_t t_k = wg::smem_addr(p_k), t_v = wg::smem_addr(p_v);
    const uint32_t t_z = wg::smem_addr(p_z);
    float m[2] = {KIVI_NEG_INF, KIVI_NEG_INF}, l[2] = {0.f, 0.f};
    float o[DP / 2];
#pragma unroll
    for (int i = 0; i < DP / 2; ++i) o[i] = 0.f;

    int it = 0;
    for (int c0 = c_begin; c0 < s1; c0 += CK, ++it) {
        wg::cp_wait_all();
        __syncthreads();   // raw chunk it landed; chunk it - 1's products done
        if (c0 + CK < s1) stage_raw(c0 + CK, (it + 1) & 1);
        wg::cp_commit();
        dequant(c0, it & 1);
        wg::fence_async_smem();
        __syncthreads();   // operand tiles written

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

        hq::add_qmn<CK>(s, z, c0, gs, gsh);

        auto ok = [&](int i) {
            const int h = (i >> 1) & 1, pos = c0 + wg::frag_col(i);
            return live[h] && pos < s1 && pos >= rlo[h];
        };
        const bool full = __all_sync(
            0xffffffffu, live[0] && live[1] && c0 + CK <= s1
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

    float lq[2];
#pragma unroll
    for (int h = 0; h < 2; ++h) lq[h] = wg::quad_sum(l[h]);
#pragma unroll
    for (int i = 0; i < DP / 2; i += 2) {
        const int h = (i >> 1) & 1, col = wg::frag_col(i);
        if (live[h] && col < D)
            *(float2*)(part_acc + (prow + row[h]) * D + col) =
                make_float2(o[i], o[i + 1]);
    }
    if ((lane & 3) == 0) {
#pragma unroll
        for (int h = 0; h < 2; ++h) {
            if (!live[h]) continue;
            // nothing admitted: m may have left -1e30 by a scaled max
            part_m[prow + row[h]] = lq[h] > 0.f ? m[h] : KIVI_NEG_INF;
            part_l[prow + row[h]] = lq[h];
        }
    }
}

// One warp per (batch * KV head, row): merge the splits' flash states in
// split order.  Splits with l == 0 saw nothing and are skipped (their acc
// may be unwritten).  No split seen: (0, -1e30, 0).
__global__ void __launch_bounds__(32 * MERGE_ROWS)
qhist_merge_kernel(const float* __restrict__ part_acc,
                   const float* __restrict__ part_m,
                   const float* __restrict__ part_l, float* __restrict__ acc,
                   float* __restrict__ m_out, float* __restrict__ l_out, int R,
                   int D, int nsplit) {
    const long long bh = blockIdx.y;
    const int row = blockIdx.x * MERGE_ROWS + (threadIdx.x >> 5);
    const int lane = threadIdx.x & 31;
    if (row >= R) return;
    float M = KIVI_NEG_INF;
    for (int sp = 0; sp < nsplit; ++sp) {
        const long long i = (bh * nsplit + sp) * R + row;
        if (part_l[i] > 0.f) M = fmaxf(M, part_m[i]);
    }
    float L = 0.f, a[DP / 32];
#pragma unroll
    for (int e = 0; e < DP / 32; ++e) a[e] = 0.f;
    for (int sp = 0; sp < nsplit; ++sp) {
        const long long i = (bh * nsplit + sp) * R + row;
        const float ls = part_l[i];
        if (!(ls > 0.f)) continue;
        const float c = expf(part_m[i] - M);
        L += ls * c;
#pragma unroll
        for (int e = 0; e < DP / 32; ++e) {
            const int d = lane + 32 * e;
            if (d < D) a[e] += part_acc[i * D + d] * c;
        }
    }
    const long long o = bh * R + row;
#pragma unroll
    for (int e = 0; e < DP / 32; ++e) {
        const int d = lane + 32 * e;
        if (d < D) acc[o * D + d] = a[e];
    }
    if (lane == 0) {
        m_out[o] = M;
        l_out[o] = L;
    }
}

template <typename ST>
int launch(const void* q, const void* kc, const void* ks, const void* km,
           const void* vc, const void* vs, const void* vm, const void* vw,
           const void* pad, void* pacc, void* pm, void* pl, void* acc,
           void* m, void* l, int B, int H, int R, int T1, int D, int Tmax,
           int W, int gs, int kb, int vb, int nkq, int nvq, int t0tot, int sw,
           float sm_scale, cudaStream_t stream) {
    const int nsplit = (nkq + SPLIT - 1) / SPLIT;
    if (nsplit > 0) {
        const hq::Raw rl = hq::raw_layout<CK>(
            D / (32 / kb), D / (32 / vb), CK / gs > 1 ? CK / gs : 1, D,
            D / gs, (int)sizeof(ST));
        const int smem = tiles_bytes() + 2 * rl.bytes;
        auto kern = qhist_split_kernel<ST>;
        cudaError_t e = cudaFuncSetAttribute(
            kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
        if (e != cudaSuccess) return (int)e;
        dim3 grid((R + QROWS - 1) / QROWS, B * H, nsplit);
        kern<<<grid, NT, smem, stream>>>(
            (const __nv_bfloat16*)q, (const uint32_t*)kc, (const ST*)ks,
            (const ST*)km, (const uint32_t*)vc, (const ST*)vs, (const ST*)vm,
            (const __nv_bfloat16*)vw, (const int*)pad, (float*)pacc,
            (float*)pm, (float*)pl, H, R, T1, D, Tmax, W, gs, kb, vb, nkq, nvq,
            t0tot, sw, nsplit, sm_scale);
        e = cudaGetLastError();
        if (e != cudaSuccess) return (int)e;
    }
    dim3 grid((R + MERGE_ROWS - 1) / MERGE_ROWS, B * H);
    qhist_merge_kernel<<<grid, 32 * MERGE_ROWS, 0, stream>>>(
        (const float*)pacc, (const float*)pm, (const float*)pl, (float*)acc,
        (float*)m, (float*)l, R, D, nsplit);
    return (int)cudaGetLastError();
}

}  // namespace

extern "C" int kivi_flash_extend_qhist(
        const void* q, const void* k_codes, const void* k_scale,
        const void* k_mn, const void* v_codes, const void* v_scale,
        const void* v_mn, const void* v_win, const void* pad, void* part_acc,
        void* part_m, void* part_l, void* acc, void* m, void* l, int B, int H,
        int R, int T1, int D, int Tmax, int W, int gs, int k_bits, int v_bits,
        int n_k_quant, int n_v_quant, int seq_len, int sliding_window,
        int scale_is_f32, float sm_scale, void* stream) {
    if (D > DP || D % 16 || gs < 8 || (gs & (gs - 1)) || Tmax % gs)
        return (int)cudaErrorInvalidValue;
    cudaStream_t st = (cudaStream_t)stream;
#define KIVI_QHIST(ST_)                                                       \
    return launch<ST_>(q, k_codes, k_scale, k_mn, v_codes, v_scale, v_mn,    \
                       v_win, pad, part_acc, part_m, part_l, acc, m, l, B, H, \
                       R, T1, D, Tmax, W, gs, k_bits, v_bits, n_k_quant,      \
                       n_v_quant, seq_len, sliding_window, sm_scale, st)
    if (scale_is_f32) KIVI_QHIST(float);
    KIVI_QHIST(__nv_bfloat16);
#undef KIVI_QHIST
}

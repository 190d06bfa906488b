// Partial flash state of extend queries over the quantized history, split
// over T.
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
// Bound on the H100: operations at the slice's shapes.  At batch 1, 8 KV
// heads, R = 4*128 rows, D = 128 and 12K cached tokens the products are
// 4*R*12K*D per head, ~25 GFLOP, ~26 us at the bf16 tensor-core rate,
// against ~9 MB of live store (~3 us at 3.35 TB/s).  This first version,
// like the full extend kernel, runs them in f32 on the CUDA cores.
//
// Design: the full extend kernel (flash_extend.cu) gives one block to a
// (64-row query tile, batch * KV head) and walks the whole history in it;
// at batch 1 with 8 KV heads that is 64 blocks on 132 SMs.  Here a third
// grid axis splits the history into SPLIT positions, so a 12K history
// runs ~24x more blocks.  Each block walks its split in chunks of 64 with
// the `tile` helpers of common.cuh (shared with flash.cu and
// flash_extend.cu) and writes its (acc, m, l); a split wholly below every
// row's lower bound exits at once with l = 0.  A second kernel merges the
// splits of each row in order: m = max m_s over splits with l_s > 0,
// l = sum l_s exp(m_s - m), acc = sum acc_s exp(m_s - m).

#include <limits.h>

#include "common.cuh"

namespace {

using tile::CA;
using tile::CK;
using tile::DA;
using tile::NT;
using tile::QT;
using tile::RA;

constexpr int SPLIT = 512;     // history positions per block (multiple of CK)
constexpr int MERGE_ROWS = 4;  // rows per merge block, one warp each

template <typename ST>
__global__ void __launch_bounds__(NT)
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
    extern __shared__ float sm[];
    const tile::Smem sh = tile::carve(sm, D);
    float* const Qs = sh.Qs;
    float* const Ks = sh.Ks;
    float* const Vs = sh.Vs;
    __shared__ int range_lo;

    const int bh = blockIdx.y, b = bh / H, sp = blockIdx.z;
    const int row0 = blockIdx.x * QT;
    const int tid = threadIdx.x, ty = tid >> 4, tx = tid & 15;
    const int s0 = sp * SPLIT, s1 = min(s0 + SPLIT, nkq);
    const int KDw = D / (32 / k_bits), VDw = D / (32 / v_bits);
    const int Tg = Tmax / gs, Dg = D / gs;
    const int pad = pad_ptr ? pad_ptr[b] : 0;
    const long long prow = ((long long)bh * nsplit + sp) * R;

    if (tid == 0) range_lo = INT_MAX;
    __syncthreads();
    // Per-row lower bound of this thread's rows ty + 16*a.
    int rlo[RA];
    bool live[RA];
#pragma unroll
    for (int a = 0; a < RA; ++a) {
        const int row = row0 + ty + 16 * a;
        live[a] = row < R;
        int lo = max(pad, 0);
        if (sw > 0) lo = max(lo, t0tot + row % T1 - (sw - 1));
        rlo[a] = lo;
        if (live[a] && tx == 0) atomicMin(&range_lo, lo);
    }
    __syncthreads();
    const int c_begin = max(s0, (range_lo / CK) * CK);
    if (c_begin >= s1) {   // no row of the tile sees this split
#pragma unroll
        for (int a = 0; a < RA; ++a) {
            if (live[a] && tx == 0) {
                part_m[prow + row0 + ty + 16 * a] = KIVI_NEG_INF;
                part_l[prow + row0 + ty + 16 * a] = 0.f;
            }
        }
        return;
    }

    for (int i = tid; i < QT * D; i += NT) {
        const int lr = i / D, d = i % D;
        const int row = row0 + lr;
        Qs[d * (QT + 1) + lr] =
            row < R ? to_f(q[((long long)bh * R + row) * D + d]) : 0.f;
    }

    float m[RA], l[RA], acc[RA][DA];
    tile::init(m, l, acc);

    for (int c0 = c_begin; c0 < s1; c0 += CK) {
        __syncthreads();   // previous chunk's readers are done
        // ---- K chunk -> Ks[d][kj]; zeros past n_k_quant ----
        for (int i = tid; i < KDw * CK; i += NT) {
            const int w = i / CK, kj = i % CK, pos = c0 + kj;
            if (pos >= nkq) {
                for (int k = 0; k < 32 / k_bits; ++k)
                    Ks[slot_channel(w, k, KDw, k_bits) * (CK + 1) + kj] = 0.f;
                continue;
            }
            const uint32_t word =
                k_codes[((long long)bh * KDw + w) * Tmax + pos];
            const long long srow = ((long long)bh * Tg + pos / gs) * D;
            for (int k = 0; k < 32 / k_bits; ++k) {
                const int d = slot_channel(w, k, KDw, k_bits);
                Ks[d * (CK + 1) + kj] =
                    code_at(word, slot_shift(k, k_bits), k_bits)
                    * to_f(k_scale[srow + d]) + to_f(k_mn[srow + d]);
            }
        }
        // ---- V chunk -> Vs[kj][d]: store below n_v_quant, window above ----
        for (int i = tid; i < VDw * CK; i += NT) {
            const int w = i / CK, kj = i % CK, pos = c0 + kj;
            if (pos >= nvq) continue;
            const uint32_t word =
                v_codes[((long long)bh * VDw + w) * Tmax + pos];
            for (int k = 0; k < 32 / v_bits; ++k) {
                const int d = slot_channel(w, k, VDw, v_bits);
                const long long so = ((long long)bh * Dg + d / gs) * Tmax + pos;
                Vs[kj * (D + 1) + d] =
                    code_at(word, slot_shift(k, v_bits), v_bits)
                    * to_f(v_scale[so]) + to_f(v_mn[so]);
            }
        }
        for (int i = tid; i < CK * D; i += NT) {
            const int kj = i / D, d = i % D, pos = c0 + kj;
            if (pos < nvq) continue;
            Vs[kj * (D + 1) + d] =
                pos < nkq
                    ? to_f(v_win[((long long)bh * W + pos - nvq) * D + d])
                    : 0.f;
        }
        __syncthreads();

        float s[RA][CA];
        tile::qk(sh, D, ty, tx, s);
        bool ok[RA][CA];
#pragma unroll
        for (int a = 0; a < RA; ++a)
#pragma unroll
            for (int c = 0; c < CA; ++c) {
                const int pos = c0 + tx + 16 * c;
                ok[a][c] = live[a] && pos < s1 && pos >= rlo[a];
            }
        tile::softmax_step(sh, s, ok, sm_scale, m, l, acc, ty, tx);
        __syncthreads();
        tile::pv(sh, D, ty, tx, acc);
    }

#pragma unroll
    for (int a = 0; a < RA; ++a) {
        if (!live[a]) continue;
        const long long row = prow + row0 + ty + 16 * a;
#pragma unroll
        for (int e = 0; e < DA; ++e) {
            const int d = tx + 16 * e;
            if (d < D) part_acc[row * D + d] = acc[a][e];
        }
        if (tx == 0) {
            part_m[row] = m[a];
            part_l[row] = l[a];
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
    float L = 0.f, a[tile::DMAX / 32];
#pragma unroll
    for (int e = 0; e < tile::DMAX / 32; ++e) a[e] = 0.f;
    for (int sp = 0; sp < nsplit; ++sp) {
        const long long i = (bh * nsplit + sp) * R + row;
        const float ls = part_l[i];
        if (!(ls > 0.f)) continue;
        const float c = expf(part_m[i] - M);
        L += ls * c;
#pragma unroll
        for (int e = 0; e < tile::DMAX / 32; ++e) {
            const int d = lane + 32 * e;
            if (d < D) a[e] += part_acc[i * D + d] * c;
        }
    }
    const long long o = bh * R + row;
#pragma unroll
    for (int e = 0; e < tile::DMAX / 32; ++e) {
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
        const size_t smem = tile::smem_bytes(D);
        auto kern = qhist_split_kernel<ST>;
        if (smem > 48 * 1024) {
            cudaError_t e = cudaFuncSetAttribute(
                kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
            if (e != cudaSuccess) return (int)e;
        }
        dim3 grid((R + QT - 1) / QT, B * H, nsplit);
        kern<<<grid, NT, smem, stream>>>(
            (const __nv_bfloat16*)q, (const uint32_t*)kc, (const ST*)ks,
            (const ST*)km, (const uint32_t*)vc, (const ST*)vs, (const ST*)vm,
            (const __nv_bfloat16*)vw, (const int*)pad, (float*)pacc,
            (float*)pm, (float*)pl, H, R, T1, D, Tmax, W, gs, kb, vb, nkq, nvq,
            t0tot, sw, nsplit, sm_scale);
        cudaError_t e = cudaGetLastError();
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
    cudaStream_t st = (cudaStream_t)stream;
    if (scale_is_f32)
        return launch<float>(q, k_codes, k_scale, k_mn, v_codes, v_scale, v_mn,
                             v_win, pad, part_acc, part_m, part_l, acc, m, l,
                             B, H, R, T1, D, Tmax, W, gs, k_bits, v_bits,
                             n_k_quant, n_v_quant, seq_len, sliding_window,
                             sm_scale, st);
    return launch<__nv_bfloat16>(q, k_codes, k_scale, k_mn, v_codes, v_scale,
                                 v_mn, v_win, pad, part_acc, part_m, part_l,
                                 acc, m, l, B, H, R, T1, D, Tmax, W, gs,
                                 k_bits, v_bits, n_k_quant, n_v_quant,
                                 seq_len, sliding_window, sm_scale, st);
}

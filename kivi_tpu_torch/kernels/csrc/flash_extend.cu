// Extend (chunked-prefill) attention over the KIVI cache.
//
// Replaces the TPU kernel `flash_extend_attention` of
// kivi_tpu/kernels/flash_extend.py (body `_full_kernel`).  Contract:
// kivi_tpu_torch/kernels/flash_extend.py `flash_extend_attention_plain`
// (the `impl="jnp"` extend attention of kivi_tpu/core/attention.py).
//
// T1 suffix queries (R = r*T1 folded rows, row rr*T1 + i holds query
// position seq_len + i) attend, in one online softmax, the packed K/V
// history [0, n_k_quant), the fp K window [n_k_quant, seq_len) and their
// own causal self block (k_new/v_new).  V is routed by position:
// positions < n_v_quant read the V store, the rest of the history reads
// v_win row pos - n_v_quant.  A per-row lower bound (left pad, sliding
// window) masks the history; the causal diagonal is exempt inside the
// predicate, so a fully padded row never empties.
//
// Bound on the H100: at the main path's shapes (B=8, H=32, T1=128,
// D=128, up to 896 cached tokens) the bytes read (live codes, scales,
// windows and the bf16 queries and new K/V, ~40 MB) take ~12 us at
// 3.35 TB/s, and the 2*2*R*positions*D FLOPs per head (~16 GFLOP at 896
// cached tokens) take ~16 us at the bf16 tensor-core rate.  This first
// version runs its products in f32 on the CUDA cores (67 TFLOP/s peak),
// so it is bound by operations: the tensor cores (mma/wgmma) are the
// later step.
//
// Design: one block of 256 threads per (batch*head, tile of 64 query
// rows).  The block walks the key positions in chunks of 64: each chunk
// of K is dequantized (code*scale + min in f32) or copied from the
// window / new keys into shared memory, transposed; V likewise, natural
// layout.  Each thread owns a 4x4 patch of the 64x64 logit tile and a
// 4x8 patch of the 64x128 output (the `tile` helpers of common.cuh,
// shared with the prefill kernel flash.cu).  Chunks wholly below every
// row's lower bound or past the tile's last causal position are never
// visited.

#include "common.cuh"

namespace {

using tile::CA;
using tile::CK;
using tile::DA;
using tile::NT;
using tile::QT;
using tile::RA;

template <typename ST>
__global__ void __launch_bounds__(NT)
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
    extern __shared__ float sm[];
    const tile::Smem sh = tile::carve(sm, D);
    float* const Qs = sh.Qs;
    float* const Ks = sh.Ks;
    float* const Vs = sh.Vs;
    __shared__ int range_lo, range_hi;

    const int bh = blockIdx.y, b = bh / H;
    const int row0 = blockIdx.x * QT;
    const int tid = threadIdx.x, ty = tid >> 4, tx = tid & 15;
    const int T0 = nkq + nkw;
    const int KDw = D / (32 / k_bits), VDw = D / (32 / v_bits);
    const int Tg = Tmax / gs, Dg = D / gs;
    const int pad = pad_ptr ? pad_ptr[b] : 0;

    for (int i = tid; i < QT * D; i += NT) {
        const int lr = i / D, d = i % D;
        const int row = row0 + lr;
        Qs[d * (QT + 1) + lr] =
            row < R ? to_f(q[((long long)bh * R + row) * D + d]) : 0.f;
    }
    if (tid == 0) {
        range_lo = 0x7fffffff;
        range_hi = 0;
    }
    __syncthreads();

    // Per-row facts for this thread's rows ty + 16*a.
    int qi[RA], rlo[RA];
    bool live[RA];
#pragma unroll
    for (int a = 0; a < RA; ++a) {
        const int row = row0 + ty + 16 * a;
        live[a] = row < R;
        qi[a] = row % T1;
        int lo = max(pad, 0);
        if (sw > 0) lo = max(lo, T0 + qi[a] - (sw - 1));
        rlo[a] = lo;
        if (live[a] && tx == 0) {
            atomicMin(&range_lo, min(lo, T0 + qi[a]));
            atomicMax(&range_hi, T0 + qi[a] + 1);
        }
    }
    __syncthreads();
    const int p_begin = (range_lo / CK) * CK, p_end = range_hi;

    float m[RA], l[RA], acc[RA][DA];
    tile::init(m, l, acc);

    for (int c0 = p_begin; c0 < p_end; c0 += CK) {
        __syncthreads();   // previous chunk's readers are done
        // ---- K chunk -> Ks[d][kj] ----
        for (int i = tid; i < KDw * CK; i += NT) {
            const int w = i / CK, kj = i % CK, pos = c0 + kj;
            if (pos >= nkq) continue;
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
        for (int i = tid; i < CK * D; i += NT) {
            const int kj = i / D, d = i % D, pos = c0 + kj;
            if (pos < nkq) continue;
            float kv = 0.f;
            if (pos < T0)
                kv = to_f(k_win[((long long)bh * W + pos - nkq) * D + d]);
            else if (pos < T0 + T1)
                kv = to_f(k_new[((long long)bh * T1 + pos - T0) * D + d]);
            Ks[d * (CK + 1) + kj] = kv;
        }
        // ---- V chunk -> Vs[kj][d] ----
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
            float vv = 0.f;
            if (pos < T0)
                vv = to_f(v_win[((long long)bh * W + pos - nvq) * D + d]);
            else if (pos < T0 + T1)
                vv = to_f(v_new[((long long)bh * T1 + pos - T0) * D + d]);
            Vs[kj * (D + 1) + d] = vv;
        }
        __syncthreads();

        float s[RA][CA];
        tile::qk(sh, D, ty, tx, s);
        // history + causal self block above the row's lower bound; the
        // causal diagonal is exempt from the bound inside the predicate
        bool ok[RA][CA];
#pragma unroll
        for (int a = 0; a < RA; ++a)
#pragma unroll
            for (int c = 0; c < CA; ++c) {
                const int pos = c0 + tx + 16 * c;
                ok[a][c] = live[a] && pos < T0 + qi[a] + 1
                           && (pos >= rlo[a] || pos == T0 + qi[a]);
            }
        tile::softmax_step(sh, s, ok, sm_scale, m, l, acc, ty, tx);
        __syncthreads();
        tile::pv(sh, D, ty, tx, acc);
    }

#pragma unroll
    for (int a = 0; a < RA; ++a) {
        if (!live[a]) continue;
        const int row = row0 + ty + 16 * a;
        const float inv = 1.f / (l[a] > 0.f ? l[a] : 1.f);
#pragma unroll
        for (int e = 0; e < DA; ++e) {
            const int d = tx + 16 * e;
            if (d < D) out[((long long)bh * R + row) * D + d] = acc[a][e] * inv;
        }
    }
}

template <typename ST>
int launch(const void* q, const void* kc, const void* ks, const void* km,
           const void* vc, const void* vs, const void* vm, const void* kw,
           const void* vw, const void* kn, const void* vn, const void* pad,
           void* out, int B, int H, int R, int T1, int D, int Tmax, int W,
           int gs, int kb, int vb, int nkq, int nkw, int nvq, int sw,
           float sm_scale, cudaStream_t stream) {
    const size_t smem = tile::smem_bytes(D);
    auto kern = flash_extend_kernel<ST>;
    if (smem > 48 * 1024) {
        cudaError_t e = cudaFuncSetAttribute(
            kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
        if (e != cudaSuccess) return (int)e;
    }
    dim3 grid((R + QT - 1) / QT, B * H);
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
    cudaStream_t st = (cudaStream_t)stream;
    if (scale_is_f32)
        return launch<float>(q, k_codes, k_scale, k_mn, v_codes, v_scale,
                             v_mn, k_win, v_win, k_new, v_new, pad, out, B,
                             H, R, T1, D, Tmax, W, gs, k_bits, v_bits,
                             n_k_quant, n_k_win, n_v_quant, sliding_window,
                             sm_scale, st);
    return launch<__nv_bfloat16>(q, k_codes, k_scale, k_mn, v_codes,
                                 v_scale, v_mn, k_win, v_win, k_new, v_new,
                                 pad, out, B, H, R, T1, D, Tmax, W, gs,
                                 k_bits, v_bits, n_k_quant, n_k_win,
                                 n_v_quant, sliding_window, sm_scale, st);
}

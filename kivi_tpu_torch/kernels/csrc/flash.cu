// One-shot causal prefill attention (exact, full precision).
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
// Bound on the H100: bytes.  At the main path's shapes (B=8, H=32,
// T=1024, D=128) it reads q, k, v and writes out, 4 x 67.1 MB = 268 MB,
// 0.080 ms at 3.35 TB/s; its 4*B*H*D*T(T+1)/2 = 6.9e10 FLOPs take
// 0.070 ms at the bf16 tensor-core rate.  This first version runs its
// products in f32 on the CUDA cores (67 TFLOP/s peak, so >= 1 ms): the
// tensor cores (mma/wgmma) are the later step.
//
// Design: the causal self block of flash_extend.cu, through the same
// `tile` helpers of common.cuh.  One block of 256 threads per (b*Hq,
// tile of 64 query rows); the tiles of a head run in reverse order so
// the longest (last) tiles start first.  The block walks key chunks of
// 64 from max(pad_b, first row - window + 1) to its last row only; K
// and V of KV head h / r are read by index, never expanded per query
// head.  A T that is not a multiple of 64 masks the tail.  The f32
// accumulator is rounded to bf16 once, at the end.

#include "common.cuh"

namespace {

using tile::CA;
using tile::CK;
using tile::DA;
using tile::NT;
using tile::QT;
using tile::RA;

__global__ void __launch_bounds__(NT)
flash_prefill_kernel(const __nv_bfloat16* __restrict__ q,
                     const __nv_bfloat16* __restrict__ k,
                     const __nv_bfloat16* __restrict__ v,
                     const int* __restrict__ pad_ptr,
                     __nv_bfloat16* __restrict__ out, int Hq, int Hkv,
                     int T, int D, int sw, float sm_scale) {
    extern __shared__ float sm[];
    const tile::Smem sh = tile::carve(sm, D);

    const int bh = blockIdx.y, b = bh / Hq, h = bh % Hq;
    const long long kvh = (long long)b * Hkv + h / (Hq / Hkv);
    const int row0 = (gridDim.x - 1 - blockIdx.x) * QT;
    const int tid = threadIdx.x, ty = tid >> 4, tx = tid & 15;
    const int pad = pad_ptr ? max(pad_ptr[b], 0) : 0;
    const __nv_bfloat16* qb = q + (long long)bh * T * D;
    const __nv_bfloat16* kb = k + kvh * T * D;
    const __nv_bfloat16* vb = v + kvh * T * D;

    for (int i = tid; i < QT * D; i += NT) {
        const int lr = i / D, d = i % D, row = row0 + lr;
        sh.Qs[d * (QT + 1) + lr] =
            row < T ? to_f(qb[(long long)row * D + d]) : 0.f;
    }

    // live keys of the tile: [lo, hi)
    const int hi = min(row0 + QT, T);
    int lo = pad;
    if (sw > 0) lo = max(lo, row0 - sw + 1);

    float m[RA], l[RA], acc[RA][DA];
    tile::init(m, l, acc);

    for (int c0 = (lo / CK) * CK; c0 < hi; c0 += CK) {
        __syncthreads();   // Qs written / previous chunk's readers done
        for (int i = tid; i < CK * D; i += NT) {
            const int kj = i / D, d = i % D, pos = c0 + kj;
            const long long o = (long long)pos * D + d;
            sh.Ks[d * (CK + 1) + kj] = pos < T ? to_f(kb[o]) : 0.f;
            sh.Vs[kj * (D + 1) + d] = pos < T ? to_f(vb[o]) : 0.f;
        }
        __syncthreads();

        float s[RA][CA];
        tile::qk(sh, D, ty, tx, s);
        bool ok[RA][CA];
#pragma unroll
        for (int a = 0; a < RA; ++a) {
            const int row = row0 + ty + 16 * a;
#pragma unroll
            for (int c = 0; c < CA; ++c) {
                const int pos = c0 + tx + 16 * c;
                ok[a][c] = row < T && pos <= row && pos >= pad
                           && (sw <= 0 || pos > row - sw);
            }
        }
        tile::softmax_step(sh, s, ok, sm_scale, m, l, acc, ty, tx);
        __syncthreads();
        tile::pv(sh, D, ty, tx, acc);
    }

#pragma unroll
    for (int a = 0; a < RA; ++a) {
        const int row = row0 + ty + 16 * a;
        if (row >= T) continue;
        // a row with no admitted key has l == 0 and acc == 0: exact 0
        const float inv = l[a] > 0.f ? 1.f / l[a] : 0.f;
#pragma unroll
        for (int e = 0; e < DA; ++e) {
            const int d = tx + 16 * e;
            if (d < D)
                out[((long long)bh * T + row) * D + d] =
                    __float2bfloat16(acc[a][e] * inv);
        }
    }
}

}  // namespace

extern "C" int kivi_flash_prefill(const void* q, const void* k,
                                  const void* v, const void* pad, void* out,
                                  int B, int Hq, int Hkv, int T, int D,
                                  int sliding_window, float sm_scale,
                                  void* stream) {
    if (Hkv <= 0 || Hq % Hkv || D > tile::DMAX || T <= 0)
        return (int)cudaErrorInvalidValue;
    const size_t smem = tile::smem_bytes(D);
    if (smem > 48 * 1024) {
        cudaError_t e = cudaFuncSetAttribute(
            flash_prefill_kernel,
            cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
        if (e != cudaSuccess) return (int)e;
    }
    dim3 grid((T + QT - 1) / QT, B * Hq);
    flash_prefill_kernel<<<grid, NT, smem, (cudaStream_t)stream>>>(
        (const __nv_bfloat16*)q, (const __nv_bfloat16*)k,
        (const __nv_bfloat16*)v, (const int*)pad, (__nv_bfloat16*)out, Hq,
        Hkv, T, D, sliding_window, sm_scale);
    return (int)cudaGetLastError();
}

// Ablation probe of the KIVI decode body: kdec::attend of common.cuh, the
// body of fused_decode.cu and fused_decode_rows.cu, run at full fill (no
// fp windows, no lower bound) under one of its ablations (kdec::Ablation,
// documented there), each of which takes out one part of the work.
//
// Replaces the TPU kernel `trimmed` of scripts/profile_wide_32k.py (body
// `_kernel`), the chunk phase of kivi_tpu/kernels/fused_decode_wide.py
// under ablations.  It runs this port's row-4 body itself, not a copy of
// the Pallas grid: one block of NT = 128 threads per (batch row, KV head),
// chunks of NT positions, thread per position for QK, thread per channel
// for PV, one online softmax.  Variant 0 is the body the decode kernels
// run.  Contract: kivi_tpu_torch/kernels/trimmed.py `trimmed_plain`.
//
// Bound on the H100: bytes.  Every variant loads the live packed K and V
// codes and their bf16 scale/min rows once; at the profiler's geometry
// (B=4, 32 KV heads, 32K positions, 2-bit, group 32) about 400 MB, 0.12 ms
// at 3.35 TB/s.  With 4 * 32 = 128 blocks on 132 SMs, one block walks 255
// chunks in series, so the time is that walk's latency, not the card's
// bandwidth: the probe splits the walk into its parts.

#include "common.cuh"

namespace {

using kdec::NT;

// fused_decode.cu's kernel with the ablation added: the same parameters,
// all of them run-time values, so that variant 0 compiles to the wide
// decode kernel's code.  Told at compile time that the window is empty and
// nvq == nkq, nvcc built a body that ran 0.46 ms slower than the wide
// kernel at 32K on an H100, where this one runs 0.03 ms faster (one
// window chunk fewer).  The launch passes an empty window, no lower
// bound, nvq = nkq.
template <int R, int VAR>
__global__ void __launch_bounds__(NT)
trimmed_kernel(const __nv_bfloat16* __restrict__ q,
               const uint32_t* __restrict__ k_codes,
               const __nv_bfloat16* __restrict__ k_scale,
               const __nv_bfloat16* __restrict__ k_mn,
               const uint32_t* __restrict__ v_codes,
               const __nv_bfloat16* __restrict__ v_scale,
               const __nv_bfloat16* __restrict__ v_mn,
               const __nv_bfloat16* __restrict__ k_win,
               const __nv_bfloat16* __restrict__ v_win,
               const int* __restrict__ lo_ptr, float* __restrict__ out,
               int H, int D, int Tmax, int W, int gs, int k_bits, int v_bits,
               int nkq, int nkw, int nvq, float sm_scale) {
    extern __shared__ float sm[];
    const long long bh = blockIdx.x;
    const int b = (int)(bh / H);
    const int KDw = D / (32 / k_bits), VDw = D / (32 / v_bits);
    const int Dg = D / gs;
    kdec::attend<R, __nv_bfloat16, kdec::Ablation<VAR>>(
        sm, q + bh * R * D, k_codes + bh * KDw * Tmax,
        k_scale + bh * (Tmax / gs) * D, k_mn + bh * (Tmax / gs) * D,
        v_codes + bh * VDw * Tmax, v_scale + bh * Dg * Tmax,
        v_mn + bh * Dg * Tmax, k_win + bh * W * D, v_win + bh * W * D,
        out + bh * R * D, D, Tmax, gs, k_bits, v_bits, nkq, nkw, nvq,
        lo_ptr ? lo_ptr[b] : 0, sm_scale);
}

template <int R, int VAR>
int launch(const void* q, const void* k_codes, const void* k_scale,
           const void* k_mn, const void* v_codes, const void* v_scale,
           const void* v_mn, void* out, int B, int H, int D, int Tmax,
           int gs, int k_bits, int v_bits, int nq, float sm_scale,
           cudaStream_t stream) {
    const size_t smem =
        kdec::smem_bytes(R, D, gs, v_bits, kdec::Ablation<VAR>::zp);
    auto kern = trimmed_kernel<R, VAR>;
    if (smem > 48 * 1024) {
        cudaError_t e = cudaFuncSetAttribute(
            kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
        if (e != cudaSuccess) return (int)e;
    }
    kern<<<B * H, NT, smem, stream>>>(
        (const __nv_bfloat16*)q, (const uint32_t*)k_codes,
        (const __nv_bfloat16*)k_scale, (const __nv_bfloat16*)k_mn,
        (const uint32_t*)v_codes, (const __nv_bfloat16*)v_scale,
        (const __nv_bfloat16*)v_mn, nullptr, nullptr, nullptr, (float*)out,
        H, D, Tmax, 0, gs, k_bits, v_bits, nq, 0, nq, sm_scale);
    return (int)cudaGetLastError();
}

template <int R>
int dispatch_var(int var, const void* q, const void* kc, const void* ks,
                 const void* km, const void* vc, const void* vs,
                 const void* vm, void* out, int B, int H, int D, int Tmax,
                 int gs, int kb, int vb, int nq, float sm_scale,
                 cudaStream_t st) {
#define KIVI_V(VV)                                                         \
    case VV:                                                               \
        return launch<R, VV>(q, kc, ks, km, vc, vs, vm, out, B, H, D, Tmax, \
                             gs, kb, vb, nq, sm_scale, st);
    switch (var) {
        KIVI_V(0) KIVI_V(1) KIVI_V(2) KIVI_V(3)
        KIVI_V(4) KIVI_V(5) KIVI_V(6) KIVI_V(7)
        default: return (int)cudaErrorInvalidValue;
    }
#undef KIVI_V
}

}  // namespace

extern "C" int kivi_trimmed(const void* q, const void* k_codes,
                            const void* k_scale, const void* k_mn,
                            const void* v_codes, const void* v_scale,
                            const void* v_mn, void* out, int B, int H, int r,
                            int D, int Tmax, int gs, int k_bits, int v_bits,
                            int n_quant, int variant, float sm_scale,
                            void* stream) {
    cudaStream_t st = (cudaStream_t)stream;
#define KIVI_R(RR)                                                          \
    case RR:                                                                \
        return dispatch_var<RR>(variant, q, k_codes, k_scale, k_mn, v_codes, \
                                v_scale, v_mn, out, B, H, D, Tmax, gs,      \
                                k_bits, v_bits, n_quant, sm_scale, st);
    switch (r) {
        KIVI_R(1) KIVI_R(2) KIVI_R(4) KIVI_R(8)
        default: return (int)cudaErrorInvalidValue;
    }
#undef KIVI_R
}

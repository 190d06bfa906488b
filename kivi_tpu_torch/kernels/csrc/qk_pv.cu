// Split dequant matmuls over the packed KIVI stores: the two halves of
// split (flash-decoding) decode attention.
//
// Replaces the TPU kernels `qk_dequant_matmul` (body `_qk_kernel`) and
// `pv_dequant_matmul` (body `_pv_kernel`) of kivi_tpu/kernels/qk_pv.py.
// Contracts: kivi_tpu_torch/kernels/qk_pv.py `qk_dequant_matmul_plain`
// and `pv_dequant_matmul_plain`.
//
//   QK: att (B,H,r,T) = q (B,H,r,D) x dequant(K codes (B,H,KDw,T), scale
//       and min rows (B,H,T/gs,D)), -1e30 at positions >= n_quant.
//   PV: out (B,H,r,D) = p (B,H,r,T) x dequant(V codes (B,H,VDw,T), scale
//       and min columns (B,H,D/gs,T)) over positions < n_quant.
//
// Bound on the H100: bytes.  At the long-context slice's shapes (batch 1,
// 8 KV heads, r = 4, D = 128, 12K of a 16K KIVI-2 cache) QK reads ~1.6 MB
// of K codes and 3.1 MB of bf16 K scale/min rows and writes 2.1 MB of f32
// logits (the whole T, dead tiles included): ~2 us at 3.35 TB/s.  PV reads
// the 2.1 MB of f32 p beside the same V bytes.  The FLOPs (2*r*D per
// position) are far below the card's rate.  At these sizes a launch
// (a few us) is of the same order as the bound.
//
// Design (the TPU's sequential grid becomes parallel blocks over T):
//   * QK: one block of NT = 128 threads per (tile of 128 positions, batch
//     * KV head); thread i owns position t0 + i.  The tile's K scale/min
//     rows are staged in shared memory, codes are read word by word
//     (coalesced across threads) and dequantized to code*scale + min in
//     f32, as the other KIVI kernels do.  Tiles at or past n_quant write
//     -1e30 without reading the store.
//   * PV: one block per (split of PV_SPLIT positions, batch * KV head),
//     live splits only; thread d owns channel d.  Each chunk of 128
//     positions stages p, the V codes and the V scale/min columns in
//     shared memory (rows padded by one word against bank conflicts).
//     Every block writes its (r, D) partial sum; a second kernel adds the
//     splits in order.  No atomics, so a run is bit-reproducible.

#include "common.cuh"

namespace {

constexpr int NT = 128;        // threads; positions per QK tile / PV chunk
constexpr int PV_SPLIT = 256;  // positions per PV block (multiple of NT)
constexpr int SN = NT + 1;     // padded row of the PV staging buffers

template <int R, typename ST>
__global__ void __launch_bounds__(NT)
qk_kernel(const __nv_bfloat16* __restrict__ q,
          const uint32_t* __restrict__ k_codes,
          const ST* __restrict__ k_scale, const ST* __restrict__ k_mn,
          float* __restrict__ out, int D, int T, int gs, int bits, int nq) {
    extern __shared__ float sm[];
    const long long bh = blockIdx.y;
    const int t0 = blockIdx.x * NT;
    const int tid = threadIdx.x;
    const int pos = t0 + tid;
    float* o = out + bh * R * T;
    if (t0 >= nq) {                 // dead tile: the store is never read
        if (pos < T) {
#pragma unroll
            for (int rr = 0; rr < R; ++rr) o[(long long)rr * T + pos] = KIVI_NEG_INF;
        }
        return;
    }
    const int KDw = D / (32 / bits);
    const int cg = NT / gs, SD = D + 1;
    float* q_s = sm;                // (R, D)
    float* ks_s = q_s + R * D;      // (cg, D+1)
    float* km_s = ks_s + cg * SD;   // (cg, D+1)

    const __nv_bfloat16* qb = q + bh * R * D;
    for (int i = tid; i < R * D; i += NT) q_s[i] = to_f(qb[i]);
    const int g0 = t0 / gs;
    const int ng = min(cg, (nq - t0 + gs - 1) / gs);   // live groups
    const long long srow = (bh * (T / gs) + g0) * D;
    for (int i = tid; i < ng * D; i += NT) {
        const int g = i / D, d = i % D;
        ks_s[g * SD + d] = to_f(k_scale[srow + i]);
        km_s[g * SD + d] = to_f(k_mn[srow + i]);
    }
    __syncthreads();
    if (pos >= T) return;

    float s[R];
#pragma unroll
    for (int rr = 0; rr < R; ++rr) s[rr] = KIVI_NEG_INF;
    if (pos < nq) {
#pragma unroll
        for (int rr = 0; rr < R; ++rr) s[rr] = 0.f;
        const float* ks = ks_s + (tid / gs) * SD;
        const float* km = km_s + (tid / gs) * SD;
        const uint32_t* kc = k_codes + bh * KDw * T + pos;
        for (int w = 0; w < KDw; ++w) {
            const uint32_t word = kc[(long long)w * T];
            for (int k = 0; k < 32 / bits; ++k) {
                const int d = slot_channel(w, k, KDw, bits);
                const float kv =
                    code_at(word, slot_shift(k, bits), bits) * ks[d] + km[d];
#pragma unroll
                for (int rr = 0; rr < R; ++rr) s[rr] += q_s[rr * D + d] * kv;
            }
        }
    }
#pragma unroll
    for (int rr = 0; rr < R; ++rr) o[(long long)rr * T + pos] = s[rr];
}

template <int R, typename ST>
__global__ void __launch_bounds__(NT)
pv_split_kernel(const float* __restrict__ p,
                const uint32_t* __restrict__ v_codes,
                const ST* __restrict__ v_scale, const ST* __restrict__ v_mn,
                float* __restrict__ part, int D, int T, int gs, int bits,
                int nq, int nsplit) {
    extern __shared__ float sm[];
    const long long bh = blockIdx.y;
    const int sp = blockIdx.x;
    const int s0 = sp * PV_SPLIT, s1 = min(s0 + PV_SPLIT, nq);
    const int VDw = D / (32 / bits), Dg = D / gs;
    float* p_s = sm;                          // (R, NT)
    float* vs_s = p_s + R * NT;               // (Dg, NT+1)
    float* vm_s = vs_s + Dg * SN;             // (Dg, NT+1)
    uint32_t* vc_s = (uint32_t*)(vm_s + Dg * SN);   // (VDw, NT+1)

    const int tid = threadIdx.x;
    const int d = tid < D ? tid : 0;          // this thread's channel
    int v_w, v_shift;
    channel_slot(d, VDw, bits, &v_w, &v_shift);
    const int v_g = d / gs;
    const float* pb = p + bh * R * T;
    const uint32_t* vcb = v_codes + bh * VDw * T;
    const ST* vsb = v_scale + bh * Dg * T;
    const ST* vmb = v_mn + bh * Dg * T;

    float acc[R];
#pragma unroll
    for (int rr = 0; rr < R; ++rr) acc[rr] = 0.f;
    for (int c0 = s0; c0 < s1; c0 += NT) {
        __syncthreads();   // previous chunk's readers are done
        const int pos = c0 + tid;
        const bool in = pos < s1;
#pragma unroll
        for (int rr = 0; rr < R; ++rr)
            p_s[rr * NT + tid] = in ? pb[(long long)rr * T + pos] : 0.f;
        for (int w = 0; w < VDw; ++w)
            vc_s[w * SN + tid] = in ? vcb[(long long)w * T + pos] : 0u;
        for (int g = 0; g < Dg; ++g) {
            vs_s[g * SN + tid] = in ? to_f(vsb[(long long)g * T + pos]) : 0.f;
            vm_s[g * SN + tid] = in ? to_f(vmb[(long long)g * T + pos]) : 0.f;
        }
        __syncthreads();
        if (tid < D) {
            const int n = min(NT, s1 - c0);
            for (int i = 0; i < n; ++i) {
                const float v = code_at(vc_s[v_w * SN + i], v_shift, bits)
                                * vs_s[v_g * SN + i] + vm_s[v_g * SN + i];
#pragma unroll
                for (int rr = 0; rr < R; ++rr) acc[rr] += p_s[rr * NT + i] * v;
            }
        }
    }
    if (tid < D) {
        float* o = part + ((bh * nsplit + sp) * R) * D;
#pragma unroll
        for (int rr = 0; rr < R; ++rr) o[rr * D + tid] = acc[rr];
    }
}

// out[bh][i] = sum over splits, in order, of part[bh][split][i] (i < R*D);
// zeros when no split is live.
__global__ void pv_reduce_kernel(const float* __restrict__ part,
                                 float* __restrict__ out, int RD,
                                 int nsplit) {
    const long long bh = blockIdx.y;
    const int i = blockIdx.x * blockDim.x + threadIdx.x;
    if (i >= RD) return;
    float s = 0.f;
    const float* pp = part + bh * nsplit * RD + i;
    for (int sp = 0; sp < nsplit; ++sp) s += pp[(long long)sp * RD];
    out[bh * RD + i] = s;
}

template <typename K>
int allow_smem(K kern, size_t smem) {
    if (smem <= 48 * 1024) return 0;
    return (int)cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
}

template <int R, typename ST>
int launch_qk(const void* q, const void* kc, const void* ks, const void* km,
              void* out, int B, int H, int D, int T, int gs, int bits, int nq,
              cudaStream_t st) {
    const size_t smem = sizeof(float) * (size_t)(R * D + 2 * (NT / gs) * (D + 1));
    auto kern = qk_kernel<R, ST>;
    if (int e = allow_smem(kern, smem)) return e;
    dim3 grid((T + NT - 1) / NT, B * H);
    kern<<<grid, NT, smem, st>>>((const __nv_bfloat16*)q, (const uint32_t*)kc,
                                 (const ST*)ks, (const ST*)km, (float*)out, D,
                                 T, gs, bits, nq);
    return (int)cudaGetLastError();
}

template <int R, typename ST>
int launch_pv(const void* p, const void* vc, const void* vs, const void* vm,
              void* part, void* out, int B, int H, int D, int T, int gs,
              int bits, int nq, cudaStream_t st) {
    const int nsplit = (nq + PV_SPLIT - 1) / PV_SPLIT;
    if (nsplit > 0) {
        const int VDw = D / (32 / bits), Dg = D / gs;
        const size_t smem = sizeof(float) * (size_t)(R * NT + (2 * Dg + VDw) * SN);
        auto kern = pv_split_kernel<R, ST>;
        if (int e = allow_smem(kern, smem)) return e;
        dim3 grid(nsplit, B * H);
        kern<<<grid, NT, smem, st>>>((const float*)p, (const uint32_t*)vc,
                                     (const ST*)vs, (const ST*)vm,
                                     (float*)part, D, T, gs, bits, nq, nsplit);
        if (cudaError_t e = cudaGetLastError()) return (int)e;
    }
    const int RD = R * D;
    dim3 grid((RD + NT - 1) / NT, B * H);
    pv_reduce_kernel<<<grid, NT, 0, st>>>((const float*)part, (float*)out, RD,
                                          nsplit);
    return (int)cudaGetLastError();
}

}  // namespace

#define KIVI_R_SWITCH(r, CALL)                                              \
    switch (r) {                                                            \
        case 1: { constexpr int RR = 1; return CALL; }                      \
        case 2: { constexpr int RR = 2; return CALL; }                      \
        case 4: { constexpr int RR = 4; return CALL; }                      \
        case 8: { constexpr int RR = 8; return CALL; }                      \
        default: return (int)cudaErrorInvalidValue;                         \
    }

extern "C" int kivi_qk_dequant(const void* q, const void* k_codes,
                               const void* k_scale, const void* k_mn,
                               void* out, int B, int H, int r, int D, int T,
                               int gs, int bits, int n_quant,
                               int scale_is_f32, void* stream) {
    cudaStream_t st = (cudaStream_t)stream;
    if (scale_is_f32) {
        KIVI_R_SWITCH(r, (launch_qk<RR, float>(q, k_codes, k_scale, k_mn, out,
                                               B, H, D, T, gs, bits, n_quant,
                                               st)))
    }
    KIVI_R_SWITCH(r, (launch_qk<RR, __nv_bfloat16>(q, k_codes, k_scale, k_mn,
                                                   out, B, H, D, T, gs, bits,
                                                   n_quant, st)))
}

extern "C" int kivi_pv_dequant(const void* p, const void* v_codes,
                               const void* v_scale, const void* v_mn,
                               void* part, void* out, int B, int H, int r,
                               int D, int T, int gs, int bits, int n_quant,
                               int scale_is_f32, void* stream) {
    cudaStream_t st = (cudaStream_t)stream;
    if (scale_is_f32) {
        KIVI_R_SWITCH(r, (launch_pv<RR, float>(p, v_codes, v_scale, v_mn,
                                               part, out, B, H, D, T, gs,
                                               bits, n_quant, st)))
    }
    KIVI_R_SWITCH(r, (launch_pv<RR, __nv_bfloat16>(p, v_codes, v_scale, v_mn,
                                                   part, out, B, H, D, T, gs,
                                                   bits, n_quant, st)))
}

// KIVI quantize + pack, keys (per channel) and values (per token).
//
// Replaces the TPU kernels `quantize_pack_k` and `quantize_pack_v` of
// kivi_tpu/kernels/quant_pack.py (bodies `_quant_k_kernel`,
// `_quant_v_kernel`).  Contract: kivi_tpu_torch/core/quant.py
// `quantize_k_block` / `quantize_v_block`, bit for bit.
//
// Bound on the H100: bytes.  The kernel reads the bf16 block once and
// writes the packed codes and the f32 scale/min once; at 3.35 TB/s a
// (8, 32, 128, 128) bf16 block (8 MiB in, 1 MiB of 2-bit codes and
// 2 MiB of stats out) takes about 3.4 us.
//
// Design: one thread block per (batch*head, tile of gs tokens).  The
// tile is read once, coalesced along D, into shared memory as f32 (rows
// padded by one float so column walks are free of bank conflicts); one
// pass computes the group statistics (keys: one group per channel over
// the tile's gs tokens; values: one group per (token, gs channels)); a
// second pass forms each packed word from shared memory and writes it
// coalesced along the token axis of the (Dw, T) store.  The code is
// rintf((x - mn) / safe) with IEEE division (the library is built
// without --use_fast_math), so it equals torch.round of the plain form.
//
// The input is the natural (B, H, T, D) layout with any batch, head and
// token strides and a contiguous D axis, so window slices need no copy.

#include "common.cuh"

__global__ void quantize_pack_kernel(const __nv_bfloat16* __restrict__ x,
                                     long long sb, long long sh,
                                     long long st, int H, int T, int D,
                                     int gs, int bits, int is_key,
                                     uint32_t* __restrict__ codes,
                                     float* __restrict__ scale_out,
                                     float* __restrict__ mn_out) {
    extern __shared__ float smem[];
    const int ld = D + 1;                 // padded tile row
    float* xs = smem;                     // (gs, ld)
    float* s_mn = xs + gs * ld;           // (D,) group minimum
    float* s_safe = s_mn + D;             // (D,) guarded scale

    const int bh = blockIdx.y;
    const int b = bh / H, h = bh % H;
    const int g = blockIdx.x;             // token tile == key group
    const int t0 = g * gs;
    const float max_int = (float)((1 << bits) - 1);
    const __nv_bfloat16* xb = x + b * sb + h * sh;

    for (int i = threadIdx.x; i < gs * D; i += blockDim.x) {
        const int t = i / D, d = i % D;
        xs[t * ld + d] = to_f(xb[(long long)(t0 + t) * st + d]);
    }
    __syncthreads();

    // Statistics.  Keys: entry e = channel d.  Values: entry e =
    // gg*gs + t for channel group gg of token t (D entries either way).
    const int Dg = D / gs;
    for (int e = threadIdx.x; e < D; e += blockDim.x) {
        float mn = CUDART_INF_F, mx = -CUDART_INF_F;
        if (is_key) {
            for (int t = 0; t < gs; ++t) {
                const float v = xs[t * ld + e];
                mn = fminf(mn, v);
                mx = fmaxf(mx, v);
            }
        } else {
            const int gg = e / gs, t = e % gs;
            for (int i = 0; i < gs; ++i) {
                const float v = xs[t * ld + gg * gs + i];
                mn = fminf(mn, v);
                mx = fmaxf(mx, v);
            }
        }
        const float scale = (mx - mn) / max_int;
        s_mn[e] = mn;
        s_safe[e] = scale > 0.f ? scale : 1.f;
        if (is_key) {
            // (B, H, T//gs, D): one row per token group
            const long long o = ((long long)bh * (T / gs) + g) * D + e;
            scale_out[o] = scale;
            mn_out[o] = mn;
        } else {
            // (B, H, D//gs, T)
            const int gg = e / gs, t = e % gs;
            const long long o = ((long long)bh * Dg + gg) * T + t0 + t;
            scale_out[o] = scale;
            mn_out[o] = mn;
        }
    }
    __syncthreads();

    // Pack: word (w, t), t fastest so the (Dw, T) store is written
    // coalesced.
    const int slots = 32 / bits;
    const int Dw = D / slots;
    for (int i = threadIdx.x; i < Dw * gs; i += blockDim.x) {
        const int w = i / gs, t = i % gs;
        uint32_t word = 0;
        for (int k = 0; k < slots; ++k) {
            const int d = slot_channel(w, k, Dw, bits);
            const int e = is_key ? d : (d / gs) * gs + t;
            float c = rintf((xs[t * ld + d] - s_mn[e]) / s_safe[e]);
            c = fminf(fmaxf(c, 0.f), max_int);
            word |= ((uint32_t)c) << slot_shift(k, bits);
        }
        codes[((long long)bh * Dw + w) * T + t0 + t] = word;
    }
}

extern "C" int kivi_quantize_pack(const void* x, long long sb, long long sh,
                                  long long st, int B, int H, int T, int D,
                                  int gs, int bits, int is_key, void* codes,
                                  void* scale, void* mn, void* stream) {
    const size_t smem = (size_t)(gs * (D + 1) + 2 * D) * sizeof(float);
    if (smem > 48 * 1024) {
        cudaError_t e = cudaFuncSetAttribute(
            quantize_pack_kernel,
            cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
        if (e != cudaSuccess) return (int)e;
    }
    dim3 grid(T / gs, B * H);
    quantize_pack_kernel<<<grid, 128, smem, (cudaStream_t)stream>>>(
        (const __nv_bfloat16*)x, sb, sh, st, H, T, D, gs, bits, is_key,
        (uint32_t*)codes, (float*)scale, (float*)mn);
    return (int)cudaGetLastError();
}

// Single-token decode attention over the full-precision (fp16-cache
// baseline) KV cache.
//
// Replaces the TPU kernel `fp_decode_attention_kernel` of
// kivi_tpu/kernels/fp_decode.py (body `_kernel`).  Contract:
// kivi_tpu_torch/kernels/fp_decode.py `fp_decode_attention_plain`.
//
// The r query rows of KV head h attend positions p with p < length,
// p >= pad_b (left pad of batch row b) and, with a sliding window,
// p >= length - window: one per-row lower bound, as in the KIVI decode
// kernel.  K is stored transposed, (D, Tmax); V is (Tmax, D).
//
// Bound on the H100: bytes.  It reads the live K and V once: at the main
// path's shapes (B=8, H=32, D=128) and fill 1081 that is
// 2*8*32*1081*128*2 B = 141.7 MB, 0.042 ms at 3.35 TB/s; at fill 4096,
// 537 MB, 0.160 ms.  Its 4*r*D FLOPs per position are far below the
// card's rate.
//
// Design: one block of 128 threads per (batch, KV head), holding all r
// query rows in shared memory, so K and V are read once per KV head (256
// blocks for 132 SMs at the main path's shapes).  The block walks the
// live positions [lo, length) in chunks of 128 with one online softmax
// in f32 (finite -1e30 and an l > 0 guard):
//   * logits: thread i owns position c0+i and reads its K column down
//     the D rows; neighbouring threads read neighbouring positions
//     (coalesced in the (D, Tmax) layout);
//   * PV: thread d owns channel d and walks the chunk's V rows;
//     neighbouring threads read neighbouring channels (coalesced in the
//     (Tmax, D) layout).
// `length` arrives as a host int (the engine: uniform over the batch) or
// per row from a (B,) int32 device tensor (the continuous batcher's slot
// caches, each at its own fill; the sliding window is then relative to
// the row's own length and a row of length 0 writes zeros).  Either way
// chunks past the row's length or below its lower bound are never
// visited and no t_bound is needed.  Splitting T across blocks
// (flash-decoding) is a later step.

#include "common.cuh"

namespace {

constexpr int NT = 128;      // threads per block == positions per chunk
constexpr int NW = NT / 32;

template <int R, bool ROWS>
__global__ void __launch_bounds__(NT)
fp_decode_kernel(const __nv_bfloat16* __restrict__ q,
                 const __nv_bfloat16* __restrict__ k,
                 const __nv_bfloat16* __restrict__ v,
                 const int* __restrict__ pad_ptr,
                 const int* __restrict__ len_ptr, float* __restrict__ out,
                 int H, int D, int Tmax, int length, int window,
                 float sm_scale) {
    extern __shared__ float sm[];
    float* q_s = sm;                 // (R, D)
    float* p_s = q_s + R * D;        // (R, NT)
    float* red = p_s + R * NT;       // (R, NW)

    const int bh = blockIdx.x, b = bh / H;
    const int tid = threadIdx.x;
    // a compile-time switch: the host-int instantiation keeps `length` a
    // kernel parameter (reading it from memory on that path too made the
    // kernel several times slower on the H100)
    if (ROWS) length = min(max(len_ptr[b], 0), Tmax);
    int lo = pad_ptr ? max(pad_ptr[b], 0) : 0;
    if (window > 0) lo = max(lo, length - window);
    const __nv_bfloat16* kb = k + (long long)bh * D * Tmax;
    const __nv_bfloat16* vb = v + (long long)bh * Tmax * D;

    for (int i = tid; i < R * D; i += NT)
        q_s[i] = to_f(q[(long long)bh * R * D + i]);

    float m[R], l[R], acc[R];
#pragma unroll
    for (int rr = 0; rr < R; ++rr) {
        m[rr] = KIVI_NEG_INF;
        l[rr] = 0.f;
        acc[rr] = 0.f;
    }

    for (int c0 = (lo / NT) * NT; c0 < length; c0 += NT) {
        __syncthreads();   // q_s written / previous chunk's readers done
        // ---- logits: thread tid owns position c0 + tid ----
        const int pos = c0 + tid;
        const bool valid = pos < length && pos >= lo;
        float s[R];
#pragma unroll
        for (int rr = 0; rr < R; ++rr) s[rr] = 0.f;
        if (valid) {
#pragma unroll 8
            for (int d = 0; d < D; ++d) {
                const float kv = to_f(kb[(long long)d * Tmax + pos]);
#pragma unroll
                for (int rr = 0; rr < R; ++rr) s[rr] += q_s[rr * D + d] * kv;
            }
        }
        float cmax[R];
#pragma unroll
        for (int rr = 0; rr < R; ++rr) {
            s[rr] *= sm_scale;
            cmax[rr] = valid ? s[rr] : KIVI_NEG_INF;
        }
        block_reduce<R, NT>(cmax, red, true);
        float alpha[R], psum[R];
#pragma unroll
        for (int rr = 0; rr < R; ++rr) {
            const float m_new = fmaxf(m[rr], cmax[rr]);
            alpha[rr] = expf(m[rr] - m_new);
            const float p = valid ? expf(s[rr] - m_new) : 0.f;
            p_s[rr * NT + tid] = p;
            psum[rr] = p;
            m[rr] = m_new;
        }
        block_reduce<R, NT>(psum, red, false);   // also orders the p_s writes
#pragma unroll
        for (int rr = 0; rr < R; ++rr) {
            l[rr] = l[rr] * alpha[rr] + psum[rr];
            acc[rr] *= alpha[rr];
        }

        // ---- PV: thread tid owns channel tid ----
        // The loop's form is chosen per instantiation by measurement on
        // the H100: with a host-int length, the loop over the chunk's live
        // rows; with per-row lengths that loop ran slower than a fixed NT
        // trip over the whole chunk (p is 0 past the length, so the extra
        // rows add exact zeros as long as the store holds finite values
        // there; the row index is clamped into the store).
        if (tid < D) {
            if constexpr (ROWS) {
                for (int i = 0; i < NT; ++i) {
                    const float vv = to_f(
                        vb[(long long)min(c0 + i, Tmax - 1) * D + tid]);
#pragma unroll
                    for (int rr = 0; rr < R; ++rr)
                        acc[rr] += p_s[rr * NT + i] * vv;
                }
            } else {
                const int n = min(NT, length - c0);
                for (int i = 0; i < n; ++i) {
                    const float vv = to_f(vb[(long long)(c0 + i) * D + tid]);
#pragma unroll
                    for (int rr = 0; rr < R; ++rr)
                        acc[rr] += p_s[rr * NT + i] * vv;
                }
            }
        }
    }
    if (tid < D) {
#pragma unroll
        for (int rr = 0; rr < R; ++rr)
            out[((long long)bh * R + rr) * D + tid] =
                l[rr] > 0.f ? acc[rr] / l[rr] : 0.f;
    }
}

template <int R>
int launch(const void* q, const void* k, const void* v, const void* pad,
           const void* lens, void* out, int B, int H, int D, int Tmax,
           int length, int window, float sm_scale, cudaStream_t stream) {
    const size_t smem = sizeof(float) * (size_t)(R * D + R * NT + R * NW);
    auto kern = lens ? fp_decode_kernel<R, true> : fp_decode_kernel<R, false>;
    kern<<<B * H, NT, smem, stream>>>(
        (const __nv_bfloat16*)q, (const __nv_bfloat16*)k,
        (const __nv_bfloat16*)v, (const int*)pad, (const int*)lens,
        (float*)out, H, D, Tmax, length, window, sm_scale);
    return (int)cudaGetLastError();
}

}  // namespace

// lens: NULL for the host-int `length` (1 <= length <= Tmax), else a (B,)
// int32 device tensor of per-row lengths (`length` is then ignored).
extern "C" int kivi_fp_decode(const void* q, const void* k, const void* v,
                              const void* pad, const void* lens, void* out,
                              int B, int H, int r, int D, int Tmax,
                              int length, int sliding_window, float sm_scale,
                              void* stream) {
    if (D > NT || (!lens && (length < 1 || length > Tmax)))
        return (int)cudaErrorInvalidValue;
    cudaStream_t st = (cudaStream_t)stream;
#define KIVI_R(RR)                                                        \
    case RR:                                                              \
        return launch<RR>(q, k, v, pad, lens, out, B, H, D, Tmax, length, \
                          sliding_window, sm_scale, st);
    switch (r) {
        KIVI_R(1) KIVI_R(2) KIVI_R(4) KIVI_R(8)
        default: return (int)cudaErrorInvalidValue;
    }
#undef KIVI_R
}

// Single-token decode attention over the full-precision (fp16-cache
// baseline) KV cache, split over T (flash-decoding).
//
// Replaces the TPU kernel `fp_decode_attention_kernel` of
// kivi_tpu/kernels/fp_decode.py (body `_kernel`).  Contract:
// kivi_tpu_torch/kernels/fp_decode.py `fp_decode_attention_plain`.
//
// The r query rows of KV head h attend positions p with p < length,
// p >= pad_b (left pad of batch row b) and, with a sliding window,
// p >= length - window: one lower bound per batch row.  K is stored
// transposed, (D, Tmax); V is (Tmax, D).  f32 arithmetic on the CUDA
// cores from the bf16 cache, as the plain version computes.
//
// Bound on the H100: bytes.  It reads the live K and V once: at the main
// path's shapes (B=8, H=32, D=128) and fill 1081 that is
// 2*8*32*1081*128*2 B = 141.7 MB, 0.042 ms at 3.35 TB/s; its 4*r*D FLOPs
// per position are far below the card's rate.  One block per (batch, KV
// head) walking the history serially kept too few bytes in flight to
// approach that rate (3.8x the bound, 11x for per-row lengths, where the
// longest row set the time).
//
// Design: blocks over (splits of S = 256 positions, batch * KV head), 128
// threads each.  A split streams its live K rows (S positions of each
// of D d-rows) and then its V rows through a ring of NS 16 KB pieces in
// shared memory by cp.async, NS - 1 pieces in flight while one is
// consumed; only positions in [lower bound, length) are read.
//   * QK: a lane owns 8 consecutive positions (one 16-byte vector of a
//     d-row) and a slice of the d-rows, and accumulates r x 8 logits;
//     the slices are summed in order through shared memory.
//   * One exact softmax per split: one block max and one block sum per
//     query row.
//   * PV: a lane owns 8 channels (one 16-byte vector of a V row) and
//     every 8th position of each piece, accumulating r x 8 outputs in
//     registers; the position phases are summed once per split.
// A split wholly outside a row's [lower bound, length) writes the
// neutral partial (m = -1e30, l = 0; its acc is never read) without
// reading the cache.  The last block of each (batch, KV head) to finish
// (a ticket per head, counted by atomicAdd and reset by that block)
// merges the splits in split order: m = max m_s over splits with
// l_s > 0, l = sum l_s exp(m_s - m), out = sum acc_s exp(m_s - m) / l,
// so two runs are bit-equal and a row that sees nothing is exactly 0.
// One launch per call; a call with one split writes its output at once.
// The host never reads a counter: `length` is a host int (the engine:
// splits from the window's lower bound up to length) or per row from a
// (B,) device tensor (the continuous batcher's slot caches and the
// engine's replayed decode step: splits over [0, t_bound), t_bound = Tmax
// or a static bound on every row's length, the dead splits exiting at
// once; positions at or past t_bound are not read; the sliding window
// then counts back from the row's own length and a row of length 0
// writes zeros).

#include "attn_wgmma.cuh"   // cp.async helpers

namespace {

// Positions per split.  256 and 512 ran within 5% of each other on the
// H100 (fill 1081: 0.0613 vs 0.0647 ms; per-row: 0.0812 vs 0.0784 ms);
// 256 gives short histories more blocks and needs less shared memory.
constexpr int S = 256;
constexpr int NT = 128;      // threads of a block
constexpr int NW = NT / 32;
constexpr int DMAX = 128;    // channels of a V piece row (D <= 128)
constexpr int PIECE = 16384; // bytes of one staged piece
constexpr int NS = 4;        // pieces in the ring
constexpr int VP = PIECE / (DMAX * 2);   // positions of a V piece

__device__ __forceinline__ void unpack8(uint4 x, float (&f)[8]) {
    const uint32_t w[4] = {x.x, x.y, x.z, x.w};
#pragma unroll
    for (int j = 0; j < 4; ++j) {
        f[2 * j] = __uint_as_float(w[j] << 16);
        f[2 * j + 1] = __uint_as_float(w[j] & 0xffff0000u);
    }
}

template <int R>
constexpr int red_floats() {   // QK slices (NDS, R, S) or PV warps
    return (NT / (S / 8)) * R * S > NW * R * DMAX ? (NT / (S / 8)) * R * S
                                                  : NW * R * DMAX;
}

template <int R>
constexpr int smem_bytes() {
    return NS * PIECE + 4 * (R * DMAX + R * S + red_floats<R>());
}

template <int R, bool ROWS>
__global__ void __launch_bounds__(NT)
fp_decode_split_kernel(const __nv_bfloat16* __restrict__ q,
                       const __nv_bfloat16* __restrict__ k,
                       const __nv_bfloat16* __restrict__ v,
                       const int* __restrict__ pad_ptr,
                       const int* __restrict__ len_ptr,
                       float* __restrict__ out, float* __restrict__ part_acc,
                       float* __restrict__ part_ml, int* __restrict__ tickets,
                       int H, int D, int Tmax, int length, int window,
                       int first, int nsplit, float sm_scale) {
    constexpr int NPG = S / 8;            // 8-position groups of a split
    constexpr int NDS = NT / NPG;         // d-slices of the QK phase
    constexpr int KR = PIECE / (2 * S);   // d-rows of a K piece
    constexpr int NVP = S / VP;           // V pieces of a split
    static_assert(NDS >= 1 && KR % NDS == 0 && S % VP == 0, "split size");
    extern __shared__ __align__(16) uint8_t smem[];
    float* const q_s = (float*)(smem + NS * PIECE);   // (R, DMAX)
    float* const p_s = q_s + R * DMAX;                 // (R, S): logits, p
    float* const red = p_s + R * S;
    __shared__ float bred[R * NW], ml_s[2 * R];
    __shared__ int last;

    const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
    const int bh = blockIdx.y, b = bh / H;
    // a compile-time switch: the host-int instantiation keeps `length` a
    // kernel parameter
    if (ROWS) length = min(max(len_ptr[b], 0), Tmax);
    int lo = pad_ptr ? max(pad_ptr[b], 0) : 0;
    if (window > 0) lo = max(lo, length - window);
    const int s0 = (first + blockIdx.x) * S;
    const int a = max(s0, lo), e = min(s0 + S, length);   // live: [a, e)
    const long long slot = (long long)bh * nsplit + blockIdx.x;
    float* const o_b = out + (long long)bh * R * D;

    if (a >= e) {   // the neutral partial, no reads
        if (nsplit == 1) {
            for (int i = tid; i < R * D; i += NT) o_b[i] = 0.f;
            return;
        }
        if (tid < R) {
            part_ml[2 * (slot * R + tid)] = KIVI_NEG_INF;
            part_ml[2 * (slot * R + tid) + 1] = 0.f;
        }
    } else {
        const __nv_bfloat16* const kb = k + (long long)bh * D * Tmax;
        const __nv_bfloat16* const vb = v + (long long)bh * Tmax * D;
        const int nK = (D + KR - 1) / KR, np = nK + NVP;
        const int g_lo = (a - s0) >> 3, g_hi = (e - s0 + 7) >> 3;
        const uint32_t ring = wg::smem_addr(smem);

        // piece i into ring stage i % NS: K d-rows [i*KR, +KR) x the
        // split's 8-position groups, then V rows of VP positions
        auto issue = [&](int i) {
            if (i >= np) return;
            const uint32_t st = ring + (i % NS) * PIECE;
            if (i < nK) {
                for (int idx = tid; idx < KR * NPG; idx += NT) {
                    const int g = idx % NPG, d = i * KR + idx / NPG;
                    const bool ok = d < D && g >= g_lo && g < g_hi;
                    wg::cp16(st + idx * 16,
                             ok ? (const void*)(kb + (long long)d * Tmax
                                                + s0 + 8 * g)
                                : (const void*)kb, ok);
                }
            } else {
                const int p0 = s0 + (i - nK) * VP;
                for (int idx = tid; idx < VP * (DMAX / 8); idx += NT) {
                    const int cg = idx % (DMAX / 8);
                    const int pos = p0 + idx / (DMAX / 8);
                    const bool ok = cg * 8 < D && pos >= a && pos < e;
                    wg::cp16(st + idx * 16,
                             ok ? (const void*)(vb + (long long)pos * D
                                                + cg * 8)
                                : (const void*)vb, ok);
                }
            }
        };
#pragma unroll
        for (int i = 0; i < NS - 1; ++i) {
            issue(i);
            wg::cp_commit();
        }
        for (int i = tid; i < R * D; i += NT)
            q_s[(i / D) * DMAX + i % D] =
                to_f(q[(long long)bh * R * D + i]);

        const int pg = tid % NPG, ds = tid / NPG;   // QK: positions, d-slice
        const int cg = tid % (DMAX / 8), pp = tid / (DMAX / 8);   // PV
        float acc[R][8];
#pragma unroll
        for (int rr = 0; rr < R; ++rr)
#pragma unroll
            for (int x = 0; x < 8; ++x) acc[rr][x] = 0.f;

        for (int i = 0; i < np; ++i) {
            wg::cp_wait<NS - 2>();
            __syncthreads();   // piece i landed; piece i - 1's readers done
            issue(i + NS - 1);
            wg::cp_commit();
            const uint8_t* const st = smem + (i % NS) * PIECE;
            if (i < nK) {
#pragma unroll
                for (int j = 0; j < KR / NDS; ++j) {
                    const int dr = ds + NDS * j, d = i * KR + dr;
                    if (d >= D) break;
                    float kv[8];
                    unpack8(*(const uint4*)(st + (dr * NPG + pg) * 16), kv);
#pragma unroll
                    for (int rr = 0; rr < R; ++rr) {
                        const float qd = q_s[rr * DMAX + d];
#pragma unroll
                        for (int x = 0; x < 8; ++x)
                            acc[rr][x] = fmaf(qd, kv[x], acc[rr][x]);
                    }
                }
                if (i < nK - 1) continue;
                // ---- the split's logits: the d-slices summed in order ----
#pragma unroll
                for (int rr = 0; rr < R; ++rr) {
                    float* const dst = red + (ds * R + rr) * S + 8 * pg;
                    *(float4*)dst = make_float4(acc[rr][0], acc[rr][1],
                                                acc[rr][2], acc[rr][3]);
                    *(float4*)(dst + 4) = make_float4(acc[rr][4], acc[rr][5],
                                                      acc[rr][6], acc[rr][7]);
#pragma unroll
                    for (int x = 0; x < 8; ++x) acc[rr][x] = 0.f;
                }
                __syncthreads();
                float mx[R], sum[R];
#pragma unroll
                for (int rr = 0; rr < R; ++rr) {
                    mx[rr] = KIVI_NEG_INF;
                    for (int c = tid; c < S; c += NT) {
                        float x = red[rr * S + c];
                        for (int sl = 1; sl < NDS; ++sl)
                            x += red[(sl * R + rr) * S + c];
                        x *= sm_scale;
                        p_s[rr * S + c] = x;
                        if (s0 + c >= a && s0 + c < e)
                            mx[rr] = fmaxf(mx[rr], x);
                    }
                }
                block_reduce<R, NT>(mx, bred, true);
#pragma unroll
                for (int rr = 0; rr < R; ++rr) {
                    sum[rr] = 0.f;
                    for (int c = tid; c < S; c += NT) {
                        const bool ok = s0 + c >= a && s0 + c < e;
                        const float p = ok ? expf(p_s[rr * S + c] - mx[rr])
                                           : 0.f;
                        p_s[rr * S + c] = p;
                        sum[rr] += p;
                    }
                }
                block_reduce<R, NT>(sum, bred, false);   // orders p_s too
                if (tid == 0) {
#pragma unroll
                    for (int rr = 0; rr < R; ++rr) {
                        ml_s[rr] = mx[rr];
                        ml_s[R + rr] = sum[rr];
                    }
                }
            } else {
                const int c = (i - nK) * VP;   // the piece's first position
#pragma unroll
                for (int j = 0; j < VP / 8; ++j) {
                    const int pr = pp + 8 * j;
                    float vv[8];
                    unpack8(*(const uint4*)(st + (pr * (DMAX / 8) + cg) * 16),
                            vv);
#pragma unroll
                    for (int rr = 0; rr < R; ++rr) {
                        const float p = p_s[rr * S + c + pr];
#pragma unroll
                        for (int x = 0; x < 8; ++x)
                            acc[rr][x] = fmaf(p, vv[x], acc[rr][x]);
                    }
                }
            }
        }
        // ---- PV: the position phases summed, lanes l and l ^ 16, then the
        // warps in order ----
#pragma unroll
        for (int rr = 0; rr < R; ++rr)
#pragma unroll
            for (int x = 0; x < 8; ++x)
                acc[rr][x] += __shfl_xor_sync(0xffffffffu, acc[rr][x], 16);
        if (lane < 16) {
#pragma unroll
            for (int rr = 0; rr < R; ++rr) {
                float* const dst = red + (warp * R + rr) * DMAX + 8 * cg;
                *(float4*)dst = make_float4(acc[rr][0], acc[rr][1],
                                            acc[rr][2], acc[rr][3]);
                *(float4*)(dst + 4) = make_float4(acc[rr][4], acc[rr][5],
                                                  acc[rr][6], acc[rr][7]);
            }
        }
        __syncthreads();
        for (int i = tid; i < R * D; i += NT) {
            const int rr = i / D, d = i % D;
            float x = red[rr * DMAX + d];
            for (int w = 1; w < NW; ++w) x += red[(w * R + rr) * DMAX + d];
            if (nsplit == 1)
                o_b[i] = x / ml_s[R + rr];
            else
                part_acc[slot * R * D + i] = x;
        }
        if (nsplit == 1) return;
        if (tid < R) {
            part_ml[2 * (slot * R + tid)] = ml_s[tid];
            part_ml[2 * (slot * R + tid) + 1] = ml_s[R + tid];
        }
    }

    // ---- the last block of the head merges the splits in order ----
    __threadfence();
    __syncthreads();
    if (tid == 0) last = atomicAdd(&tickets[bh], 1) == nsplit - 1;
    __syncthreads();
    if (!last) return;
    __threadfence();
    const float* const pa = part_acc + (long long)bh * nsplit * R * D;
    const float2* const pml =
        (const float2*)part_ml + (long long)bh * nsplit * R;
    for (int rr = warp; rr < R; rr += NW) {
        float M = KIVI_NEG_INF;
        for (int sp = 0; sp < nsplit; ++sp) {
            const float2 ml = __ldcg(pml + sp * R + rr);
            if (ml.y > 0.f) M = fmaxf(M, ml.x);
        }
        float L = 0.f, A[DMAX / 32];
#pragma unroll
        for (int x = 0; x < DMAX / 32; ++x) A[x] = 0.f;
        for (int sp = 0; sp < nsplit; ++sp) {
            const float2 ml = __ldcg(pml + sp * R + rr);
            if (!(ml.y > 0.f)) continue;
            const float c = expf(ml.x - M);
            L += ml.y * c;
#pragma unroll
            for (int x = 0; x < DMAX / 32; ++x) {
                const int d = lane + 32 * x;
                if (d < D) A[x] += __ldcg(pa + (sp * R + rr) * D + d) * c;
            }
        }
#pragma unroll
        for (int x = 0; x < DMAX / 32; ++x) {
            const int d = lane + 32 * x;
            if (d < D) o_b[rr * D + d] = L > 0.f ? A[x] / L : 0.f;
        }
    }
    if (tid == 0) tickets[bh] = 0;
}

template <int R>
int launch(const void* q, const void* k, const void* v, const void* pad,
           const void* lens, void* out, void* part_acc, void* part_ml,
           void* tickets, int B, int H, int D, int Tmax, int length,
           int t_bound, int window, float sm_scale, cudaStream_t stream) {
    int first = 0, nsplit = (t_bound + S - 1) / S;
    if (!lens) {   // splits from the window's lower bound up to length
        first = (window > 0 ? max(0, length - window) : 0) / S;
        nsplit = (length + S - 1) / S - first;
    }
    constexpr int smem = smem_bytes<R>();
    auto kern = lens ? fp_decode_split_kernel<R, true>
                     : fp_decode_split_kernel<R, false>;
    cudaError_t e = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return (int)e;
    kern<<<dim3(nsplit, B * H), NT, smem, stream>>>(
        (const __nv_bfloat16*)q, (const __nv_bfloat16*)k,
        (const __nv_bfloat16*)v, (const int*)pad, (const int*)lens,
        (float*)out, (float*)part_acc, (float*)part_ml, (int*)tickets, H, D,
        Tmax, length, window, first, nsplit, sm_scale);
    return (int)cudaGetLastError();
}

}  // namespace

// lens: NULL for the host-int `length` (1 <= length <= Tmax), else a (B,)
// int32 device tensor of per-row lengths (`length` is then ignored), read
// over positions [0, t_bound), 1 <= t_bound <= Tmax (ignored with a
// host-int length).
// part_acc (B*H*ceil(Tmax/256)*r*D floats), part_ml (twice
// B*H*ceil(Tmax/256)*r floats) and tickets (B*H ints, zero before the
// first call; every call leaves them zero) are the caller's workspace.
extern "C" int kivi_fp_decode(const void* q, const void* k, const void* v,
                              const void* pad, const void* lens, void* out,
                              void* part_acc, void* part_ml, void* tickets,
                              int B, int H, int r, int D, int Tmax,
                              int length, int t_bound, int sliding_window,
                              float sm_scale, void* stream) {
    if (D > DMAX || D % 8 || Tmax % 8
        || (!lens && (length < 1 || length > Tmax))
        || (lens && (t_bound < 1 || t_bound > Tmax)))
        return (int)cudaErrorInvalidValue;
    cudaStream_t st = (cudaStream_t)stream;
#define KIVI_R(RR)                                                        \
    case RR:                                                              \
        return launch<RR>(q, k, v, pad, lens, out, part_acc, part_ml,     \
                          tickets, B, H, D, Tmax, length, t_bound,        \
                          sliding_window, sm_scale, st);
    switch (r) {
        KIVI_R(1) KIVI_R(2) KIVI_R(4) KIVI_R(8)
        default: return (int)cudaErrorInvalidValue;
    }
#undef KIVI_R
}

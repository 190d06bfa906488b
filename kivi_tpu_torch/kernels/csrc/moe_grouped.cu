// The grouped expert GEMM of the sparse-expert layer
// (kivi_tpu_torch/kernels/moe_grouped.py): the held experts' SwiGLU
// MLPs over the (token, expert) pairs routed to them, in two launches.
//
// Replaces no TPU kernel: the JAX package has no expert layer.  It was
// added with the K-EXAONE block, whose sparse layers hold most of a
// decode step's bytes (16 held experts of 3 x 6144 x 2048 bf16 a layer),
// and whose routing is known on the device only: no expert's token count
// may reach the host inside a replayed decode step.
//
// Contract (the plain versions in moe_grouped.py): the pairs are sorted
// by held expert on the device; off (E + 1,) int32 gives each expert's
// pairs [off[e], off[e + 1]), tok the token of each sorted pair, w its
// routing weight (f32).
//   gate_up: h[p] = silu(x[tok[p]] @ Wg[e]) * (x[tok[p]] @ Wu[e]), bf16,
//            Wg, Wu (E, K, N) row-major, K = hidden, N = expert width;
//   down:    out[tok[p]] += w[p] * (h[p] @ Wd[e]) in f32 (atomics; a
//            token's at most experts_per_tok terms add in any order),
//            Wd (E, K, N), K = expert width, N = hidden.
//
// Bound on the H100: at decode (256 tokens, 16 experts, ~16 tokens an
// expert) bytes, every held expert's weights read once: 1.21 GB a layer,
// 0.36 ms at 3.35 TB/s; at a 32K-token prefill (~2,000 tokens an expert)
// operations, 2.4 TFLOP a layer, 2.4 ms at 989 TFLOP/s.
//
// Design: tiles of BM pairs x 64 columns, one block each, on the tensor
// cores through mma.sync (m16n8k16, bf16 in, f32 accumulate), operands
// staged by a 4-deep cp.async ring over 32-deep K slices in padded
// shared memory (ldmatrix without bank conflicts).  The grid is static:
// (N / 64) column tiles by a bound on the row tiles (pairs / BM plus one
// partial tile an expert); a block finds its expert and rows by walking
// off in device memory and exits at once past the last tile, so the host
// never reads a count and the launch is the same on every replay.  The
// A rows of gate_up are gathered by token inside the load (x is never
// copied per pair); its epilogue applies SiLU * up in f32 and rounds
// once to bf16; down scales by the routing weight and adds into the
// token's f32 row.  BM = 32 (128 threads) serves decode, BM = 128 (256
// threads) prefill.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int BN = 64;       // columns of a tile
constexpr int BK = 32;       // K depth of a staged slice
constexpr int STAGES = 4;    // slices in flight
constexpr int APAD = 8;      // bf16 pad of a staged A row
constexpr int BPAD = 8;      // bf16 pad of a staged B row
constexpr int AS = BK + APAD;
constexpr int BS = BN + BPAD;

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
    return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void cp16(uint32_t dst, const void* src,
                                     bool pred) {
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                     dst),
                 "l"(src), "r"(pred ? 16 : 0)
                 : "memory");
}

__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], uint32_t addr) {
    asm volatile(
        "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
        : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
        : "r"(addr));
}

__device__ __forceinline__ void ldsm_x4_t(uint32_t (&r)[4], uint32_t addr) {
    asm volatile(
        "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, "
        "[%4];\n"
        : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
        : "r"(addr));
}

__device__ __forceinline__ void mma16816(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
    asm volatile(
        "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
        "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// GATE: the gate_up launch (two B matrices, SiLU * up into h); else the
// down launch (one B matrix, weighted atomic add into out).
template <int BM, bool GATE>
struct Tile {
    static constexpr int WARPS_M = BM == 32 ? 2 : 4;
    static constexpr int WARPS_N = 2;
    static constexpr int NT = 32 * WARPS_M * WARPS_N;
    static constexpr int WM = BM / WARPS_M;   // rows of a warp
    static constexpr int WN = BN / WARPS_N;   // columns of a warp (32)
    static constexpr int MI = WM / 16;
    static constexpr int NI = WN / 8;
    static constexpr int NB = GATE ? 2 : 1;
    static constexpr int A_ELEMS = BM * AS;
    static constexpr int B_ELEMS = BK * BS;
    static constexpr int STAGE = A_ELEMS + NB * B_ELEMS;
    static constexpr int SMEM = STAGES * STAGE * 2;
    static constexpr int A_CHUNKS = BM * (BK / 8) / NT;   // per thread
    static constexpr int B_CHUNKS = BK * (BN / 8) / NT;   // per matrix
    static_assert(BM * (BK / 8) % NT == 0, "A chunks");
    static_assert(BK * (BN / 8) % NT == 0, "B chunks");
};

template <int BM, bool GATE>
__global__ void __launch_bounds__(Tile<BM, GATE>::NT)
    moe_grouped_gemm(const __nv_bfloat16* __restrict__ a,
                     const int* __restrict__ tok, const float* __restrict__ w,
                     const int* __restrict__ off,
                     const __nv_bfloat16* __restrict__ b0,
                     const __nv_bfloat16* __restrict__ b1,
                     __nv_bfloat16* __restrict__ h, float* __restrict__ out,
                     int E, int K, int N) {
    using T = Tile<BM, GATE>;
    // ---- which expert and pairs this block's row tile holds ----
    int t = blockIdx.y, e = 0, start = 0, end = 0;
    for (; e < E; ++e) {
        const int s = off[e], f = off[e + 1];
        const int nt = (f - s + BM - 1) / BM;
        if (t < nt) {
            start = s + t * BM;
            end = f;
            break;
        }
        t -= nt;
    }
    if (e == E) return;
    const int n0 = blockIdx.x * BN;

    extern __shared__ __align__(16) __nv_bfloat16 smem[];
    const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
    const int wm = warp / T::WARPS_N, wn = warp % T::WARPS_N;

    // this thread's A chunks: fixed rows, their source rows found once
    const __nv_bfloat16* arow[T::A_CHUNKS];
    bool alive[T::A_CHUNKS];
    int adst[T::A_CHUNKS];
#pragma unroll
    for (int i = 0; i < T::A_CHUNKS; ++i) {
        const int id = tid + i * T::NT, r = id / (BK / 8), c = id % (BK / 8);
        const int p = start + r;
        alive[i] = p < end;
        const int src = alive[i] ? (GATE ? tok[p] : p) : 0;
        arow[i] = a + (size_t)src * K + c * 8;
        adst[i] = r * AS + c * 8;
    }
    const size_t wbase = (size_t)e * K * N + n0;
    const __nv_bfloat16* bm[2] = {b0 + wbase, GATE ? b1 + wbase : b0};

    auto load = [&](int stage, int kt) {
        __nv_bfloat16* st = smem + stage * T::STAGE;
        const int k0 = kt * BK;
#pragma unroll
        for (int i = 0; i < T::A_CHUNKS; ++i)
            cp16(smem_u32(st + adst[i]), arow[i] + k0, alive[i]);
#pragma unroll
        for (int m = 0; m < T::NB; ++m) {
            __nv_bfloat16* bs = st + T::A_ELEMS + m * T::B_ELEMS;
#pragma unroll
            for (int i = 0; i < T::B_CHUNKS; ++i) {
                const int id = tid + i * T::NT, r = id / (BN / 8),
                          c = id % (BN / 8);
                cp16(smem_u32(bs + r * BS + c * 8),
                     bm[m] + (size_t)(k0 + r) * N + c * 8, true);
            }
        }
    };

    float acc[T::NB][T::MI][T::NI][4];
#pragma unroll
    for (int m = 0; m < T::NB; ++m)
#pragma unroll
        for (int i = 0; i < T::MI; ++i)
#pragma unroll
            for (int j = 0; j < T::NI; ++j)
#pragma unroll
                for (int q = 0; q < 4; ++q) acc[m][i][j][q] = 0.f;

    const int KT = K / BK;
#pragma unroll
    for (int s = 0; s < STAGES - 1; ++s) {
        if (s < KT) load(s, s);
        asm volatile("cp.async.commit_group;\n" ::: "memory");
    }
    for (int kt = 0; kt < KT; ++kt) {
        asm volatile("cp.async.wait_group %0;\n" ::"n"(STAGES - 2)
                     : "memory");
        __syncthreads();
        const int nxt = kt + STAGES - 1;
        if (nxt < KT) load(nxt % STAGES, nxt);
        asm volatile("cp.async.commit_group;\n" ::: "memory");

        const __nv_bfloat16* st = smem + (kt % STAGES) * T::STAGE;
#pragma unroll
        for (int kk = 0; kk < BK / 16; ++kk) {
            uint32_t af[T::MI][4];
#pragma unroll
            for (int i = 0; i < T::MI; ++i) {
                const int row = wm * T::WM + i * 16 + (lane & 15);
                const int col = kk * 16 + (lane >> 4) * 8;
                ldsm_x4(af[i], smem_u32(st + row * AS + col));
            }
#pragma unroll
            for (int m = 0; m < T::NB; ++m) {
                const __nv_bfloat16* bs = st + T::A_ELEMS + m * T::B_ELEMS;
#pragma unroll
                for (int j = 0; j < T::NI / 2; ++j) {
                    uint32_t bf[4];
                    const int row = kk * 16 + (lane & 15);
                    const int col = wn * T::WN + j * 16 + (lane >> 4) * 8;
                    ldsm_x4_t(bf, smem_u32(bs + row * BS + col));
#pragma unroll
                    for (int i = 0; i < T::MI; ++i) {
                        mma16816(acc[m][i][2 * j], af[i], bf[0], bf[1]);
                        mma16816(acc[m][i][2 * j + 1], af[i], bf[2], bf[3]);
                    }
                }
            }
        }
    }
    asm volatile("cp.async.wait_group 0;\n" ::: "memory");

    // ---- epilogue: fragment (i, j) element q sits at row
    // wm*WM + i*16 + lane/4 (+8 for q >= 2), column
    // wn*WN + j*8 + (lane%4)*2 (+1 for odd q) ----
#pragma unroll
    for (int i = 0; i < T::MI; ++i) {
#pragma unroll
        for (int hh = 0; hh < 2; ++hh) {
            const int p = start + wm * T::WM + i * 16 + (lane >> 2) + hh * 8;
            if (p >= end) continue;
            float wt = 0.f;
            int dst = 0;
            if (!GATE) {
                wt = w[p];
                dst = tok[p];
            }
#pragma unroll
            for (int j = 0; j < T::NI; ++j) {
                const int col = n0 + wn * T::WN + j * 8 + (lane & 3) * 2;
                const float* c0 = &acc[0][i][j][2 * hh];
                if (GATE) {
                    const float* c1 = &acc[T::NB - 1][i][j][2 * hh];
                    float r2[2];
#pragma unroll
                    for (int q = 0; q < 2; ++q)
                        r2[q] = c0[q] / (1.f + __expf(-c0[q])) * c1[q];
                    *reinterpret_cast<__nv_bfloat162*>(
                        h + (size_t)p * N + col) =
                        __floats2bfloat162_rn(r2[0], r2[1]);
                } else {
                    float* o = out + (size_t)dst * N + col;
                    atomicAdd(o, wt * c0[0]);
                    atomicAdd(o + 1, wt * c0[1]);
                }
            }
        }
    }
}

template <int BM, bool GATE>
int launch(const void* a, const void* tok, const void* w, const void* off,
           const void* b0, const void* b1, void* h, void* out, int E, int K,
           int N, int m_tiles, cudaStream_t st) {
    using T = Tile<BM, GATE>;
    static bool attr = false;
    if (!attr) {
        cudaError_t err = cudaFuncSetAttribute(
            moe_grouped_gemm<BM, GATE>,
            cudaFuncAttributeMaxDynamicSharedMemorySize, T::SMEM);
        if (err != cudaSuccess) return (int)err;
        attr = true;
    }
    dim3 grid(N / BN, m_tiles);
    moe_grouped_gemm<BM, GATE><<<grid, T::NT, T::SMEM, st>>>(
        (const __nv_bfloat16*)a, (const int*)tok, (const float*)w,
        (const int*)off, (const __nv_bfloat16*)b0, (const __nv_bfloat16*)b1,
        (__nv_bfloat16*)h, (float*)out, E, K, N);
    return (int)cudaGetLastError();
}

int checked(int K, int N, int m_tiles, int bm) {
    return (K % BK || N % BN || m_tiles < 1 || m_tiles > 65535
            || (bm != 32 && bm != 128));
}

}  // namespace

// x (tokens, K) bf16; tok (pairs,) int32; off (E + 1,) int32; wg, wu
// (E, K, N) bf16; h (pairs bound, N) bf16.  m_tiles: the static bound
// on the row tiles of BM pairs.
extern "C" int kivi_moe_grouped_gate_up(const void* x, const void* tok,
                                        const void* off, const void* wg,
                                        const void* wu, void* h, int E,
                                        int K, int N, int m_tiles, int bm,
                                        void* stream) {
    if (checked(K, N, m_tiles, bm)) return (int)cudaErrorInvalidValue;
    cudaStream_t st = (cudaStream_t)stream;
    return bm == 32 ? launch<32, true>(x, tok, nullptr, off, wg, wu, h,
                                       nullptr, E, K, N, m_tiles, st)
                    : launch<128, true>(x, tok, nullptr, off, wg, wu, h,
                                        nullptr, E, K, N, m_tiles, st);
}

// h (pairs bound, K) bf16 in sorted order; tok, w (pairs,) int32 / f32;
// off (E + 1,); wd (E, K, N) bf16; out (tokens, N) f32, added into.
extern "C" int kivi_moe_grouped_down(const void* h, const void* tok,
                                     const void* w, const void* off,
                                     const void* wd, void* out, int E,
                                     int K, int N, int m_tiles, int bm,
                                     void* stream) {
    if (checked(K, N, m_tiles, bm)) return (int)cudaErrorInvalidValue;
    cudaStream_t st = (cudaStream_t)stream;
    return bm == 32 ? launch<32, false>(h, tok, w, off, wd, nullptr, nullptr,
                                        out, E, K, N, m_tiles, st)
                    : launch<128, false>(h, tok, w, off, wd, nullptr,
                                         nullptr, out, E, K, N, m_tiles, st);
}

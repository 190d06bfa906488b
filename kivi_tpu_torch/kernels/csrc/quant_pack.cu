// KIVI quantize + pack, keys (per channel) and values (per token),
// written to fresh outputs or straight into a cache's stores.
//
// Replaces the TPU kernels `quantize_pack_k` and `quantize_pack_v` of
// kivi_tpu/kernels/quant_pack.py (bodies `_quant_k_kernel`,
// `_quant_v_kernel`).  Contract: kivi_tpu_torch/core/quant.py
// `quantize_k_block` / `quantize_v_block`, bit for bit; the in-place
// entry then writes as the JAX cache's dynamic_update_slice does, at
// each selected row's offset along T, clamped into the store.
//
// Bound on the H100: bytes.  The kernel reads the bf16 block once and
// writes the packed codes and the stats once; at 3.35 TB/s a
// (8, 32, 128, 128) bf16 block (8 MiB in, 1 MiB of 2-bit codes and
// 1 MiB of f32 stats out) takes about 3.1 us.  There is no product, so
// no tensor core, and in a one-pass stream nothing waits for the loads
// but the same thread's statistics: plain 16-byte loads, all issued
// before the first use, keep as many bytes in flight as TMA would,
// without its descriptors or barriers.
//
// Main path (D = 128, gs = 32, both compile-time; bits a template
// argument): a block of 4 warps codes one 32-token key group of one
// (batch, head) row at a time, 8 KB, and loops over the row's groups;
// the grid holds about 8 blocks an SM (64 registers a thread), so at
// (8, 32, 128, 128) every group is in flight in one wave and at
// (8, 32, 1024, 128) a block takes ~6 (8192 one-group blocks cost 4 us
// of launch alone).  The cost to beat is each warp's serial chain, not
// the bytes: a first design (a warp a whole group, 16 tokens a lane, one
// IEEE division per code) ran at 207 registers, 2 blocks an SM, and one
// row alone took as long as eight.  So a warp takes a 32 x 32 tile and lane (r, cc) 4
// tokens x 8 channels, one 16-byte load each.  Statistics stay in
// registers as bf16 pairs (min and max are exact in bf16): a key
// channel's over the lane's 4 tokens, then over the 8 lanes r by three
// shuffles; a value token's group of 32 channels is the warp's own, the
// 4 lanes cc, two shuffles of one (min, -max) pair.  Each lane then
// computes one group's scale and reciprocal (no lane repeats another's),
// stores that group's stats (32 contiguous entries a warp) and shuffles
// them to the lanes that code with them.  A code is rint((x - mn) * inv)
// with inv the IEEE reciprocal of the guarded scale, and the IEEE
// quotient rintf(__fdiv_rn(x - mn, safe)) (the library is built without
// --use_fast_math) wherever the product lies near a half, so every code
// is torch.round of the plain form's quotient (`code` says why).  A
// lane's 8 codes of a token go to shared memory as two 4-byte stores
// (rows of 132 bytes, so that a warp's column reads hit 32 banks); then
// lane t of each warp assembles token t's words in the crumb or plane
// layout of core/quant.py (common.cuh) with shifts and byte permutes,
// and a warp stores 32 tokens of a word row, 128 contiguous bytes.
//
// The rest of the contract (any D and gs with D % gs == 0, T % gs ==
// 0, D % (32/bits) == 0; bases or token strides not 16-byte aligned)
// goes through a runtime-shape kernel: the bf16 tile staged in shared
// memory, one thread a group (statistics, then its gs codes as bytes),
// words assembled byte by byte and stored 4 bytes at a time.
//
// The in-place entry takes the store's layout (codes (B, H, Dw, Tmax);
// stats in the store's dtype, f32 or bf16 by __float2bfloat16_rn, as
// torch's .to(bfloat16) rounds) and either one offset or per-row
// offsets with a per-row predicate on the device.  A block whose row's
// predicate is false returns before it loads anything; a selected row
// writes at clamp(off, 0, Tmax - T) along T and K's stats rows at
// clamp(off / gs, 0, Tmax/gs - T/gs).  The input is the natural
// (B, H, T, D) layout with any batch, head and token strides and a
// contiguous D axis, so window slices need no copy.

#include "common.cuh"

// KIVI_QUANT_PROBE (0 in the kernels' build) cuts the main-path kernel
// short, so that profile_quant.py --probe can time its phases apart:
//   1  return after reading the row's predicate (the launch alone);
//   2  the loads only (all of a lane's 16-byte loads, then return);
//   3  no words (statistics and codes to shared memory, then return).
// The kernel is built for 8 blocks an SM (64 registers a thread) and the
// grid holds about that many.  On the H100 (PERF.md, rows 1-2) 2, 4 and 6
// blocks an SM, and the next group's loads kept in flight while a block
// codes one (its 16 registers spill at 64), were 7-24% slower at
// (8, 32, 128, 128), the batcher's flush of every decode step; at the
// one-shot ingest's (8, 32, 1024, 128) 4 or 6 blocks were up to 11%
// faster.
#ifndef KIVI_QUANT_PROBE
#define KIVI_QUANT_PROBE 0
#endif

namespace {

constexpr int PROBE = KIVI_QUANT_PROBE;
constexpr int BLOCKS_PER_SM = 8;   // the main path's occupancy target

constexpr int NT = 128;            // threads a block: 4 warps
constexpr int SLAB = 32;           // tokens a block (main path)
constexpr int FD = 128, FGS = 32;  // the main path's D and group size

struct Src {
    const __nv_bfloat16* x;
    long long sb, sh, st;          // batch, head and token strides
    int H, T, D, gs;
};

// Where a block writes.  Fresh outputs are a store with tmax = T, off 0.
struct Dst {
    uint32_t* codes;               // (B, H, Dw, tmax)
    void* scale;                   // K (B, H, tmax/gs, D), V (B, H, D/gs, tmax)
    void* mn;
    int tmax;
    int stats_bf16;                // the stats' dtype: 0 f32, 1 bf16
    int off;                       // the offset along T, when offs is null
    const int* offs;               // (B,) per-row offsets, or null
    const unsigned char* pred;     // (B,) per-row predicate, or null
};

// The row's offsets of the codes (and V's stats) along T and of K's
// stats rows, clamped as XLA's dynamic_update_slice clamps; false when
// the row's predicate is false.  (Counters are >= 0; C's truncating
// division then agrees with torch's floor division after the clamp.)
__device__ __forceinline__ bool row_offsets(const Dst& o, int b, int T,
                                            int gs, int* toff, int* goff) {
    if (o.pred && !o.pred[b]) return false;
    const int off = o.offs ? o.offs[b] : o.off;
    *toff = min(max(off, 0), o.tmax - T);
    *goff = min(max(off / gs, 0), o.tmax / gs - T / gs);
    return true;
}

__device__ __forceinline__ void put_stat(void* base, long long i, float v,
                                         int bf16) {
    if (bf16)
        static_cast<__nv_bfloat16*>(base)[i] = __float2bfloat16_rn(v);
    else
        static_cast<float*>(base)[i] = v;
}

// Channel e (0..7, a compile-time index once unrolled) of 8 bf16.
__device__ __forceinline__ float chan(const uint4& v, int e) {
    const uint32_t u = e < 2 ? v.x : e < 4 ? v.y : e < 6 ? v.z : v.w;
    return __uint_as_float((e & 1) ? (u & 0xffff0000u) : (u << 16));
}

// min and max of bf16 pairs (exact), as 32-bit words.
__device__ __forceinline__ uint32_t bmin2(uint32_t a, uint32_t b) {
    uint32_t d;
    asm("min.bf16x2 %0, %1, %2;" : "=r"(d) : "r"(a), "r"(b));
    return d;
}
__device__ __forceinline__ uint32_t bmax2(uint32_t a, uint32_t b) {
    uint32_t d;
    asm("max.bf16x2 %0, %1, %2;" : "=r"(d) : "r"(a), "r"(b));
    return d;
}
__device__ __forceinline__ float lo_f(uint32_t u) {
    return __uint_as_float(u << 16);
}
__device__ __forceinline__ float hi_f(uint32_t u) {
    return __uint_as_float(u & 0xffff0000u);
}
// a[k] for a runtime k in 0..3, by selects (no local memory).
__device__ __forceinline__ uint32_t sel4(const uint32_t (&a)[4], int k) {
    return k == 0 ? a[0] : k == 1 ? a[1] : k == 2 ? a[2] : a[3];
}

// The code of x in a group (min mn, guarded scale safe, inv its IEEE
// reciprocal): min(rint((x - mn) / safe), 2^bits - 1) with the IEEE
// quotient.  r = (x - mn) * inv lies within 1.5 * 2^-23 * r < 2^-14 of
// that quotient (r <= 256), so rint(r) is the rint of the quotient unless
// r is within 2^-12 of a half; there (and where inv overflowed and r - q
// is NaN) the quotient itself is taken, so ties round to even as
// torch.round does.  rint(r) for 0 <= r < 2^22 is r + 1.5 * 2^23, whose
// low bits are the integer; larger r (only where the scale lost bits to
// underflow) clamps to 2^bits - 1 either way.
template <int BITS>
__device__ __forceinline__ uint32_t code(float x, float mn, float safe,
                                         float inv) {
    constexpr int MAXQ = (1 << BITS) - 1;
    constexpr float MAGIC = 12582912.f;            // 1.5 * 2^23
    const float d = x - mn, r = d * inv, m = r + MAGIC;
    int q = __float_as_int(m) - __float_as_int(MAGIC);
    if (!(fabsf(r - (m - MAGIC)) < 0.5f - 0x1p-12f))
        q = (int)fmaxf(rintf(__fdiv_rn(d, safe)), 0.f);
    return (uint32_t)min(q, MAXQ);
}

// Scale, guarded scale and its IEEE reciprocal of a group's min and max.
template <int BITS>
__device__ __forceinline__ void group_scale(float lo, float hi, float& sc,
                                            float& safe, float& inv) {
    sc = __fdiv_rn(hi - lo, (float)((1 << BITS) - 1));
    safe = sc > 0.f ? sc : 1.f;
    inv = __frcp_rn(safe);
}

__device__ __forceinline__ uint32_t bytes4(uint32_t a, uint32_t b,
                                           uint32_t c, uint32_t d) {
    return __byte_perm(__byte_perm(a, b, 0x0040), __byte_perm(c, d, 0x0040),
                       0x5410);
}

constexpr int PITCH = FD + 4;      // a code row: 33 words, so a warp's
                                   // column reads hit 32 banks

// Lane (r, cc)'s 4 tokens 4r..4r+3 of a group, channels ch..ch+7.
__device__ __forceinline__ void load4(uint4 (&v)[4],
                                      const __nv_bfloat16* p,
                                      long long st) {
#pragma unroll
    for (int i = 0; i < 4; ++i)
        v[i] = __ldg(reinterpret_cast<const uint4*>(p + i * st));
}

// One 32-token group of the main path (D = 128, gs = 32) in a block of 4
// warps: statistics in registers, codes to shared memory, then words.
template <int BITS, bool KEY>
__device__ __forceinline__ void tile_group(const uint4 (&v)[4],
                                           unsigned char* cs, const Dst& o,
                                           int bh, int t0, int toff,
                                           int goff) {
    constexpr int D = FD, GS = FGS, DW = D * BITS / 32;
    const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
    const int r = lane >> 2, cc = lane & 3, ch = 32 * warp + 8 * cc;

    // statistics: min and max in bf16 pairs; each lane then takes one
    // group's scale and reciprocal (K: channel ch + r; V: token 4r + cc),
    // stores its stats (a warp's 32 lanes, 32 contiguous entries) and
    // shuffles the scales to the lanes that code with them
    float mn[KEY ? 8 : 4], sf[KEY ? 8 : 4], inv[KEY ? 8 : 4];
    float lo, hi;
    long long si;
    if constexpr (KEY) {
        uint32_t l2[4], h2[4];                   // channel pairs 2k, 2k+1
#pragma unroll
        for (int k = 0; k < 4; ++k) {
            l2[k] = h2[k] = k == 0 ? v[0].x : k == 1 ? v[0].y
                          : k == 2 ? v[0].z : v[0].w;
#pragma unroll
            for (int i = 1; i < 4; ++i) {
                const uint32_t w = k == 0 ? v[i].x : k == 1 ? v[i].y
                                 : k == 2 ? v[i].z : v[i].w;
                l2[k] = bmin2(l2[k], w);
                h2[k] = bmax2(h2[k], w);
            }
#pragma unroll
            for (int m = 4; m < 32; m <<= 1) {   // the 8 lanes r
                l2[k] = bmin2(l2[k], __shfl_xor_sync(0xffffffffu, l2[k], m));
                h2[k] = bmax2(h2[k], __shfl_xor_sync(0xffffffffu, h2[k], m));
            }
        }
#pragma unroll
        for (int e = 0; e < 8; ++e)
            mn[e] = (e & 1) ? hi_f(l2[e >> 1]) : lo_f(l2[e >> 1]);
        const uint32_t l = sel4(l2, r >> 1), h = sel4(h2, r >> 1);
        lo = (r & 1) ? hi_f(l) : lo_f(l);
        hi = (r & 1) ? hi_f(h) : lo_f(h);
        si = ((long long)bh * (o.tmax / GS) + goff + t0 / GS) * D + ch + r;
    } else {
        // (min, -max) of a token's 8 channels as one pair, so one min
        // merges both over the 4 lanes cc of the warp's 32 channels
        uint32_t p[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) {
            const uint32_t m = bmin2(bmin2(v[i].x, v[i].y),
                                     bmin2(v[i].z, v[i].w));
            const uint32_t M = bmax2(bmax2(v[i].x, v[i].y),
                                     bmax2(v[i].z, v[i].w)) ^ 0x80008000u;
            p[i] = bmin2(__byte_perm(m, M, 0x5410), __byte_perm(m, M, 0x7632));
            p[i] = bmin2(p[i], __shfl_xor_sync(0xffffffffu, p[i], 1));
            p[i] = bmin2(p[i], __shfl_xor_sync(0xffffffffu, p[i], 2));
            mn[i] = lo_f(p[i]);
        }
        const uint32_t q = sel4(p, cc);
        lo = lo_f(q);
        hi = __uint_as_float((q & 0xffff0000u) ^ 0x80000000u);
        si = ((long long)bh * (D / GS) + warp) * o.tmax + toff + t0 + 4 * r
             + cc;
    }
    float sc, sf1, inv1;
    group_scale<BITS>(lo, hi, sc, sf1, inv1);
    put_stat(o.scale, si, sc, o.stats_bf16);
    put_stat(o.mn, si, lo, o.stats_bf16);
#pragma unroll
    for (int e = 0; e < (KEY ? 8 : 4); ++e) {
        const int src = KEY ? 4 * e + cc : 4 * r + e;
        sf[e] = __shfl_sync(0xffffffffu, sf1, src);
        inv[e] = __shfl_sync(0xffffffffu, inv1, src);
    }

    // codes, 8 bytes a token, into the group's rows of shared memory
#pragma unroll
    for (int i = 0; i < 4; ++i) {
        uint32_t q[8];
#pragma unroll
        for (int e = 0; e < 8; ++e) {
            if constexpr (KEY)
                q[e] = code<BITS>(chan(v[i], e), mn[e], sf[e], inv[e]);
            else
                q[e] = code<BITS>(chan(v[i], e), mn[i], sf[i], inv[i]);
        }
        uint32_t* row = reinterpret_cast<uint32_t*>(cs + (4 * r + i) * PITCH
                                                    + ch);
        row[0] = bytes4(q[0], q[1], q[2], q[3]);
        row[1] = bytes4(q[4], q[5], q[6], q[7]);
    }
    __syncthreads();
    if (PROBE == 3) return;

    // words: lane t of warp w assembles token t's words of pairs (2/4
    // bits) or quads (8 bits) w, w + 4, ...; a warp stores 32 tokens of
    // a word row, 128 contiguous bytes
    const unsigned char* crow = cs + lane * PITCH;
    uint32_t* out = o.codes + (long long)bh * DW * o.tmax + toff + t0 + lane;
    if constexpr (BITS == 8) {
        // planes: channel j*DW + w in bits [8j, 8j+8); the piece at byte
        // j*DW + 4*mq holds plane j of words 4mq..4mq+3: a 4x4 byte
        // transpose makes the words
#pragma unroll
        for (int mq = warp; mq < DW / 4; mq += NT / 32) {
            uint32_t p[4];
#pragma unroll
            for (int j = 0; j < 4; ++j)
                p[j] = *reinterpret_cast<const uint32_t*>(crow + j * DW
                                                          + 4 * mq);
            const uint32_t a = __byte_perm(p[0], p[1], 0x5140);
            const uint32_t bb = __byte_perm(p[0], p[1], 0x7362);
            const uint32_t c = __byte_perm(p[2], p[3], 0x5140);
            const uint32_t d = __byte_perm(p[2], p[3], 0x7362);
            out[(long long)(4 * mq) * o.tmax] = __byte_perm(a, c, 0x5410);
            out[(long long)(4 * mq + 1) * o.tmax] = __byte_perm(a, c, 0x7632);
            out[(long long)(4 * mq + 2) * o.tmax] = __byte_perm(bb, d, 0x5410);
            out[(long long)(4 * mq + 3) * o.tmax] = __byte_perm(bb, d, 0x7632);
        }
    } else {
        // crumbs: channel j*(2*DW) + 2w + h in bits [16h + BITS*j, +BITS);
        // the piece at byte j*(2*DW) + 4*mp holds (w, h) = (2mp, 0),
        // (2mp, 1), (2mp+1, 0), (2mp+1, 1) of plane j
        constexpr uint32_t M = ((1u << BITS) - 1) * 0x00010001u;
#pragma unroll
        for (int mp = warp; mp < DW / 2; mp += NT / 32) {
            uint32_t se = 0, so = 0;               // h = 0 and h = 1 halves
#pragma unroll
            for (int j = 0; j < 16 / BITS; ++j) {
                const uint32_t p = *reinterpret_cast<const uint32_t*>(
                    crow + j * 2 * DW + 4 * mp);
                se |= (p & M) << (BITS * j);
                so |= ((p >> 8) & M) << (BITS * j);
            }
            out[(long long)(2 * mp) * o.tmax] = __byte_perm(se, so, 0x5410);
            out[(long long)(2 * mp + 1) * o.tmax] =
                __byte_perm(se, so, 0x7632);
        }
    }
}

// The main-path kernel: block (x, bh) takes the row's groups x, x +
// gridDim.x, ...
template <int BITS, bool KEY>
__global__ void __launch_bounds__(NT, BLOCKS_PER_SM)
qpack_tile_kernel(Src s, Dst o) {
    __shared__ __align__(16) unsigned char cs[SLAB * PITCH];
    const int bh = blockIdx.y, b = bh / s.H, h = bh - b * s.H;
    int toff, goff;
    if (!row_offsets(o, b, s.T, FGS, &toff, &goff) || PROBE == 1) return;

    const int lane = threadIdx.x & 31;
    const __nv_bfloat16* src = s.x + b * s.sb + h * s.sh
                               + (long long)(4 * (lane >> 2)) * s.st
                               + 32 * (threadIdx.x >> 5) + 8 * (lane & 3);
    const long long gstep = (long long)SLAB * s.st;
    for (int g = blockIdx.x; g < s.T / SLAB; g += gridDim.x) {
        uint4 v[4];
        load4(v, src + g * gstep, s.st);
        if (PROBE == 2) {
            uint32_t sink = 0;
#pragma unroll
            for (int i = 0; i < 4; ++i)
                sink ^= v[i].x ^ v[i].y ^ v[i].z ^ v[i].w;
            if (sink == 0x9e3779b9u) o.codes[0] = sink;   // keeps the loads
        } else {
            tile_group<BITS, KEY>(v, cs, o, bh, g * SLAB, toff, goff);
            __syncthreads();                  // the words read cs
        }
    }
}

// The runtime-shape kernel: a block takes tt tokens (whole groups) of
// one row.
template <int BITS, bool KEY>
__global__ void __launch_bounds__(NT)
qpack_any_kernel(Src s, Dst o, int tt) {
    extern __shared__ __align__(16) unsigned char smem[];
    constexpr int SLOTS = 32 / BITS;
    const int D = s.D, gs = s.gs, Dg = D / gs, Dw = D / SLOTS;
    const int bh = blockIdx.y, b = bh / s.H, h = bh - b * s.H;
    const int t0 = blockIdx.x * tt, nt = min(tt, s.T - t0);
    int toff, goff;
    if (!row_offsets(o, b, s.T, gs, &toff, &goff)) return;
    __nv_bfloat16* xs = reinterpret_cast<__nv_bfloat16*>(smem);  // (nt, D)
    unsigned char* cs = smem + (size_t)tt * D * 2;               // (nt, D)

    const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
    const __nv_bfloat16* src = s.x + b * s.sb + h * s.sh
                               + (long long)t0 * s.st;
    for (int t = warp; t < nt; t += NT / 32)
        for (int d = lane; d < D; d += 32)
            xs[t * D + d] = src[t * s.st + d];
    __syncthreads();

    // one thread a group: K (group g of the tile, channel d), elements a
    // row apart; V (token t, channel group gg), elements side by side
    const int E = nt / gs * D;                   // == nt * Dg
    for (int e = threadIdx.x; e < E; e += NT) {
        int first, step;
        long long si;
        if (KEY) {
            const int g = e / D, d = e - g * D;
            first = g * gs * D + d;
            step = D;
            si = ((long long)bh * (o.tmax / gs) + goff + t0 / gs + g) * D + d;
        } else {
            const int t = e / Dg, gg = e - t * Dg;
            first = t * D + gg * gs;
            step = 1;
            si = ((long long)bh * Dg + gg) * o.tmax + toff + t0 + t;
        }
        float lo = to_f(xs[first]), hi = lo;
        for (int i = 1; i < gs; ++i) {
            const float x = to_f(xs[first + i * step]);
            lo = fminf(lo, x);
            hi = fmaxf(hi, x);
        }
        float sc, sf, inv;
        group_scale<BITS>(lo, hi, sc, sf, inv);
        put_stat(o.scale, si, sc, o.stats_bf16);
        put_stat(o.mn, si, lo, o.stats_bf16);
        for (int i = 0; i < gs; ++i)
            cs[first + i * step] = (unsigned char)code<BITS>(
                to_f(xs[first + i * step]), lo, sf, inv);
    }
    __syncthreads();

    // word (w, t), t fastest: coalesced along T
    uint32_t* out = o.codes + (long long)bh * Dw * o.tmax + toff + t0;
    for (int i = threadIdx.x; i < Dw * nt; i += NT) {
        const int w = i / nt, t = i - w * nt;
        uint32_t word = 0;
        for (int k = 0; k < SLOTS; ++k)
            word |= (uint32_t)cs[t * D + slot_channel(w, k, Dw, BITS)]
                    << slot_shift(k, BITS);
        out[(long long)w * o.tmax + t] = word;
    }
}

bool aligned16(const void* p) { return ((uintptr_t)p & 15) == 0; }

template <int BITS, bool KEY>
int launch_as(const Src& s, const Dst& o, int B, cudaStream_t st) {
    const bool fixed = s.D == FD && s.gs == FGS && aligned16(s.x)
                       && s.sb % 8 == 0 && s.sh % 8 == 0 && s.st % 8 == 0;
    if (fixed) {
        // about BLOCKS_PER_SM blocks an SM in all; a row's further groups
        // loop
        static int sms = 0;
        if (!sms) {
            int dev = 0;
            cudaGetDevice(&dev);
            cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
        }
        const int bh = B * s.H, ng = s.T / SLAB;
        dim3 grid(min(ng, max(1, (BLOCKS_PER_SM * sms + bh - 1) / bh)),
                  bh);
        qpack_tile_kernel<BITS, KEY><<<grid, NT, 0, st>>>(s, o);
        return (int)cudaGetLastError();
    }
    // whole groups of at least 32 tokens a block
    const int tt = s.gs * (s.gs < 32 ? 32 / s.gs : 1);
    const size_t smem = (size_t)tt * s.D * 3;
    if (smem > 48 * 1024) {
        const cudaError_t e = cudaFuncSetAttribute(
            qpack_any_kernel<BITS, KEY>,
            cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
        if (e != cudaSuccess) return (int)e;
    }
    dim3 grid((s.T + tt - 1) / tt, B * s.H);
    qpack_any_kernel<BITS, KEY><<<grid, NT, smem, st>>>(s, o, tt);
    return (int)cudaGetLastError();
}

int launch(const Src& s, const Dst& o, int B, int bits, int is_key,
           cudaStream_t st) {
    const bool ok = (bits == 2 || bits == 4 || bits == 8) && B > 0
                    && s.H > 0 && s.T > 0 && s.gs > 0 && s.T % s.gs == 0
                    && s.D % s.gs == 0 && s.D % (32 / bits) == 0
                    && o.tmax >= s.T && (!is_key || o.tmax % s.gs == 0);
    if (!ok) return (int)cudaErrorInvalidValue;
    switch (bits * 2 + (is_key ? 1 : 0)) {
        case 4: return launch_as<2, false>(s, o, B, st);
        case 5: return launch_as<2, true>(s, o, B, st);
        case 8: return launch_as<4, false>(s, o, B, st);
        case 9: return launch_as<4, true>(s, o, B, st);
        case 16: return launch_as<8, false>(s, o, B, st);
        default: return launch_as<8, true>(s, o, B, st);
    }
}

}  // namespace

// Fresh outputs: codes (B, H, Dw, T) int32; f32 stats, K (B, H, T/gs, D),
// V (B, H, D/gs, T).
extern "C" int kivi_quantize_pack(const void* x, long long sb, long long sh,
                                  long long st, int B, int H, int T, int D,
                                  int gs, int bits, int is_key, void* codes,
                                  void* scale, void* mn, void* stream) {
    const Src s{static_cast<const __nv_bfloat16*>(x), sb, sh, st, H, T, D,
                gs};
    const Dst o{static_cast<uint32_t*>(codes), scale, mn, T, 0, 0, nullptr,
                nullptr};
    return launch(s, o, B, bits, is_key, (cudaStream_t)stream);
}

// Straight into a cache's stores (codes (B, H, Dw, tmax); stats of the
// store's dtype, stats_bf16 1 for bf16, 0 for f32) at `off`, or, when
// offs is not null, at offs[b] on the rows where pred[b] (pred null:
// every row).
extern "C" int kivi_quantize_pack_into(
        const void* x, long long sb, long long sh, long long st, int B, int H,
        int T, int D, int gs, int bits, int is_key, void* codes, void* scale,
        void* mn, int tmax, int stats_bf16, int off, const void* offs,
        const void* pred, void* stream) {
    const Src s{static_cast<const __nv_bfloat16*>(x), sb, sh, st, H, T, D,
                gs};
    const Dst o{static_cast<uint32_t*>(codes), scale, mn, tmax, stats_bf16,
                off, static_cast<const int*>(offs),
                static_cast<const unsigned char*>(pred)};
    return launch(s, o, B, bits, is_key, (cudaStream_t)stream);
}

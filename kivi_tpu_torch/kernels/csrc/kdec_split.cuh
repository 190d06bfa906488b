// The KIVI decode body, split over T: single-token decode attention of one
// (batch row, KV head) over one split of S = 256 positions, shared by
// fused_decode.cu (counters uniform over the batch, passed as ints),
// fused_decode_rows.cu (counters read per row from the device) and
// trimmed.cu (the ablations below, at full fill).  Every kernel is one
// instantiation of `decode_kernel`, launched by `launch`.
//
// Grid: (nsplit, B * H) blocks of NT = 128 threads.  Block (x, bh) attends
// the live positions [a, e) of its split [s0, s0 + S), s0 = shared + x*S
// (shared: 0 but on the shared-prefix route): a = max(s0, lo), e =
// min(s0 + S, nkq + nkw).  Positions p < nkq take K
// from the packed store, the rest from k_win row p - nkq; positions
// p < nvq take V from the packed store, the rest from v_win row p - nvq
// (nvq may trail nkq by up to W, so a split may straddle nvq, nkq or
// both).
//   * Loads: at the block's start every load of the split's stores is
//     issued by 16-byte cp.async into shared memory, one commit group per
//     piece in the order it is consumed: the K code rows and K scale/min
//     rows of each 128-position chunk, then the V code rows and V
//     scale/min columns of each chunk; the V pieces land while the logits
//     are computed.  The window rows (at most W of a head, in its last one
//     or two splits) are prefetched into L2 at the start and read from
//     there by whole warps, 8 rows in flight: staging them would cost
//     every block their shared memory, and blocks per SM are what keep
//     the loads in flight.  No load reaches past nkq (K store), nvq (V
//     store) or nkq + nkw (windows): a 16-byte copy that straddles a
//     bound reads only the bytes below it.
//   * The decode is bound by its instructions, not its bytes, once the
//     loads are in flight (about 20 per channel and position at 2 bits),
//     so the loops share every load they can: scales and minima are
//     read as pairs (V: the scale times each row's probability once per
//     split, and the sum of probability times min per group, so that PV
//     is sum_t (p_t s_t) c_t + sum_t p_t mn_t); codes are dequantized two
//     channels at a time from one packed word (`crumb_pair`); a QK thread
//     owns two adjacent positions (one scale, min and query load for
//     both), a PV thread two adjacent channels (one code word and p s
//     load for both).
//   * QK: thread t owns split positions 2t and 2t + 1; the store's
//     positions, then the window's (a warp per row, lanes over channels),
//     in separate loops: no per-position branch between the two.
//   * One exact softmax per split (one block max and one block sum per
//     query row).
//   * PV: the store's positions with thread t owning channels
//     2(t % (D/2)) and the next at every (2NT/D)-th position; then the
//     window's, a warp per row, lanes over channels; the position phases
//     and warps summed in order.
// A split with no live position writes the neutral partial (m = -1e30,
// l = 0; its acc is never read) without reading the cache.  With one
// split and no prefix partial the block writes the output itself;
// otherwise the last block of each (row, KV head) to finish (a ticket per
// head, counted by atomicAdd and reset by that block) merges the prefix
// pass's splits, then its own, in split order: m = max m_s over splits
// with l_s > 0, l = sum l_s exp(m_s - m), out = sum acc_s exp(m_s - m) /
// l.  Two runs are bit-equal, a row that sees
// nothing writes exact zeros, and one call is one launch with no counter
// read by the host.
//
// The 128-position chunk stays the unit of the ablations inside a split:
// the ablation parameter A takes one part of the work out at a time, for
// the decode probes of trimmed.cu (0-7 at full fill with no fp windows,
// the probe of profile_wide_32k; 5, 6 and 8-11 with the windows live,
// the attribution of profile_attribution); the decode kernels run
// Ablation<0>, the full body.  An ablated branch is not compiled into
// another variant.
//   0 full           K scales per element: q . (c * s + mn)
//   1 fold           each group's K scale folded into the query rows once
//                    per split: sum_d (q_d s_d) c + sum_d q_d mn_d
//   2 none           the chunk's first K scale row for every position
//   3 no V path      the PV product replaced by the probability of each
//                    chunk's first position
//   4 fold, no V path
//   5 no QK          logit = q . mn + sum_d c_d s_d (the unpack and scale
//                    stay live, the products with q go)
//   6 no unpack      every slot of a word reads its low `bits` bits
//   7 dma only       2, 3, 5 and 6 at once: the loads, and the output of 3
//   8 no window      no window phase: neither the K window's logits nor the
//                    V window's product (the strip [nvq, nkq) included);
//                    the store's partials merged and normalized
//   9 no store       no quantized-store body (its logits, loads and PV):
//                    the window's positions alone, merged
//  10 no store PV    the V store's product dropped, the window's kept
//  11 loads only     every load of 0 issued and landed (the window rows
//                    read into registers), no logit, softmax or product;
//                    every split writes the neutral partial (output 0)
// Variants 0-7 stage the split's K scales, V codes and V scales as the
// full body does.
#pragma once

#include "attn_wgmma.cuh"   // common.cuh, cp.async helpers

namespace kdec {

constexpr int NT = 128;       // threads per block
constexpr int NW = NT / 32;
constexpr int CH = 128;       // positions per chunk
constexpr int S = 2 * NT;     // positions per split: two per QK thread
constexpr int NCH = S / CH;   // chunks per split
constexpr int CW = CH + 4;    // words per staged code row: rows 4 banks apart
constexpr int DMAX = 128;

enum Scales { ELEMENT = 0, FOLD = 1, NONE = 2 };

template <int VAR>
struct Ablation {
    static constexpr int scales = (VAR == 1 || VAR == 4) ? FOLD
                                  : (VAR == 2 || VAR == 7) ? NONE
                                                           : ELEMENT;
    static constexpr bool qk = !(VAR == 5 || VAR == 7);
    static constexpr bool vpath = !(VAR == 3 || VAR == 4 || VAR == 7);
    static constexpr bool unpack = !(VAR == 6 || VAR == 7);
    static constexpr bool window = VAR != 8;
    static constexpr bool store = VAR != 9;
    static constexpr bool vstore = vpath && !(VAR == 9 || VAR == 10);
    static constexpr bool compute = VAR != 11;
    // the zero-point term q . mn per (group, row) is staged once per
    // split where the logits need it apart from the K values
    static constexpr bool zp = scales == FOLD || !qk;
};

// Arguments of every entry point.  Pointers are of the whole batch;
// scales are ST (bf16 or f32) of the layouts in the header of
// fused_decode.cu.  counts: (B, 3) int32 per-row (n_k_quant, n_k_win,
// n_v_quant) for the ROWS kernel (nkq, nkw, nvq unused), else NULL.
// lo: (B,) int32 lower position bound or NULL.  part_acc (B*H*nsplit*R*D floats), part_ml (2*B*H*nsplit*R
// floats) and tickets (B*H ints, zero; every launch leaves them zero)
// are the caller's workspace.  The shared-prefix route
// (fused_decode_rows.cu) sets `shared`, where the grid's first split
// starts (positions below it are the prefix pass's, kdec_prefix.cuh; a
// multiple of gs and of 8), and px_acc / px_ml, that pass's partials (H,
// px_nsplit, B, R, D) floats and (m, l) pairs, which the merge takes
// before the splits; the other entries leave the four 0.
struct Params {
    const __nv_bfloat16* q;
    const uint32_t* k_codes;
    const void* k_scale;
    const void* k_mn;
    const uint32_t* v_codes;
    const void* v_scale;
    const void* v_mn;
    const __nv_bfloat16* k_win;
    const __nv_bfloat16* v_win;
    const int* counts;
    const int* lo;
    float* out;
    float* part_acc;
    float* part_ml;
    int* tickets;
    int H, D, Tmax, W, gs, k_bits, v_bits, nkq, nkw, nvq, nsplit;
    float sm_scale;
    int shared;
    const float* px_acc;
    const float* px_ml;
    int px_nsplit;
};

// Byte offsets of the dynamic shared memory; every offset is a multiple
// of 16 (D % 8 == 0).  Staged raw: per chunk the K code rows (KDw, CW)
// words and V code rows (VDw, CW); the split's K scale and min rows
// (S/gs, D) and V scale and min columns per chunk (D/gs, CH).  Then the
// query rows (R, D) f32; the split's logits / probabilities (R, S); for
// the zero-point ablations the folded query rows (S/gs, R, D) and terms
// (S/gs, R); pm, each row's sum of probability times the V min per
// (group, row).  Two PV buffers take the K pieces' place where those are
// large enough (they are dead by then), else their own: ps, each row's
// probability times the V scale per (group, position, row), and after
// it red, the PV partials of the position phases (2NT/D, R, D) and of
// the window's warps (NW, R, D).  Fewer bytes a block, more blocks an
// SM: at the main path's shapes 26.6 KB, 8 blocks.
struct Layout {
    int kc, ks, km, vc, vs, vm, q, p, qs, zp, pm, ps, red, bytes;
    int kcs, vcs, vss;   // bytes of one chunk's code rows / V columns
};

__host__ __device__ inline Layout layout(int R, int D, int gs, int k_bits,
                                         int v_bits, int sb, bool zp) {
    const int KDw = D / (32 / k_bits), VDw = D / (32 / v_bits);
    const int ng = S / gs, Dg = D / gs;
    Layout L;
    L.kcs = KDw * CW * 4;
    L.vcs = VDw * CW * 4;
    L.vss = Dg * CH * sb;
    L.kc = 0;
    L.ks = L.kc + NCH * L.kcs;
    L.km = L.ks + ng * D * sb;
    L.vc = L.km + ng * D * sb;
    L.vs = L.vc + NCH * L.vcs;
    L.vm = L.vs + NCH * L.vss;
    L.q = L.vm + NCH * L.vss;
    L.p = L.q + R * D * 4;
    L.qs = L.p + R * S * 4;
    L.zp = L.qs + (zp ? ng * R * D * 4 : 0);
    L.pm = L.zp + (zp ? (ng * R + 3) / 4 * 16 : 0);
    L.bytes = L.pm + (Dg * R + 3) / 4 * 16;
    const int ps = Dg * S * R * 4, red = (2 * NT / D + NW) * R * D * 4;
    L.ps = ps <= L.vc ? L.kc : L.bytes;
    if (ps > L.vc) L.bytes += ps;
    L.red = red <= L.vc ? L.kc : L.bytes;
    if (red > L.vc) L.bytes += red;
    return L;
}

// A 16-byte cp.async of which only the first `bytes` (0..16) are read;
// the rest of the destination is zero-filled.
__device__ __forceinline__ void cp16n(uint32_t saddr, const void* g,
                                      int bytes) {
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                     saddr),
                 "l"(g), "r"(bytes)
                 : "memory");
}

// The same in 8 bytes (a source only 8-byte aligned).
__device__ __forceinline__ void cp8n(uint32_t saddr, const void* g,
                                     int bytes) {
    asm volatile("cp.async.ca.shared.global [%0], [%1], 8, %2;\n" ::"r"(
                     saddr),
                 "l"(g), "r"(bytes)
                 : "memory");
}

// The staging shared with the split decode route's kernels (qk_pv.cu).
// Each issues a chunk's copies from every thread of the block; the
// caller commits them.
//
// One chunk's code rows: Dw rows of CH words from position c0 (source
// rows T words long) into rows CW words apart at dst, the 16-byte pieces
// that hold a position in [a, hi), each reading only its bytes below hi.
__device__ __forceinline__ void stage_code_rows(uint32_t dst,
                                                const char* src, int Dw,
                                                int T, int c0, int a,
                                                int hi) {
    for (int i = threadIdx.x; i < Dw * (CH / 4); i += NT) {
        const int w = i / (CH / 4), v = i % (CH / 4);
        const int pos = c0 + 4 * v, n = min(16, 4 * (hi - pos));
        if (n > 0 && pos + 4 > a)
            cp16n(dst + (w * CW + 4 * v) * 4,
                  src + ((long long)w * T + pos) * 4, n);
    }
}

// One chunk's V scale and min columns: source rows g0 .. g0 + ng - 1 of
// T entries of SB bytes (ss, sm), CH positions from c0, into rows
// `stride` bytes apart at ds / dm, in pieces of P bytes (16, or 8 where
// the rows are only 8-byte aligned): the pieces that hold a position in
// [a, hi), each reading only its bytes below hi.
template <int SB>
__device__ __forceinline__ void stage_columns(uint32_t ds, uint32_t dm,
                                              int stride, const char* ss,
                                              const char* sm, int g0,
                                              int ng, int T, int c0, int a,
                                              int hi, int P) {
    const int pp = P / SB;   // positions a piece
    for (int i = threadIdx.x; i < ng * (CH / pp); i += NT) {
        const int g = i / (CH / pp), v = i % (CH / pp);
        const int pos = c0 + v * pp, n = min(P, (hi - pos) * SB);
        if (n > 0 && pos + pp > a) {
            const long long o = ((long long)(g0 + g) * T + pos) * SB;
            const int d = g * stride + v * P;
            if (P == 16) {
                cp16n(ds + d, ss + o, n);
                cp16n(dm + d, sm + o, n);
            } else {
                cp8n(ds + d, ss + o, n);
                cp8n(dm + d, sm + o, n);
            }
        }
    }
}

// For each of m items, the sum over k < n of term(i, k), as many items at
// once as fit: tpp threads per item, lanes of one warp (the largest power
// of two <= 32 with tpp * m <= NT, but at least TPP), lane l summing k =
// l, l + tpp, ..., then an xor tree over the item's lanes; put(i, sum)
// from its first lane.  The order is fixed, so two runs are bit-equal.
// Every thread calls it.
template <int TPP = 1, typename F, typename P>
__device__ __forceinline__ void sum_items(int m, int n, F term, P put) {
    int tpp = 32;
    while (tpp > TPP && tpp * m > NT) tpp >>= 1;
    const int l = threadIdx.x % tpp;
    for (int i0 = 0; i0 < m; i0 += NT / tpp) {
        const int i = i0 + threadIdx.x / tpp;
        float z = 0.f;
        if (i < m)
            for (int k = l; k < n; k += tpp) z += term(i, k);
        for (int x = tpp / 2; x > 0; x >>= 1)
            z += __shfl_xor_sync(0xffffffffu, z, x);
        if (i < m && l == 0) put(i, z);
    }
}

// The zero-point terms of ng groups' K scale and min rows ks / km (ng, D)
// with the R query rows q_s (R, D): zp (ng, R), q . mn per (group, row),
// a warp an item (lanes over D); with FOLD_Q also qs, each group's scale
// folded into the query rows (ng rows of R * D, qsg floats apart), a
// thread a channel.  Every thread calls it.
template <int R, bool FOLD_Q, typename ST>
__device__ __forceinline__ void zero_point_terms(float* qs, int qsg,
                                                 float* zp,
                                                 const float* q_s,
                                                 const ST* ks, const ST* km,
                                                 int ng, int D) {
    if (FOLD_Q)
        for (int d = threadIdx.x; d < D; d += NT)
            for (int g = 0; g < ng; ++g) {
                const float sc = to_f(ks[g * D + d]);
#pragma unroll
                for (int rr = 0; rr < R; ++rr)
                    qs[g * qsg + rr * D + d] = q_s[rr * D + d] * sc;
            }
    sum_items<32>(ng * R, D, [&](int i, int d) {
        return q_s[(i % R) * D + d] * to_f(km[(i / R) * D + d]);
    }, [&](int i, float z) { zp[i] = z; });
}

// The two codes of a crumb pair, x = the pair's bits in the low bits of
// each 16-bit half: (x | 0x3F803F80) read as two bf16 is 1 + c * 2^-7
// (exact for c < 128), and c = 128 * that - 128 (exact).
__device__ __forceinline__ float2 crumb_pair(uint32_t x) {
    x |= 0x3F803F80u;
    return make_float2(fmaf(__uint_as_float(x << 16), 128.f, -128.f),
                       fmaf(__uint_as_float(x & 0xffff0000u), 128.f,
                            -128.f));
}

// A code c < 2^23 as a float, exact: 2^23 + c, less 2^23.
__device__ __forceinline__ float code_f(uint32_t c) {
    return __uint_as_float(0x4B000000u | c) - 8388608.f;
}

// Four bf16 (a uint2) as f32.
__device__ __forceinline__ void unpack4(uint2 x, float (&f)[4]) {
    f[0] = __uint_as_float(x.x << 16);
    f[1] = __uint_as_float(x.x & 0xffff0000u);
    f[2] = __uint_as_float(x.y << 16);
    f[3] = __uint_as_float(x.y & 0xffff0000u);
}

__device__ __forceinline__ float2 ld2(const __nv_bfloat16* p) {
    return __bfloat1622float2(*(const __nv_bfloat162*)p);
}
__device__ __forceinline__ float2 ld2(const float* p) {
    return *(const float2*)p;
}

// The store logits of the R query rows at two adjacent positions of one
// group: kc[w * CW] the positions' two K code words of row w (a uint2),
// ks / km the group's scale and min rows (ks: the chunk's first row for
// the "none" ablation), q_s the query rows (R, D); the zero-point
// ablations add zp (R) of the group and read the folded rows qs (R, D).
template <int R, typename ST, typename A>
__device__ __forceinline__ void store_logits(
        float (&s0)[R], float (&s1)[R], const uint32_t* kc, const ST* ks,
        const ST* km, const float* q_s, const float* qs, const float* zp,
        int D, int KDw, int bits) {
    const uint32_t m = (1u << bits) - 1u;
    float cs0 = 0.f, cs1 = 0.f;
    for (int w = 0; w < KDw; ++w) {
        const uint2 wd = *(const uint2*)(kc + w * CW);
        uint32_t x0 = wd.x, x1 = wd.y;
        if (bits < 8) {
            // crumbs: plane jj holds channels (jj*2KDw + 2w, +1) in the
            // two 16-bit halves, bits [bits*jj, +bits) of each
            const uint32_t m2 = m * 0x00010001u;
            if (!A::unpack) {
                x0 = (x0 & m) * 0x00010001u;
                x1 = (x1 & m) * 0x00010001u;
            }
            for (int jj = 0; jj < 16 / bits; ++jj) {
                const int d = jj * 2 * KDw + 2 * w;
                const int sh = A::unpack ? bits * jj : 0;
                const float2 c0 = crumb_pair((x0 >> sh) & m2);
                const float2 c1 = crumb_pair((x1 >> sh) & m2);
                if (A::scales == FOLD && A::qk) {
#pragma unroll
                    for (int rr = 0; rr < R; ++rr) {
                        const float2 qq = *(const float2*)(qs + rr * D + d);
                        s0[rr] = fmaf(qq.x, c0.x, fmaf(qq.y, c0.y, s0[rr]));
                        s1[rr] = fmaf(qq.x, c1.x, fmaf(qq.y, c1.y, s1[rr]));
                    }
                    continue;
                }
                const float2 sc = ld2(ks + d);
                if (!A::qk) {
                    cs0 = fmaf(c0.x, sc.x, fmaf(c0.y, sc.y, cs0));
                    cs1 = fmaf(c1.x, sc.x, fmaf(c1.y, sc.y, cs1));
                    continue;
                }
                const float2 mn = ld2(km + d);
                const float k00 = fmaf(c0.x, sc.x, mn.x);
                const float k01 = fmaf(c0.y, sc.y, mn.y);
                const float k10 = fmaf(c1.x, sc.x, mn.x);
                const float k11 = fmaf(c1.y, sc.y, mn.y);
#pragma unroll
                for (int rr = 0; rr < R; ++rr) {
                    const float2 qq = *(const float2*)(q_s + rr * D + d);
                    s0[rr] = fmaf(qq.x, k00, fmaf(qq.y, k01, s0[rr]));
                    s1[rr] = fmaf(qq.x, k10, fmaf(qq.y, k11, s1[rr]));
                }
            }
        } else {
            // planes: byte jj is channel jj*KDw + w
            for (int jj = 0; jj < 4; ++jj) {
                const int d = jj * KDw + w;
                const int sh = A::unpack ? 8 * jj : 0;
                const float c0 = code_f((x0 >> sh) & m);
                const float c1 = code_f((x1 >> sh) & m);
                if (A::scales == FOLD && A::qk) {
#pragma unroll
                    for (int rr = 0; rr < R; ++rr) {
                        s0[rr] = fmaf(qs[rr * D + d], c0, s0[rr]);
                        s1[rr] = fmaf(qs[rr * D + d], c1, s1[rr]);
                    }
                    continue;
                }
                const float sc = to_f(ks[d]);
                if (!A::qk) {
                    cs0 = fmaf(c0, sc, cs0);
                    cs1 = fmaf(c1, sc, cs1);
                    continue;
                }
                const float mn = to_f(km[d]);
                const float k0 = fmaf(c0, sc, mn);
                const float k1 = fmaf(c1, sc, mn);
#pragma unroll
                for (int rr = 0; rr < R; ++rr) {
                    s0[rr] = fmaf(q_s[rr * D + d], k0, s0[rr]);
                    s1[rr] = fmaf(q_s[rr * D + d], k1, s1[rr]);
                }
            }
        }
    }
    if (A::zp) {
#pragma unroll
        for (int rr = 0; rr < R; ++rr) {
            s0[rr] += zp[rr] + (A::qk ? 0.f : cs0);
            s1[rr] += zp[rr] + (A::qk ? 0.f : cs1);
        }
    }
}

// Clamp counters into a consistent cache state (no-ops for a valid one):
// 0 <= nkq <= Tmax, 0 <= nkw <= min(W, Tmax - nkq), nkq + nkw - W <= nvq
// <= nkq.
__host__ __device__ inline void clamp_counters(int& nkq, int& nkw, int& nvq,
                                               int Tmax, int W) {
    nkq = min(max(nkq, 0), Tmax);
    nkw = min(max(nkw, 0), min(W, Tmax - nkq));
    nvq = min(max(nvq, max(nkq + nkw - W, 0)), nkq);
}

// The scale part of PV for two adjacent channels over split positions
// c0, c0 + step, ... below c1: their code words vc0[c] / vc1[c] (one word
// for crumbs, at shifts sh0 and sh0 + 16; planes: two words) times the
// group's p s per (position, row), ps (S, R).
template <int R, bool CRUMBS>
__device__ __forceinline__ void pv_store(
        float (&acc0)[R], float (&acc1)[R], const uint32_t* vc0,
        const uint32_t* vc1, int sh0, int sh1, uint32_t mask,
        const float* ps, int c0, int c1, int step) {
#pragma unroll 4
    for (int c = c0; c < c1; c += step) {
        const float2 cc =
            CRUMBS ? crumb_pair((vc0[c] >> sh0) & mask)
                   : make_float2(code_f((vc0[c] >> sh0) & mask),
                                 code_f((vc1[c] >> sh1) & mask));
#pragma unroll
        for (int rr = 0; rr < R; ++rr) {
            const float w = ps[c * R + rr];
            acc0[rr] = fmaf(w, cc.x, acc0[rr]);
            acc1[rr] = fmaf(w, cc.y, acc1[rr]);
        }
    }
}

template <int R, typename ST, typename A, bool ROWS>
__global__ void __launch_bounds__(NT) decode_kernel(const Params p) {
    extern __shared__ __align__(16) uint8_t smem[];
    __shared__ float red[R * NW], ml_s[2 * R];
    __shared__ int last;
    constexpr int SB = sizeof(ST);
    const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
    const int bh = blockIdx.y, b = bh / p.H, split = blockIdx.x;
    const int D = p.D, Tmax = p.Tmax, W = p.W, gs = p.gs;
    const int kb = p.k_bits, vb = p.v_bits, nsplit = p.nsplit;

    // this row's counters, clamped so that no read leaves its stores
    int nkq = ROWS ? p.counts[3 * b] : p.nkq;
    int nkw = ROWS ? p.counts[3 * b + 1] : p.nkw;
    int nvq = ROWS ? p.counts[3 * b + 2] : p.nvq;
    clamp_counters(nkq, nkw, nvq, Tmax, W);
    const int lo = p.lo ? max(p.lo[b], 0) : 0;
    const int s0 = p.shared + split * S;
    // live: [a, e); the ablations without the window phase or the store
    // body drop the window's positions or the store's
    const int a = A::store ? max(s0, lo) : max(max(s0, lo), nkq);
    const int e = min(s0 + S, A::window ? nkq + nkw : nkq);
    const long long slot = (long long)bh * nsplit + split;
    float* const o_b = p.out + (long long)bh * R * D;
    // one split and no prefix partial: the block writes the output itself
    const bool one = nsplit == 1 && p.px_acc == nullptr;

    if (a >= e) {   // the neutral partial, no reads
        if (one) {
            for (int i = tid; i < R * D; i += NT) o_b[i] = 0.f;
            return;
        }
        if (tid < R) {
            p.part_ml[2 * (slot * R + tid)] = KIVI_NEG_INF;
            p.part_ml[2 * (slot * R + tid) + 1] = 0.f;
        }
    } else {
        const int KDw = D / (32 / kb), VDw = D / (32 / vb);
        const int Dg = D / gs;
        const Layout L = layout(R, D, gs, kb, vb, SB, A::zp);
        const uint32_t base = wg::smem_addr(smem);
        const int hiK = min(e, nkq), hiV = min(e, nvq);
        const char* const kc_g =
            (const char*)(p.k_codes + (long long)bh * KDw * Tmax);
        const char* const vc_g =
            (const char*)(p.v_codes + (long long)bh * VDw * Tmax);
        const long long kso = (long long)bh * (Tmax / gs) * D * SB;
        const long long vso = (long long)bh * Dg * Tmax * SB;
        const char* const ks_g = (const char*)p.k_scale + kso;
        const char* const km_g = (const char*)p.k_mn + kso;
        const char* const vs_g = (const char*)p.v_scale + vso;
        const char* const vm_g = (const char*)p.v_mn + vso;

        // ---- every load of the split's stores in flight: K chunks, V
        // chunks, one commit group each (2 * NCH groups) ----
        const int rv = D * SB / 16;   // 16-byte pieces of a scale row
#pragma unroll
        for (int j = 0; j < NCH; ++j) {
            const int c0 = s0 + j * CH;
            stage_code_rows(base + L.kc + j * L.kcs, kc_g, KDw, Tmax, c0, a,
                            hiK);
            // the chunk's group rows that hold a live position (and its
            // first, which the "none" ablation reads)
            const int cg = CH / gs, g0 = c0 / gs;
            for (int i = tid; i < cg * rv; i += NT) {
                const int gi = i / rv, gp = (g0 + gi) * gs;
                if (gp < hiK && (gp + gs > a || gi == 0)) {
                    const long long o = (long long)g0 * D * SB + i * 16;
                    const int dst = j * cg * D * SB + i * 16;
                    cp16n(base + L.ks + dst, ks_g + o, 16);
                    cp16n(base + L.km + dst, km_g + o, 16);
                }
            }
            wg::cp_commit();
        }
        // the window rows of the split into L2: k_win rows [wa, e) and
        // v_win rows [va, e), each a contiguous run
        const int wa = max(a, nkq), va = max(a, nvq);
        const __nv_bfloat16* const kwin_g =
            p.k_win + ((long long)bh * W - nkq) * D;
        const __nv_bfloat16* const vwin_g =
            p.v_win + ((long long)bh * W - nvq) * D;
        if (A::window) {
            for (int i = tid * 64; i < (e - wa) * D; i += NT * 64)
                asm volatile("prefetch.global.L2 [%0];" ::"l"(
                    kwin_g + (long long)wa * D + i));
            for (int i = tid * 64; i < (e - va) * D; i += NT * 64)
                asm volatile("prefetch.global.L2 [%0];" ::"l"(
                    vwin_g + (long long)va * D + i));
        }
#pragma unroll
        for (int j = 0; j < NCH; ++j) {
            const int c0 = s0 + j * CH;
            stage_code_rows(base + L.vc + j * L.vcs, vc_g, VDw, Tmax, c0, a,
                            hiV);
            stage_columns<SB>(base + L.vs + j * L.vss,
                              base + L.vm + j * L.vss, CH * SB, vs_g, vm_g,
                              0, Dg, Tmax, c0, a, hiV, 16);
            wg::cp_commit();
        }

        if constexpr (!A::compute) {
            // the loads land and nothing is computed: the neutral partial.
            // The window rows are read into registers as the full body
            // reads them (a warp per row, 8 rows in flight), folded by xor
            // and kept live by an empty asm
            if (lane < D / 4) {
                uint2 x = make_uint2(0u, 0u);
#pragma unroll
                for (int h = 0; h < 2; ++h) {
                    const __nv_bfloat16* const g = h ? vwin_g : kwin_g;
                    for (int r0 = (h ? va : wa) + 8 * warp; r0 < e;
                         r0 += 8 * NW) {
                        uint2 w8[8];
#pragma unroll
                        for (int u = 0; u < 8; ++u)
                            w8[u] = r0 + u < e
                                        ? __ldg((const uint2*)(
                                              g + (long long)(r0 + u) * D
                                              + 4 * lane))
                                        : make_uint2(0u, 0u);
#pragma unroll
                        for (int u = 0; u < 8; ++u) {
                            x.x ^= w8[u].x;
                            x.y ^= w8[u].y;
                        }
                    }
                }
                asm volatile("" ::"r"(x.x), "r"(x.y));
            }
            wg::cp_wait<0>();
            __syncthreads();
            if (one) {
                for (int i = tid; i < R * D; i += NT) o_b[i] = 0.f;
                return;
            }
            if (tid < R) {
                p.part_ml[2 * (slot * R + tid)] = KIVI_NEG_INF;
                p.part_ml[2 * (slot * R + tid) + 1] = 0.f;
            }
        } else {
            float* const q_s = (float*)(smem + L.q);      // (R, D)
            float* const p_s = (float*)(smem + L.p);      // (R, S)
            const ST* const ksr = (const ST*)(smem + L.ks);  // (S/gs, D)
            const ST* const kmr = (const ST*)(smem + L.km);
            float* const qs_s = (float*)(smem + L.qs);  // (ng, R, D) ablations
            float* const zp_s = (float*)(smem + L.zp);  // (ng, R) ablations
            for (int i = tid; i < R * D; i += NT)
                q_s[i] = to_f(p.q[(long long)bh * R * D + i]);

            // ---- K landed ----
            wg::cp_wait<NCH>();
            __syncthreads();
            if (A::zp) {
                const int gk = hiK > s0 ? (hiK - s0 + gs - 1) / gs : 0;
                zero_point_terms<R, A::scales == FOLD>(qs_s, R * D, zp_s, q_s,
                                                       ksr, kmr, gk, D);
                __syncthreads();
            }

            // ---- logits of the store's positions: thread tid owns split
            // positions 2 tid and 2 tid + 1 (one group, one chunk) ----
            {
                const int c = 2 * tid, pos = s0 + c;
                const bool ok0 = pos >= a && pos < hiK;
                const bool ok1 = pos + 1 >= a && pos + 1 < hiK;
                float l0[R], l1[R];
#pragma unroll
                for (int rr = 0; rr < R; ++rr) l0[rr] = l1[rr] = 0.f;
                if (ok0 || ok1) {
                    const int j = c / CH, g = c / gs;
                    const int gsc = A::scales == NONE ? j * (CH / gs) : g;
                    store_logits<R, ST, A>(
                        l0, l1,
                        (const uint32_t*)(smem + L.kc + j * L.kcs) + c % CH,
                        ksr + gsc * D, kmr + g * D, q_s, qs_s + g * R * D,
                        zp_s + g * R, D, KDw, kb);
                }
#pragma unroll
                for (int rr = 0; rr < R; ++rr) {
                    p_s[rr * S + c] = ok0 ? l0[rr] * p.sm_scale : KIVI_NEG_INF;
                    p_s[rr * S + c + 1] =
                        ok1 ? l1[rr] * p.sm_scale : KIVI_NEG_INF;
                }
            }

            // ---- logits of the window's positions [wa, e): a warp per row,
            // lane l over channels [4l, 4l + 4), 8 rows in flight ----
            const int nl = D / 4;   // lanes holding channels
            __syncthreads();        // the store loop's -1e30 there is written
            if (wa < e) {
                float qr[R][4];
#pragma unroll
                for (int rr = 0; rr < R; ++rr)
#pragma unroll
                    for (int x = 0; x < 4; ++x)
                        qr[rr][x] =
                            lane < nl ? q_s[rr * D + 4 * lane + x] : 0.f;
                for (int r0 = wa + 8 * warp; r0 < e; r0 += 8 * NW) {
                    uint2 kx[8];
#pragma unroll
                    for (int u = 0; u < 8; ++u)
                        kx[u] = r0 + u < e && lane < nl
                                    ? __ldg((const uint2*)(
                                          kwin_g + (long long)(r0 + u) * D
                                          + 4 * lane))
                                    : make_uint2(0u, 0u);
#pragma unroll
                    for (int u = 0; u < 8; ++u) {
                        if (r0 + u >= e) break;
                        float k4[4];
                        unpack4(kx[u], k4);
#pragma unroll
                        for (int rr = 0; rr < R; ++rr) {
                            float z = 0.f;
#pragma unroll
                            for (int x = 0; x < 4; ++x)
                                z = fmaf(qr[rr][x], k4[x], z);
                            for (int o = 16; o > 0; o >>= 1)
                                z += __shfl_xor_sync(0xffffffffu, z, o);
                            if (lane == 0)
                                p_s[rr * S + r0 + u - s0] = z * p.sm_scale;
                        }
                    }
                }
            }
            __syncthreads();

            // ---- one exact softmax over the split ----
            float mx[R], sum[R];
#pragma unroll
            for (int rr = 0; rr < R; ++rr) {
                mx[rr] = KIVI_NEG_INF;
                for (int c = tid; c < S; c += NT)
                    if (s0 + c >= a && s0 + c < e)
                        mx[rr] = fmaxf(mx[rr], p_s[rr * S + c]);
            }
            block_reduce<R, NT>(mx, red, true);
#pragma unroll
            for (int rr = 0; rr < R; ++rr) {
                sum[rr] = 0.f;
                for (int c = tid; c < S; c += NT) {
                    const bool ok = s0 + c >= a && s0 + c < e;
                    const float pr = ok ? expf(p_s[rr * S + c] - mx[rr]) : 0.f;
                    p_s[rr * S + c] = pr;
                    sum[rr] += pr;
                }
            }
            block_reduce<R, NT>(sum, red, false);   // also orders p_s
            if (tid == 0) {
#pragma unroll
                for (int rr = 0; rr < R; ++rr) {
                    ml_s[rr] = mx[rr];
                    ml_s[R + rr] = sum[rr];
                }
            }

            // ---- V landed: per (group, position, row) the probability times
            // the V scale; per (group, row) the sum of probability times the
            // V min over the store's live positions ----
            wg::cp_wait<0>();
            __syncthreads();
            float* const ps = (float*)(smem + L.ps);       // (Dg, S, R)
            float* const pm = (float*)(smem + L.pm);       // (Dg, R)
            if (A::vstore) {
                for (int i = tid; i < Dg * S; i += NT) {
                    const int g = i / S, c = i % S;
                    const float sc = to_f(((const ST*)(
                        smem + L.vs + (c / CH) * L.vss))[g * CH + c % CH]);
#pragma unroll
                    for (int rr = 0; rr < R; ++rr)
                        ps[i * R + rr] = p_s[rr * S + c] * sc;
                }
                for (int i = warp; i < Dg * R; i += NW) {
                    const int g = i / R, rr = i % R;
                    float z = 0.f;
                    for (int c = a - s0 + lane; c < hiV - s0; c += 32)
                        z = fmaf(p_s[rr * S + c],
                                 to_f(((const ST*)(smem + L.vm + (c / CH)
                                                   * L.vss))[g * CH + c % CH]),
                                 z);
                    for (int o = 16; o > 0; o >>= 1)
                        z += __shfl_xor_sync(0xffffffffu, z, o);
                    if (lane == 0) pm[i] = z;
                }
                __syncthreads();
            }

            // ---- PV over the store's positions: thread tid owns channels
            // d0 = 2 (tid % (D/2)) and d0 + 1 at every nph-th position ----
            const int npair = D / 2, nph = NT / npair;
            const int d0 = 2 * (tid % npair), ph = tid / npair;
            int w0, sh0, w1, sh1;
            channel_slot(d0, VDw, vb, &w0, &sh0);
            channel_slot(d0 + 1, VDw, vb, &w1, &sh1);
            const int vg = d0 / gs;
            const uint32_t vmask = (1u << vb) - 1u, vm2 = vmask * 0x00010001u;
            float acc0[R], acc1[R];
#pragma unroll
            for (int rr = 0; rr < R; ++rr) acc0[rr] = acc1[rr] = 0.f;
            if (!A::vpath) {
                if (ph == 0) {
#pragma unroll
                    for (int j = 0; j < NCH; ++j)
#pragma unroll
                        for (int rr = 0; rr < R; ++rr) {
                            acc0[rr] += p_s[rr * S + j * CH];
                            acc1[rr] += p_s[rr * S + j * CH];
                        }
                }
            } else if (A::vstore) {
                const int c_lo = a - s0, c_hi = hiV - s0;
#pragma unroll
                for (int j = 0; j < NCH; ++j) {
                    const int lo_c = max(c_lo, j * CH);
                    const int hi_c = min(c_hi, (j + 1) * CH);
                    if (lo_c >= hi_c) continue;
                    // this phase's first position at or after lo_c, and the
                    // chunk's code rows indexed by split position
                    const int c1 = lo_c + ((ph - lo_c % nph) + nph) % nph;
                    const uint32_t* const vc =
                        (const uint32_t*)(smem + L.vc + j * L.vcs) - j * CH;
                    if (vb < 8)
                        pv_store<R, true>(acc0, acc1, vc + w0 * CW,
                                          vc + w1 * CW, sh0, sh1, vm2,
                                          ps + vg * S * R, c1, hi_c, nph);
                    else
                        pv_store<R, false>(acc0, acc1, vc + w0 * CW,
                                           vc + w1 * CW, sh0, sh1, vmask,
                                           ps + vg * S * R, c1, hi_c, nph);
                }
                if (ph == 0) {   // the min part, once per channel
#pragma unroll
                    for (int rr = 0; rr < R; ++rr) {
                        acc0[rr] += pm[vg * R + rr];
                        acc1[rr] += pm[vg * R + rr];
                    }
                }
            }
            // ---- PV over the window's positions [va, e): a warp per row,
            // lane l over channels [4l, 4l + 4), 8 rows in flight ----
            float aw[R][4];
#pragma unroll
            for (int rr = 0; rr < R; ++rr)
#pragma unroll
                for (int x = 0; x < 4; ++x) aw[rr][x] = 0.f;
            if (A::vpath && A::window) {
                for (int r0 = va + 8 * warp; r0 < e; r0 += 8 * NW) {
                    uint2 vx[8];
#pragma unroll
                    for (int u = 0; u < 8; ++u)
                        vx[u] = r0 + u < e && lane < nl
                                    ? __ldg((const uint2*)(
                                          vwin_g + (long long)(r0 + u) * D
                                          + 4 * lane))
                                    : make_uint2(0u, 0u);
#pragma unroll
                    for (int u = 0; u < 8; ++u) {
                        if (r0 + u >= e) break;
                        float v4[4];
                        unpack4(vx[u], v4);
#pragma unroll
                        for (int rr = 0; rr < R; ++rr) {
                            const float pr = p_s[rr * S + r0 + u - s0];
#pragma unroll
                            for (int x = 0; x < 4; ++x)
                                aw[rr][x] = fmaf(pr, v4[x], aw[rr][x]);
                        }
                    }
                }
            }
            // ---- the position phases, then the warps, summed in order ----
            __syncthreads();   // ps, under red, is read no more
            float* const red_s = (float*)(smem + L.red);   // (nph + NW, R, D)
#pragma unroll
            for (int rr = 0; rr < R; ++rr) {
                *(float2*)(red_s + (ph * R + rr) * D + d0) =
                    make_float2(acc0[rr], acc1[rr]);
                if (lane < nl)
                    *(float4*)(red_s + ((nph + warp) * R + rr) * D + 4 * lane) =
                        make_float4(aw[rr][0], aw[rr][1], aw[rr][2], aw[rr][3]);
            }
            __syncthreads();
            for (int i = tid; i < R * D; i += NT) {
                float x = red_s[i];
                for (int h = 1; h < nph + NW; ++h) x += red_s[h * R * D + i];
                if (one)
                    o_b[i] = x / ml_s[R + i / D];
                else
                    p.part_acc[slot * R * D + i] = x;
            }
            if (one) return;
            if (tid < R) {
                p.part_ml[2 * (slot * R + tid)] = ml_s[tid];
                p.part_ml[2 * (slot * R + tid) + 1] = ml_s[R + tid];
            }
        }
    }

    // ---- the last block of the head merges, in order, the prefix
    // pass's splits (if any), then its own ----
    __threadfence();
    __syncthreads();
    if (tid == 0) last = atomicAdd(&p.tickets[bh], 1) == nsplit - 1;
    __syncthreads();
    if (!last) return;
    __threadfence();
    const float* const pa = p.part_acc + (long long)bh * nsplit * R * D;
    const float2* const pml =
        (const float2*)p.part_ml + (long long)bh * nsplit * R;
    // the prefix partials of this row's R query rows: split sp, row rr at
    // (sp * B * R + rr), from (h * px_nsplit * B + b) * R
    const int nx = p.px_acc ? p.px_nsplit : 0;
    const long long xs = (long long)(gridDim.y / p.H) * R;
    const long long x0 =
        nx ? ((long long)(bh % p.H) * nx * (gridDim.y / p.H) + b) * R : 0;
    auto part = [&](int sp, int rr, const float** acc) {
        if (sp < nx) {
            *acc = p.px_acc + (x0 + sp * xs + rr) * D;
            return __ldcg((const float2*)p.px_ml + x0 + sp * xs + rr);
        }
        *acc = pa + ((sp - nx) * R + rr) * D;
        return __ldcg(pml + (sp - nx) * R + rr);
    };
    for (int rr = warp; rr < R; rr += NW) {
        const float* acc;
        float M = KIVI_NEG_INF;
        for (int sp = 0; sp < nx + nsplit; ++sp) {
            const float2 ml = part(sp, rr, &acc);
            if (ml.y > 0.f) M = fmaxf(M, ml.x);
        }
        float Lsum = 0.f, Acc[DMAX / 32];
#pragma unroll
        for (int x = 0; x < DMAX / 32; ++x) Acc[x] = 0.f;
        for (int sp = 0; sp < nx + nsplit; ++sp) {
            const float2 ml = part(sp, rr, &acc);
            if (!(ml.y > 0.f)) continue;
            const float c = expf(ml.x - M);
            Lsum += ml.y * c;
#pragma unroll
            for (int x = 0; x < DMAX / 32; ++x) {
                const int dd = lane + 32 * x;
                if (dd < D) Acc[x] += __ldcg(acc + dd) * c;
            }
        }
#pragma unroll
        for (int x = 0; x < DMAX / 32; ++x) {
            const int dd = lane + 32 * x;
            if (dd < D) o_b[rr * D + dd] = Lsum > 0.f ? Acc[x] / Lsum : 0.f;
        }
    }
    if (tid == 0) p.tickets[bh] = 0;
}

// Checks what every kernel takes (0 or cudaErrorInvalidValue): D <= 128
// dividing 2 NT with D % 8 == 0 and D % gs == 0, 128 % gs == 0, gs even,
// bits 2/4/8, Tmax % 8 == 0, the caller's split size equal to S, the
// nsplit splits from `shared` (a multiple of gs and 8) covering
// [shared, n_end).
inline int check_args(const Params& p, int split, int n_end) {
    const bool bits_ok = (p.k_bits == 2 || p.k_bits == 4 || p.k_bits == 8)
                         && (p.v_bits == 2 || p.v_bits == 4
                             || p.v_bits == 8);
    if (!bits_ok || p.D > DMAX || p.D < 8 || p.D % 8 || (2 * NT) % p.D
        || p.gs < 2 || p.gs % 2 || p.D % p.gs || CH % p.gs || p.Tmax % 8
        || p.Tmax % p.gs || p.W < 0 || split != S || p.nsplit < 1
        || p.shared < 0 || p.shared % p.gs || p.shared % 8
        || p.shared + (long long)p.nsplit * S < n_end)
        return (int)cudaErrorInvalidValue;
    return 0;
}

template <int R, typename ST, typename A, bool ROWS>
int launch(const Params& p, int BH, cudaStream_t stream) {
    const Layout L = layout(R, p.D, p.gs, p.k_bits, p.v_bits,
                            (int)sizeof(ST), A::zp);
    auto kern = decode_kernel<R, ST, A, ROWS>;
    if (L.bytes > 48 * 1024) {
        cudaError_t e = cudaFuncSetAttribute(
            kern, cudaFuncAttributeMaxDynamicSharedMemorySize, L.bytes);
        if (e != cudaSuccess) return (int)e;
    }
    kern<<<dim3(p.nsplit, BH), NT, L.bytes, stream>>>(p);
    return (int)cudaGetLastError();
}

}  // namespace kdec

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
// logits (the whole T, dead splits included): ~2 us at 3.35 TB/s.  PV
// reads the 2.1 MB of f32 p beside the same V bytes.  The FLOPs (2*r*D per
// position) are far below the card's rate.  At those shapes the kernels
// take 8-10x the bound (PERF.md): the launch (an empty kernel on this
// grid takes a third of QK's time), then with the loads in flight the
// dequantize-and-multiply instructions of the ~3 blocks an SM the grid
// gives, and PV's merge after its last split.
//
// Design: the store half of the KIVI decode body (kdec_split.cuh) and its
// pieces, one launch per call over (S = 256-position splits, batch * KV
// head) blocks of NT = 128 threads:
//   * Loads: a live split issues every load of its stores at its start by
//     cp.async (kdec::stage_code_rows / stage_columns), one commit group
//     per 128-position chunk, code rows CW words apart; a copy that
//     straddles n_quant reads only the bytes below it, and no copy starts
//     at or past it.
//   * QK: a split at or past n_quant writes -1e30 over its positions by
//     16-byte stores and reads nothing.  In a live split thread t owns
//     split positions 2t and 2t + 1 (kdec::store_logits: two channels
//     dequantized from one code word, one query load for both positions)
//     and writes each row's pair as one float2.  Each live group's K scale
//     is folded into the query rows once per split and q . mn kept apart
//     per group (FOLD: the logit is sum_d (q_d s_d) c_d + q . mn).
//   * PV: live splits only (one when n_quant is 0, which writes zeros).
//     Per (group, position, row) p times the V scale once per split, and
//     per (group, row) the sum of p times the V min; thread t owns
//     channels 2 (t % (D/2)) and the next at every nph-th position
//     (kdec::pv_store), the position phases summed in order.  With one
//     split the block writes the output itself; otherwise each split
//     writes its (r, D) partial into the caller's workspace and the last
//     block of each head (a ticket counted by atomicAdd and reset by that
//     block) adds the partials in split order, a float4 a thread with 16
//     splits' loads in flight.  No atomics on the data: two runs are
//     bit-equal.
//   * Group tiles: a split's K groups (QK) or V channel groups (PV) are
//     staged and folded gt at a time, gt the most that fit in shared
//     memory; at group sizes >= 8 one tile holds them all, so only the
//     small group sizes loop.  At group size 1 a position pair (QK) or a
//     channel pair (PV) spans two groups, and the thread runs the pair
//     once per group, keeping the half of each that is its own.
//   * PV's sums per (group, row) run for all items at once (sum_items),
//     not a warp an item, g-minor with the V columns' rows padded, so
//     that the items of a warp meet different banks.  The code width is
//     a template argument, and so are D = 128 and gs = 32 (the main
//     path's), so that the dequantize loops of store_logits and pv_store
//     unroll with constant shifts and strides.
//
// KIVI_QKPV_PROBE (profile_qk_pv.py builds each, the kernels' default is
// 0) takes one piece out to time the rest: 1 both kernels return at
// once; 2 they stage their loads and return; 3 PV skips the merge (the
// output is then wrong); 4 D and gs from the arguments at every shape;
// 5 QK in the ELEMENT form, q . (c s + mn).

#include <type_traits>

#include "kdec_split.cuh"

#ifndef KIVI_QKPV_PROBE
#define KIVI_QKPV_PROBE 0
#endif

namespace {

using kdec::CH;
using kdec::CW;
using kdec::NCH;
using kdec::NT;
using kdec::S;

constexpr int SMEM_MAX = 232448;   // shared memory a block may use
constexpr int PROBE = KIVI_QKPV_PROBE;

using Form = kdec::Ablation<PROBE == 5 ? 0 : 1>;   // FOLD

__host__ __device__ inline int up16(int x) { return (x + 15) & ~15; }

// Byte offsets of the QK kernel's dynamic shared memory (multiples of 16)
// for a tile of gt groups: the K code rows (KDw, CW) words of each chunk,
// the query rows (R, D) f32, the tile's K scale and min rows (gt, D), the
// folded query rows (gt, QSG) and terms q . mn (gt, R).  A warp's 64
// positions span 64/gs groups; QSG = R * D + 4 floats puts their folded
// rows 4 banks apart.
struct QkLayout {
    int kc, q, ks, km, qs, zp, bytes, kcs;
};

__host__ __device__ inline QkLayout qk_layout(int R, int D, int bits,
                                              int sb, int gt) {
    QkLayout L;
    L.kcs = D / (32 / bits) * CW * 4;
    L.kc = 0;
    L.q = L.kc + NCH * L.kcs;
    L.ks = L.q + R * D * 4;
    L.km = up16(L.ks + gt * D * sb);
    L.qs = up16(L.km + gt * D * sb);
    L.zp = L.qs + gt * (R * D + 4) * 4;
    L.bytes = up16(L.zp + gt * R * 4);
    return L;
}

// The PV kernel's: p's rows (R, S) f32, later the position phases'
// partials (nph, R, D); the V code rows of each chunk; the tile's V scale
// and min columns (gt, CH) of each chunk, vrs bytes apart (16 more than a
// row: the groups of one position meet different banks); ps, p times the
// V scale (gt, S, R); pm, the sum of p times the V min (gt, R).
struct PvLayout {
    int p, vc, vs, vm, ps, pm, bytes, vcs, vrs, vss;
};

__host__ __device__ inline PvLayout pv_layout(int R, int D, int bits,
                                              int sb, int gt) {
    PvLayout L;
    L.vcs = D / (32 / bits) * CW * 4;
    L.vrs = CH * sb + 16;
    L.vss = gt * L.vrs;
    L.p = 0;
    L.vc = L.p + R * S * 4;
    L.vs = L.vc + NCH * L.vcs;
    L.vm = L.vs + NCH * L.vss;
    L.ps = L.vm + NCH * L.vss;
    L.pm = L.ps + gt * S * R * 4;
    L.bytes = L.pm + up16(gt * R * 4);
    return L;
}

// Arguments of both kernels: x is q (B,H,R,D) bf16 for QK, p (B,H,R,T)
// f32 for PV; scale / mn are ST (bf16 or f32).  part (B*H*nsplit*R*D
// floats) and tickets (B*H ints, zero; every launch leaves them zero) are
// the caller's workspace, PV only.  gt: groups a tile.
struct Args {
    const void* x;
    const uint32_t* codes;
    const void* scale;
    const void* mn;
    float* out;
    float* part;
    int* tickets;
    int D, T, gs, bits, nq, gt;
};

// The kernels take the code width BITS, and D and gs as DD and GS where
// these are not 0 (the main path's 128 and 32: constant strides and group
// indices), else from the arguments.
template <int R, typename ST, int BITS, int DD, int GS>
__global__ void __launch_bounds__(NT) qk_dequant_kernel(const Args a) {
    extern __shared__ __align__(16) uint8_t smem[];
    constexpr int SB = sizeof(ST);
    if (PROBE == 1) return;
    const int tid = threadIdx.x;
    const int bh = blockIdx.y, s0 = blockIdx.x * S;
    const int D = DD ? DD : a.D, gs = GS ? GS : a.gs, T = a.T, gt = a.gt;
    const int hi = min(s0 + S, a.nq);   // live positions: [s0, hi)
    float* const o = a.out + (long long)bh * R * T;

    if (hi <= s0) {   // a dead split: -1e30, nothing read
        const int n4 = min(S, T - s0) / 4;
        const float4 neg = make_float4(KIVI_NEG_INF, KIVI_NEG_INF,
                                       KIVI_NEG_INF, KIVI_NEG_INF);
        for (int i = tid; i < R * n4; i += NT)
            *(float4*)(o + (long long)(i / n4) * T + s0 + 4 * (i % n4)) = neg;
        return;
    }
    const int KDw = D / (32 / BITS), gk = (hi - s0 + gs - 1) / gs;
    const QkLayout L = qk_layout(R, D, BITS, SB, gt);
    const uint32_t base = wg::smem_addr(smem);
    const char* const kc_g = (const char*)(a.codes + (long long)bh * KDw * T);
    const long long so = ((long long)bh * (T / gs) + s0 / gs) * D * SB;
    const char* const ks_g = (const char*)a.scale + so;
    const char* const km_g = (const char*)a.mn + so;
    const int P = D * SB % 16 ? 8 : 16;   // bytes a copy of scale rows

    // the scale and min rows of the live groups [g0, g0 + gn): one run
    // of gn * D * SB bytes each
    auto stage_rows = [&](int g0, int gn) {
        for (int i = tid * P; i < gn * D * SB; i += NT * P) {
            const long long off = (long long)g0 * D * SB + i;
            if (P == 16) {
                kdec::cp16n(base + L.ks + i, ks_g + off, 16);
                kdec::cp16n(base + L.km + i, km_g + off, 16);
            } else {
                kdec::cp8n(base + L.ks + i, ks_g + off, 8);
                kdec::cp8n(base + L.km + i, km_g + off, 8);
            }
        }
        wg::cp_commit();
    };

    // ---- every load of the split in flight: the code rows of each
    // chunk, then the first tile's scale and min rows ----
#pragma unroll
    for (int j = 0; j < NCH; ++j) {
        kdec::stage_code_rows(base + L.kc + j * L.kcs, kc_g, KDw, T,
                              s0 + j * CH, s0, hi);
        wg::cp_commit();
    }
    stage_rows(0, min(gt, gk));
    float* const q_s = (float*)(smem + L.q);   // (R, D)
    const __nv_bfloat16* const qg = (const __nv_bfloat16*)a.x;
    for (int i = tid; i < R * D; i += NT)
        q_s[i] = to_f(qg[(long long)bh * R * D + i]);
    if (PROBE == 2) {
        wg::cp_wait<0>();
        return;
    }

    // ---- thread tid: split positions c and c + 1 (one group unless gs
    // is 1, one chunk) ----
    const int c = 2 * tid, pos = s0 + c, g = c / gs;
    const bool ok0 = pos < hi, ok1 = pos + 1 < hi;
    const ST* const ks = (const ST*)(smem + L.ks);   // (gt, D)
    const ST* const km = (const ST*)(smem + L.km);
    const int QSG = R * D + 4;
    float* const qs_s = (float*)(smem + L.qs);       // (gt, QSG)
    float* const zp_s = (float*)(smem + L.zp);       // (gt, R)
    const uint32_t* const kc =
        (const uint32_t*)(smem + L.kc + (c / CH) * L.kcs) + c % CH;
    float l0[R], l1[R];
#pragma unroll
    for (int rr = 0; rr < R; ++rr) l0[rr] = l1[rr] = 0.f;
    for (int g0 = 0;;) {
        const int gn = min(gt, gk - g0);
        wg::cp_wait<0>();
        __syncthreads();
        if (Form::zp)   // FOLD: the tile's scales into the query rows
            kdec::zero_point_terms<R, true>(qs_s, QSG, zp_s, q_s, ks, km,
                                            gn, D);
        __syncthreads();
        const int lg = g - g0;   // the thread's group in the tile
        if (ok0 && lg >= 0 && lg < gn) {
            auto logits = [&](float(&x0)[R], float(&x1)[R], int h) {
                kdec::store_logits<R, ST, Form>(
                    x0, x1, kc, ks + (lg + h) * D, km + (lg + h) * D, q_s,
                    qs_s + (lg + h) * QSG, zp_s + (lg + h) * R, D, KDw,
                    BITS);
            };
            if (gs == 1) {   // the second position: the next group
                float x0[R], x1[R];
#pragma unroll
                for (int rr = 0; rr < R; ++rr) x0[rr] = x1[rr] = 0.f;
                logits(l0, x1, 0);
                logits(x0, l1, 1);
            } else {
                logits(l0, l1, 0);
            }
        }
        g0 += gt;
        if (g0 >= gk) break;
        __syncthreads();   // the tile's rows are read no more
        stage_rows(g0, min(gt, gk - g0));
    }
    if (pos >= T) return;
#pragma unroll
    for (int rr = 0; rr < R; ++rr)
        *(float2*)(o + (long long)rr * T + pos) =
            make_float2(ok0 ? l0[rr] : KIVI_NEG_INF,
                        ok1 ? l1[rr] : KIVI_NEG_INF);
}

template <int R, typename ST, int BITS, int DD, int GS>
__global__ void __launch_bounds__(NT) pv_dequant_kernel(const Args a) {
    extern __shared__ __align__(16) uint8_t smem[];
    __shared__ int last;
    constexpr int SB = sizeof(ST);
    if (PROBE == 1) return;
    const int tid = threadIdx.x;
    const int bh = blockIdx.y, split = blockIdx.x, nsplit = gridDim.x;
    const int D = DD ? DD : a.D, gs = GS ? GS : a.gs, T = a.T, gt = a.gt;
    const int s0 = split * S, n = min(S, a.nq - s0);   // live: [s0, s0 + n)
    float* const o_b = a.out + (long long)bh * R * D;

    if (n <= 0) {   // n_quant == 0: the one split sees nothing
        for (int i = tid; i < R * D; i += NT) o_b[i] = 0.f;
        return;
    }
    const int VDw = D / (32 / BITS), Dg = D / gs;
    const PvLayout L = pv_layout(R, D, BITS, SB, gt);
    const uint32_t base = wg::smem_addr(smem);
    const char* const p_g = (const char*)((const float*)a.x
                                          + (long long)bh * R * T);
    const char* const vc_g = (const char*)(a.codes + (long long)bh * VDw * T);
    const long long so = (long long)bh * Dg * T * SB;
    const char* const vs_g = (const char*)a.scale + so;
    const char* const vm_g = (const char*)a.mn + so;
    const int P = T * SB % 16 ? 8 : 16;   // bytes a copy of the columns

    // ---- every load of the split in flight: p's rows, then per chunk its
    // V code rows and the first tile's V scale and min columns ----
    for (int i = tid; i < R * (S / 4); i += NT) {
        const int rr = i / (S / 4), v = i % (S / 4);
        const int nb = min(16, 4 * (n - 4 * v));
        if (nb > 0)
            kdec::cp16n(base + L.p + (rr * S + 4 * v) * 4,
                        p_g + ((long long)rr * T + s0 + 4 * v) * 4, nb);
    }
    auto stage_cols = [&](int j, int g0, int gn) {
        kdec::stage_columns<SB>(base + L.vs + j * L.vss,
                                base + L.vm + j * L.vss, L.vrs, vs_g, vm_g,
                                g0, gn, T, s0 + j * CH, s0, s0 + n, P);
    };
#pragma unroll
    for (int j = 0; j < NCH; ++j) {
        kdec::stage_code_rows(base + L.vc + j * L.vcs, vc_g, VDw, T,
                              s0 + j * CH, s0, s0 + n);
        stage_cols(j, 0, min(gt, Dg));
        wg::cp_commit();
    }
    if (PROBE == 2) {
        wg::cp_wait<0>();
        return;
    }

    // ---- thread tid: channels d0 and d0 + 1 (one group unless gs is 1)
    // at every nph-th position (threads past nph * D/2 idle when D/2 does
    // not divide NT) ----
    const float* const p_s = (const float*)(smem + L.p);   // (R, S)
    float* const ps = (float*)(smem + L.ps);                // (gt, S, R)
    float* const pm = (float*)(smem + L.pm);                // (gt, R)
    const int npair = D / 2, nph = NT / npair;
    const int d0 = 2 * (tid % npair), ph = tid / npair, vg = d0 / gs;
    int w0, sh0, w1, sh1;
    channel_slot(d0, VDw, BITS, &w0, &sh0);
    channel_slot(d0 + 1, VDw, BITS, &w1, &sh1);
    float acc0[R], acc1[R];
#pragma unroll
    for (int rr = 0; rr < R; ++rr) acc0[rr] = acc1[rr] = 0.f;
    for (int g0 = 0;;) {
        const int gn = min(gt, Dg - g0);
        wg::cp_wait<0>();
        __syncthreads();
        // ---- per (group, position, row) p times the V scale; per
        // (group, row) the sum of p times the V min over the live
        // positions ----
        for (int i = tid; i < gn * S; i += NT) {
            const int g = i / S, c = i % S;
            if (c >= n) continue;
            const float sc = to_f(((const ST*)(smem + L.vs + (c / CH) * L.vss
                                               + g * L.vrs))[c % CH]);
            float w[R];
#pragma unroll
            for (int rr = 0; rr < R; ++rr) w[rr] = p_s[rr * S + c] * sc;
            if (R % 4 == 0) {
#pragma unroll
                for (int rr = 0; rr < R; rr += 4)
                    *(float4*)(ps + i * R + rr) =
                        make_float4(w[rr], w[rr + 1], w[rr + 2], w[rr + 3]);
            } else {
#pragma unroll
                for (int rr = 0; rr < R; ++rr) ps[i * R + rr] = w[rr];
            }
        }
        kdec::sum_items(gn * R, n, [&](int i, int c) {   // items g-minor
            return p_s[(i / gn) * S + c]
                   * to_f(((const ST*)(smem + L.vm + (c / CH) * L.vss
                                       + (i % gn) * L.vrs))[c % CH]);
        }, [&](int i, float z) { pm[(i % gn) * R + i / gn] = z; });
        __syncthreads();

        const int lg = vg - g0;   // the thread's group in the tile
        if (ph < nph && lg >= 0 && lg < gn) {
            constexpr uint32_t vmask = (1u << BITS) - 1u;
            auto products = [&](float(&x0)[R], float(&x1)[R], int h) {
#pragma unroll
                for (int j = 0; j < NCH; ++j) {
                    const int lo_c = j * CH, hi_c = min(n, (j + 1) * CH);
                    if (lo_c >= hi_c) break;
                    // this phase's first position of the chunk, and the
                    // chunk's code rows indexed by split position
                    const int c1 = lo_c + ((ph - lo_c % nph) + nph) % nph;
                    const uint32_t* const vc =
                        (const uint32_t*)(smem + L.vc + j * L.vcs) - j * CH;
                    if (BITS < 8)
                        kdec::pv_store<R, true>(
                            x0, x1, vc + w0 * CW, vc + w1 * CW, sh0, sh1,
                            vmask * 0x00010001u, ps + (lg + h) * S * R, c1,
                            hi_c, nph);
                    else
                        kdec::pv_store<R, false>(
                            x0, x1, vc + w0 * CW, vc + w1 * CW, sh0, sh1,
                            vmask, ps + (lg + h) * S * R, c1, hi_c, nph);
                }
            };
            const int h1 = gs == 1;   // the second channel's group
            if (h1) {
                float x0[R], x1[R];
#pragma unroll
                for (int rr = 0; rr < R; ++rr) x0[rr] = x1[rr] = 0.f;
                products(acc0, x1, 0);
                products(x0, acc1, 1);
            } else {
                products(acc0, acc1, 0);
            }
            if (ph == 0) {   // the min part, once per channel
#pragma unroll
                for (int rr = 0; rr < R; ++rr) {
                    acc0[rr] += pm[lg * R + rr];
                    acc1[rr] += pm[(lg + h1) * R + rr];
                }
            }
        }
        g0 += gt;
        if (g0 >= Dg) break;
        __syncthreads();   // the tile's columns are read no more
#pragma unroll
        for (int j = 0; j < NCH; ++j) stage_cols(j, g0, min(gt, Dg - g0));
        wg::cp_commit();
    }

    // ---- the position phases, summed in order (over p: read no more
    // after the last tile's barrier) ----
    float* const red = (float*)(smem + L.p);   // (nph, R, D)
    if (ph < nph) {
#pragma unroll
        for (int rr = 0; rr < R; ++rr)
            *(float2*)(red + (ph * R + rr) * D + d0) =
                make_float2(acc0[rr], acc1[rr]);
    }
    __syncthreads();
    float* const part = a.part + ((long long)bh * nsplit + split) * R * D;
    for (int i = tid; i < R * D; i += NT) {
        float x = red[i];
        for (int h = 1; h < nph; ++h) x += red[h * R * D + i];
        if (nsplit == 1)
            o_b[i] = x;
        else
            part[i] = x;
    }
    if (nsplit == 1 || PROBE == 3) return;

    // ---- the last block of the head adds the partials in split order:
    // a float4 of outputs a thread, MF splits' loads in flight ----
    __threadfence();
    __syncthreads();
    if (tid == 0) last = atomicAdd(&a.tickets[bh], 1) == nsplit - 1;
    __syncthreads();
    if (!last) return;
    __threadfence();
    constexpr int MF = 16;
    const int RD4 = R * D / 4;
    const float4* const pa =
        (const float4*)(a.part + (long long)bh * nsplit * R * D);
    for (int i = tid; i < RD4; i += NT) {
        float4 x = make_float4(0.f, 0.f, 0.f, 0.f);
        for (int sp = 0; sp < nsplit; sp += MF) {
            float4 v[MF];
#pragma unroll
            for (int u = 0; u < MF; ++u)
                v[u] = sp + u < nsplit ? __ldcg(pa + (long long)(sp + u) * RD4
                                                + i)
                                       : make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll
            for (int u = 0; u < MF; ++u) {
                x.x += v[u].x;
                x.y += v[u].y;
                x.z += v[u].z;
                x.w += v[u].w;
            }
        }
        ((float4*)o_b)[i] = x;
    }
    if (tid == 0) a.tickets[bh] = 0;
}

// The most groups of ng a tile holds within SMEM_MAX bytes (even at gs 1,
// where a thread's pair spans two groups), or 0 if none fits.
template <typename F>
int tile_groups(int ng, int gs, F bytes) {
    const int step = gs == 1 ? 2 : 1;
    int gt = ng;
    while (gt > step && bytes(gt) > SMEM_MAX) gt -= step;
    return bytes(gt) <= SMEM_MAX ? gt : 0;
}

template <typename K>
int run(K kern, int bytes, int nsplit, int BH, const Args& a,
        cudaStream_t st) {
    if (bytes > 48 * 1024) {
        cudaError_t e = cudaFuncSetAttribute(
            kern, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
        if (e != cudaSuccess) return (int)e;
    }
    kern<<<dim3(nsplit, BH), NT, bytes, st>>>(a);
    return (int)cudaGetLastError();
}

// f(std::integral_constant<int, BITS>(), std::integral_constant<int,
// DD>(), ...<GS>()): the code width as a template argument, so that the
// dequantize loops of kdec::store_logits and kdec::pv_store unroll with
// constant shifts, and D = 128 with gs = 32 as DD and GS.
template <typename F>
int with_shape(const Args& a, F f) {
    using std::integral_constant;
    const bool fixed = a.D == 128 && a.gs == 32 && PROBE != 4;
    switch (a.bits) {
#define KIVI_SHAPE(BB)                                                     \
        case BB:                                                           \
            return fixed ? f(integral_constant<int, BB>(),                 \
                            integral_constant<int, 128>(),                 \
                            integral_constant<int, 32>())                  \
                        : f(integral_constant<int, BB>(),                  \
                            integral_constant<int, 0>(),                   \
                            integral_constant<int, 0>());
        KIVI_SHAPE(2) KIVI_SHAPE(4) KIVI_SHAPE(8)
#undef KIVI_SHAPE
        default: return (int)cudaErrorInvalidValue;
    }
}

template <int R, typename ST>
int launch_qk(Args a, int BH, cudaStream_t st) {
    const int ns = (a.T + S - 1) / S, sb = (int)sizeof(ST);
    return with_shape(a, [&](auto b, auto dd, auto gg) {
        constexpr int BITS = decltype(b)::value, DD = decltype(dd)::value;
        constexpr int GS = decltype(gg)::value;
        auto bytes = [&](int gt) {
            return qk_layout(R, a.D, BITS, sb, gt).bytes;
        };
        a.gt = tile_groups(S / a.gs, a.gs, bytes);
        if (!a.gt) return (int)cudaErrorInvalidValue;
        return run(qk_dequant_kernel<R, ST, BITS, DD, GS>, bytes(a.gt), ns,
                   BH, a, st);
    });
}

template <int R, typename ST>
int launch_pv(Args a, int nsplit, int BH, cudaStream_t st) {
    const int sb = (int)sizeof(ST);
    return with_shape(a, [&](auto b, auto dd, auto gg) {
        constexpr int BITS = decltype(b)::value, DD = decltype(dd)::value;
        constexpr int GS = decltype(gg)::value;
        auto bytes = [&](int gt) {
            return pv_layout(R, a.D, BITS, sb, gt).bytes;
        };
        a.gt = tile_groups(a.D / a.gs, a.gs, bytes);
        if (!a.gt) return (int)cudaErrorInvalidValue;
        return run(pv_dequant_kernel<R, ST, BITS, DD, GS>, bytes(a.gt),
                   nsplit, BH, a, st);
    });
}

// What both kernels take (0 or cudaErrorInvalidValue): bits 2/4/8, D <=
// 128 a multiple of 4 and of the codes a word holds, gs dividing D and
// 128, T > 0 a multiple of 4 (every code and p row copied is whole
// 16-byte pieces; scale rows and columns then 8-byte ones at least), the
// caller's split size equal to S.
int check_args(int D, int T, int gs, int bits, int split) {
    const bool ok = (bits == 2 || bits == 4 || bits == 8) && D >= 4
                    && D <= kdec::DMAX && D % 4 == 0 && D % (32 / bits) == 0
                    && gs >= 1 && D % gs == 0 && CH % gs == 0 && T > 0
                    && T % 4 == 0 && split == S;
    return ok ? 0 : (int)cudaErrorInvalidValue;
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

// q (B, H, r, D) bf16; k_codes (B, H, KDw, T); k_scale / k_mn (B, H, T/gs,
// D) bf16 or (scale_is_f32) f32, T a multiple of gs; out (B, H, r, T)
// f32.  All 16-byte aligned.
extern "C" int kivi_qk_dequant(const void* q, const void* k_codes,
                               const void* k_scale, const void* k_mn,
                               void* out, int B, int H, int r, int D, int T,
                               int gs, int bits, int n_quant,
                               int scale_is_f32, int split, void* stream) {
    if (int e = check_args(D, T, gs, bits, split)) return e;
    if (T % gs) return (int)cudaErrorInvalidValue;
    const Args a{q, (const uint32_t*)k_codes, k_scale, k_mn, (float*)out,
                 nullptr, nullptr, D, T, gs, bits, min(max(n_quant, 0), T),
                 0};
    cudaStream_t st = (cudaStream_t)stream;
    if (scale_is_f32) {
        KIVI_R_SWITCH(r, (launch_qk<RR, float>(a, B * H, st)))
    }
    KIVI_R_SWITCH(r, (launch_qk<RR, __nv_bfloat16>(a, B * H, st)))
}

// p (B, H, r, T) f32; v_codes (B, H, VDw, T); v_scale / v_mn (B, H, D/gs,
// T) bf16 or f32; out (B, H, r, D) f32; part / tickets the workspace for
// `nsplit` splits of `split` positions covering [0, n_quant), at least one.
// All 16-byte aligned.
extern "C" int kivi_pv_dequant(const void* p, const void* v_codes,
                               const void* v_scale, const void* v_mn,
                               void* out, void* part, void* tickets, int B,
                               int H, int r, int D, int T, int gs, int bits,
                               int n_quant, int scale_is_f32, int split,
                               int nsplit, void* stream) {
    const int nq = min(max(n_quant, 0), T);
    if (int e = check_args(D, T, gs, bits, split)) return e;
    if (nsplit < 1 || (long long)nsplit * S < nq
        || (nsplit - 1) * S >= max(nq, 1))
        return (int)cudaErrorInvalidValue;
    const Args a{p, (const uint32_t*)v_codes, v_scale, v_mn, (float*)out,
                 (float*)part, (int*)tickets, D, T, gs, bits, nq, 0};
    cudaStream_t st = (cudaStream_t)stream;
    if (scale_is_f32) {
        KIVI_R_SWITCH(r, (launch_pv<RR, float>(a, nsplit, B * H, st)))
    }
    KIVI_R_SWITCH(r, (launch_pv<RR, __nv_bfloat16>(a, nsplit, B * H, st)))
}

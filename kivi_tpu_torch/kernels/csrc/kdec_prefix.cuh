// The prefix pass of the shared-prefix decode route: single-token decode
// attention of every row's queries over the quantized positions that all
// rows of the batch hold bit-equal, read once per KV head, on Hopper's
// tensor cores.
//
// Replaces no TPU kernel.  The JAX package decodes a batch behind a
// fanned-out prefix through `fused_decode_attention`
// (kivi_tpu/kernels/fused_decode.py), which reads every row's copy of the
// prefix; so does row 6 (kdec_split.cuh).  Behind one long document that
// is the whole cost of a decode step: at 96 rows of a 12K-token 2-bit
// history, 8 KV heads, row 6 read ~0.9 GB a layer on the CUDA cores,
// where the prefix once is ~9 MB.  With one copy of the prefix, the
// B * r query rows of a KV head against the same positions are one
// product, which the tensor cores can run.
//
// Contract: kivi_tpu_torch/kernels/decode_prefix.py `decode_prefix_plain`.
// Queries q (B, H, r, D) bf16, folded per KV head h into Rt = B * r rows
// (row b * r + rr is q[b, h, rr]); the KIVI store of batch row 0 over
// positions [0, shared), every position below n_k_quant and n_v_quant
// (K and V both from the store); logits scaled by sm_scale and masked by
// each row's lower bound lo[b] (left pad, sliding window) where lo is
// given.  Returns the UNNORMALIZED flash state of each split, acc (H,
// nsplit, Rt, D) and (m, l) pairs (H, nsplit, Rt, 2), f32; a row that
// sees nothing in a split gives (0, -1e30, 0).  Row 6 merges them, in
// split order, with its own splits over each row's positions above
// `shared` (kdec::Params px_acc / px_ml).
//
// Rounding, as flash_extend_qhist.cu and the Pallas kernels at their
// default compute_dtype=bf16: bf16 operands, f32 accumulation; K^ = code
// * scale rounded to bf16 once, its zero point apart (q . mn added to the
// f32 logits per group row, mn split into hi + lo bf16 rows); V^ = code *
// scale + mn rounded once; p rounded to bf16 before PV.
//
// Bound on the H100: operations, at the engine's docqa shape (96 rows,
// r = 4, 8 KV heads, D = 128, 11,904 shared positions): 4 * 384 * 11904 *
// 128 per head, 18.7 GFLOP a layer, ~19 us at the bf16 tensor-core rate,
// against ~9.1 MB of store, ~3 us at 3.35 TB/s (the partials row 6 reads
// back, ~19 MB at 11 splits, ~6 us more).
//
// Design (attn_wgmma.cuh, hist_tile.cuh): blocks over (128-row query
// tiles, KV head, splits of `cps` 64-position chunks), two warpgroups of
// 64 rows a block; the host picks the split so that the grid fills the
// card in whole waves.  Each tile of a split dequantizes the split again
// (the registers of the f32 accumulators bound the rows a block holds),
// so the dequantization is hidden where it can be: the operand tiles
// (K^, V^, Z) are double-buffered, and chunk n + 1's K^ and Z are written
// while chunk n's Q K^T runs on the tensor cores, its V^ while chunk n's
// P V does; chunk n + 2's packed words and scales are in flight
// (cp.async) the while.  Row 5 (flash_extend_qhist.cu) dequantized
// between the products, with the tensor cores idle.  The splits are
// merged by row 6's last block of each (row, KV head), so the pass needs
// no merge of its own and no second launch.

#pragma once

#include <limits.h>

#include "hist_tile.cuh"
#include "kdec_split.cuh"

namespace kdec {

constexpr int PX_CK = 64;          // positions per chunk
constexpr int PX_ROWS = 128;       // query rows per block: two warpgroups
constexpr int PX_NT = hq::NT;      // 256 threads
// bytes of one operand tile set: K^ and V^ (PX_CK rows), Z (16 rows)
constexpr int PX_TILES = (2 * PX_CK + 16) * hq::DP * 2;

// Arguments of the prefix pass.  The store arrays are the cache's whole
// batch (row 0 is read); scales are ST (bf16 or f32); lo: (B,) int32 or
// NULL.  cps chunks of PX_CK positions a split, nsplit splits covering
// [0, shared), shared a multiple of PX_CK.
struct PrefixParams {
    const __nv_bfloat16* q;
    const uint32_t* k_codes;
    const void* k_scale;
    const void* k_mn;
    const uint32_t* v_codes;
    const void* v_scale;
    const void* v_mn;
    const int* lo;
    float* part_acc;
    float* part_ml;
    int B, H, r, D, Tmax, gs, k_bits, v_bits, shared, cps, nsplit;
    float sm_scale;
};

// Dynamic shared memory of a block: the query tile, two operand tile
// sets, two raw staging buffers.
inline int prefix_smem(int D, int gs, int k_bits, int v_bits, int sb) {
    const int ngk = PX_CK / gs > 1 ? PX_CK / gs : 1;
    const hq::Raw rl = hq::raw_layout<PX_CK>(
        D / (32 / k_bits), D / (32 / v_bits), ngk, D, D / gs, sb);
    return PX_ROWS * hq::DP * 2 + 2 * PX_TILES + 2 * rl.bytes;
}

// A and ROWS are those of the decode instantiation the pass feeds (the
// full body, per-row counters): every kernel of the route carries the
// name fragment `Ablation<0>, true>`, by which a profile finds row 6.
// They select nothing else.
template <typename ST, typename A, bool ROWS>
__global__ void __launch_bounds__(PX_NT, 1) prefix_kernel(
        const PrefixParams p) {
    static_assert(A::compute && A::store && ROWS,
                  "the prefix pass feeds the full decode body only");
    // the dynamic shared memory, 128-byte aligned (decode_kernel's
    // declaration in the same source asks 16 of `smem`)
    extern __shared__ __align__(128) uint8_t px_smem[];
    __shared__ int range_lo;
    constexpr int SB = sizeof(ST), CK = PX_CK, DP = hq::DP;
    uint8_t* const p_q = px_smem;
    uint8_t* const p_t = p_q + PX_ROWS * DP * 2;
    uint8_t* const p_raw = p_t + 2 * PX_TILES;
    // the operand tiles of set `buf`: K^, V^, Z
    auto t_k = [&](int buf) { return p_t + buf * PX_TILES; };
    auto t_v = [&](int buf) { return p_t + buf * PX_TILES + CK * DP * 2; };
    auto t_z = [&](int buf) {
        return p_t + buf * PX_TILES + 2 * CK * DP * 2;
    };

    const int tid = threadIdx.x, lane = tid & 31, wgi = tid >> 7;
    const int h = blockIdx.y, sp = blockIdx.z;
    const int D = p.D, Tmax = p.Tmax, r = p.r, Rt = p.B * r;
    const int row0 = blockIdx.x * PX_ROWS;
    const int s0 = sp * p.cps * CK, s1 = min(s0 + p.cps * CK, p.shared);
    const int KDw = D / (32 / p.k_bits), VDw = D / (32 / p.v_bits);
    const int gsh = __ffs(p.gs) - 1;   // gs is a power of two
    const int Tg = Tmax >> gsh, Dg = D >> gsh, ngk = max(1, CK >> gsh);
    const hq::Raw rl = hq::raw_layout<CK>(KDw, VDw, ngk, D, Dg, SB);
    const long long prow = ((long long)h * p.nsplit + sp) * Rt;

    // this thread's two rows and their lower bounds
    int row[2], rlo[2];
    bool live[2];
#pragma unroll
    for (int x = 0; x < 2; ++x) {
        row[x] = row0 + 64 * wgi + wg::frag_row(2 * x);
        live[x] = row[x] < Rt;
        rlo[x] = live[x] && p.lo ? max(p.lo[row[x] / r], 0) : 0;
    }
    if (tid == 0) range_lo = INT_MAX;
    __syncthreads();
#pragma unroll
    for (int x = 0; x < 2; ++x)
        if (live[x] && (lane & 3) == 0) atomicMin(&range_lo, rlo[x]);
    __syncthreads();
    const int c_begin = max(s0, (range_lo / CK) * CK);
    if (c_begin >= s1) {   // no row of the tile sees this split
#pragma unroll
        for (int x = 0; x < 2; ++x)
            if (live[x] && (lane & 3) == 0)
                *(float2*)(p.part_ml + 2 * (prow + row[x])) =
                    make_float2(KIVI_NEG_INF, 0.f);
        return;
    }

    // ---- raw staging of chunk c0 into buffer buf (cp.async), batch row 0
    auto stage_raw = [&](int c0, int buf) {
        hq::stage_raw<CK>(wg::smem_addr(p_raw) + buf * rl.bytes, rl,
                          p.k_codes, (const ST*)p.k_scale,
                          (const ST*)p.k_mn, p.v_codes, (const ST*)p.v_scale,
                          (const ST*)p.v_mn, (long long)h, c0, KDw, VDw, D,
                          Dg, Tmax, Tg, ngk, gsh, p.shared, p.shared);
    };
    auto dequant_kz = [&](int c0, int buf) {
        hq::dequant_kz<CK, ST>(t_k(buf), t_z(buf), p_raw + buf * rl.bytes,
                               rl, c0, p.shared, D, ngk, gsh, p.k_bits);
    };
    auto dequant_v = [&](int c0, int buf) {
        hq::dequant_vv<CK, ST>(t_v(buf), p_raw + buf * rl.bytes, rl, c0,
                               p.shared, D, gsh, p.v_bits);
    };

    // ---- the tile's query rows: row i = b * r + rr reads q[b, h, rr] ----
    const uint32_t a_q = wg::smem_addr(p_q);
    for (int idx = tid; idx < PX_ROWS * (DP / 8); idx += PX_NT) {
        const int r8 = idx & 7, cc = (idx >> 3) % (DP / 8);
        const int i = ((idx >> 3) / (DP / 8)) * 8 + r8, g = row0 + i;
        const bool ok = g < Rt && cc * 8 < D;
        const long long o =
            ok ? (((long long)(g / r) * p.H + h) * r + g % r) * D + cc * 8
               : 0;
        wg::cp16(a_q + wg::tile_off<DP>(i, cc * 8), p.q + o, ok);
    }
    // chunk c_begin's words in the Q group, the next chunk's in a second
    stage_raw(c_begin, 0);
    wg::cp_commit();
    if (c_begin + CK < s1) stage_raw(c_begin + CK, 1);
    wg::cp_commit();
    // both tile sets' columns past D stay 0
    for (int i = tid; i < 2 * PX_TILES / 16; i += PX_NT)
        *(uint4*)(p_t + 16 * i) = make_uint4(0u, 0u, 0u, 0u);
    wg::cp_wait<1>();
    __syncthreads();   // Q and chunk c_begin landed, the zeros written
    dequant_kz(c_begin, 0);
    dequant_v(c_begin, 0);
    wg::fence_async_smem();
    __syncthreads();

    const uint32_t t_q = a_q + wgi * 64 * DP * 2;
    float m[2] = {KIVI_NEG_INF, KIVI_NEG_INF}, l[2] = {0.f, 0.f};
    float o[DP / 2];
#pragma unroll
    for (int i = 0; i < DP / 2; ++i) o[i] = 0.f;

    int it = 0;
    for (int c0 = c_begin; c0 < s1; c0 += CK, ++it) {
        // chunk it's tiles are in set cur, its raw words in buffer cur;
        // chunk it + 1's raw words landed or are landing in buffer nxt
        const int cur = it & 1, nxt = cur ^ 1;
        const bool more = c0 + CK < s1;
        float s[CK / 2], z[8];
        wg::fence_regs(s);
        wg::fence_regs(z);
        wg::arrive();
        wg::qk<DP, CK>(s, t_q, wg::smem_addr(t_k(cur)));
        wg::qk<DP, 16>(z, t_q, wg::smem_addr(t_z(cur)));
        wg::commit();
        if (more) {
            // under Q K^T: chunk it + 1's words landed (everyone's), chunk
            // it + 2's staged into buffer cur (read by the last dequant),
            // chunk it + 1's K^ and Z written into set nxt (read by the
            // products of chunk it - 1, which are done)
            wg::cp_wait_all();
            __syncthreads();
            if (c0 + 2 * CK < s1) stage_raw(c0 + 2 * CK, cur);
            wg::cp_commit();
            dequant_kz(c0 + CK, nxt);
        }
        wg::wait_all();
        wg::fence_regs(s);
        wg::fence_regs(z);

        hq::add_qmn<CK>(s, z, c0, p.gs, gsh);
        auto ok = [&](int i) {
            const int x = (i >> 1) & 1;
            return c0 + wg::frag_col(i) >= rlo[x];
        };
        uint32_t pf[CK / 4];
        if (__all_sync(0xffffffffu, c0 >= max(rlo[0], rlo[1])))
            wg::softmax_step<CK, DP / 2, false>(s, ok, p.sm_scale, m, l, o,
                                                pf);
        else
            wg::softmax_step<CK, DP / 2, true>(s, ok, p.sm_scale, m, l, o,
                                               pf);

        wg::fence_regs(o);
        wg::arrive();
        wg::pv<DP, CK>(o, pf, wg::smem_addr(t_v(cur)));
        wg::commit();
        if (more) dequant_v(c0 + CK, nxt);   // under P V
        wg::wait_all();
        wg::fence_regs(o);
        wg::fence_async_smem();
        __syncthreads();   // set nxt written; set cur read by every product
    }

    float lq[2];
#pragma unroll
    for (int x = 0; x < 2; ++x) lq[x] = wg::quad_sum(l[x]);
#pragma unroll
    for (int i = 0; i < DP / 2; i += 2) {
        const int x = (i >> 1) & 1, col = wg::frag_col(i);
        if (live[x] && col < D)
            *(float2*)(p.part_acc + (prow + row[x]) * D + col) =
                make_float2(o[i], o[i + 1]);
    }
    if ((lane & 3) == 0) {
#pragma unroll
        for (int x = 0; x < 2; ++x) {
            if (!live[x]) continue;
            // nothing admitted: m may have left -1e30 by a scaled max
            *(float2*)(p.part_ml + 2 * (prow + row[x])) =
                make_float2(lq[x] > 0.f ? m[x] : KIVI_NEG_INF, lq[x]);
        }
    }
}

// What the pass takes (0 or cudaErrorInvalidValue): D <= 128 a multiple
// of 16, gs a power of two >= 8 dividing D and Tmax, bits 2/4/8, r >= 1,
// 0 < shared <= Tmax a multiple of PX_CK and gs, nsplit splits of cps
// chunks covering it.
inline int check_prefix(const PrefixParams& p) {
    const bool bits_ok = (p.k_bits == 2 || p.k_bits == 4 || p.k_bits == 8)
                         && (p.v_bits == 2 || p.v_bits == 4
                             || p.v_bits == 8);
    if (!bits_ok || p.D > hq::DP || p.D < 16 || p.D % 16 || p.gs < 8
        || (p.gs & (p.gs - 1)) || p.D % p.gs || p.Tmax % p.gs || p.r < 1
        || p.B < 1 || p.H < 1 || p.shared <= 0 || p.shared > p.Tmax
        || p.shared % PX_CK || p.shared % p.gs || p.cps < 1
        || p.nsplit < 1 || (long long)p.nsplit * p.cps * PX_CK < p.shared
        || (long long)(p.nsplit - 1) * p.cps * PX_CK >= p.shared)
        return (int)cudaErrorInvalidValue;
    return 0;
}

template <typename ST>
int launch_prefix(const PrefixParams& p, cudaStream_t stream) {
    const int smem = prefix_smem(p.D, p.gs, p.k_bits, p.v_bits,
                                 (int)sizeof(ST));
    auto kern = prefix_kernel<ST, Ablation<0>, true>;
    cudaError_t e = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return (int)e;
    dim3 grid((p.B * p.r + PX_ROWS - 1) / PX_ROWS, p.H, p.nsplit);
    kern<<<grid, PX_NT, smem, stream>>>(p);
    return (int)cudaGetLastError();
}

}  // namespace kdec

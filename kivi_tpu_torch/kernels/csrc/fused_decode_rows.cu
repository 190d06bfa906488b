// Single-token decode attention over a KIVI cache whose counters differ
// per batch row: the continuous batcher's slot caches.
//
// Replaces the TPU kernel `fused_decode_attention` of
// kivi_tpu/kernels/fused_decode.py (body `_kernel`, one program per
// (row, KV head); under the JAX batcher's vmap over slots its scalar
// counters become per-slot).  Contract:
// kivi_tpu_torch/kernels/fused_decode.py `fused_decode_attention_plain`.
//
// Bound on the H100: bytes.  Each (row, KV head) reads its own row's live
// packed K and V codes, their scale/min rows and the fp windows once: at
// 8 slots of Llama-2-7B (32 KV heads, D 128, KIVI-2, gs 32) filled to
// 1, 137, 640, 1081, 2048, 3000, 4000 and 0 tokens, about 40 MB, 12 us
// at 3.35 TB/s (chip_smoke.py computes it from the run's counters).  The
// FLOPs (4*r*D per position) are far below the card's rate.  One block
// per (row, KV head) walking its row in series left the time to the
// longest row's walk (40x the bound).
//
// The shared-prefix route (the engine's decode behind a fanned-out
// prefix): positions [0, shared) are bit-equal in every row, and the
// prefix pass (kdec_prefix.cuh, `kivi_decode_prefix` below) reads them
// once per KV head for all rows' queries.  This kernel then covers each
// row's own positions only: its splits start at `shared` (behind a
// 12,000-token document most rows' own positions fit one split, where
// splits at multiples of S would cut them in two), and the last block of
// each (row, KV head) merges the pass's partials before its own splits.
//
// Design: the split body of kdec_split.cuh (shared with fused_decode.cu),
// blocks over (t_bound / S splits, row * KV head): t_bound is Tmax, or a
// static bound on every row's fill that a replayed decode step was
// captured with (the engine's prompt + steps, the batcher's fullest
// active slot, rounded up), so the grid stops short of the empty tail.  Each block reads
// its row's (n_k_quant, n_k_win, n_v_quant) from a (B, 3) int32 device
// tensor and its lower bound from an optional (B,) one, so no counter
// passes through the host; a split outside the row's live positions
// writes the neutral partial at once, and a row with nothing live (an
// empty slot) writes exact zeros.  The counters are clamped into a
// consistent cache state (no-ops for a valid one) so that no read leaves
// the row's stores.

#include "kdec_prefix.cuh"

namespace {

template <typename ST>
int dispatch_r(int r, const kdec::Params& p, int BH, cudaStream_t st) {
    using A = kdec::Ablation<0>;
    switch (r) {
        case 1: return kdec::launch<1, ST, A, true>(p, BH, st);
        case 2: return kdec::launch<2, ST, A, true>(p, BH, st);
        case 4: return kdec::launch<4, ST, A, true>(p, BH, st);
        case 8: return kdec::launch<8, ST, A, true>(p, BH, st);
        default: return (int)cudaErrorInvalidValue;
    }
}

}  // namespace

// As kivi_fused_decode, the counters per row in counts (B, 3) int32 on
// the device; `nsplit` splits of `split` positions cover [0, t_bound),
// t_bound <= Tmax: the static fill bound of the JAX package's t_bound
// (kivi_tpu/kernels/fused_decode_wide.py:564-572).  Positions at or past
// the last split are neither read nor attended, so a row whose live
// positions all lie below t_bound gets the unbounded result; t_bound =
// Tmax is the full grid.  px_acc / px_ml: the prefix pass's partials of
// px_nsplit splits over [0, shared) (kivi_decode_prefix), or NULL with
// px_nsplit = 0 and shared = 0; the grid's splits then cover [shared,
// t_bound) (at least one) and no row attends below shared.
extern "C" int kivi_fused_decode_rows(
        const void* q, const void* k_codes, const void* k_scale,
        const void* k_mn, const void* v_codes, const void* v_scale,
        const void* v_mn, const void* k_win, const void* v_win,
        const void* counts, const void* lo, void* out, void* part_acc,
        void* part_ml, void* tickets, const void* px_acc,
        const void* px_ml, int B, int H, int r, int D, int Tmax, int W,
        int gs, int k_bits, int v_bits, int scale_is_f32, int split,
        int nsplit, int t_bound, int shared, int px_nsplit, float sm_scale,
        void* stream) {
    // the splits of [shared, t_bound), at least one, within the caller's
    // workspace of nsplit
    const int own = split > 0 && shared < t_bound
                        ? (t_bound - shared + split - 1) / split : 1;
    const kdec::Params p{
        (const __nv_bfloat16*)q, (const uint32_t*)k_codes, k_scale, k_mn,
        (const uint32_t*)v_codes, v_scale, v_mn,
        (const __nv_bfloat16*)k_win, (const __nv_bfloat16*)v_win,
        (const int*)counts, (const int*)lo, (float*)out, (float*)part_acc,
        (float*)part_ml, (int*)tickets, H, D, Tmax, W, gs, k_bits, v_bits,
        0, 0, 0, own, sm_scale, shared, (const float*)px_acc,
        (const float*)px_ml, px_nsplit};
    if (t_bound < 1 || t_bound > Tmax || shared < 0 || shared > t_bound
        || (px_acc == nullptr) != (px_ml == nullptr)
        || (px_acc == nullptr) != (px_nsplit == 0) || px_nsplit < 0
        || (px_acc == nullptr && shared != 0) || own > nsplit)
        return (int)cudaErrorInvalidValue;
    if (int e = kdec::check_args(p, split, t_bound)) return e;
    cudaStream_t st = (cudaStream_t)stream;
    return scale_is_f32 ? dispatch_r<float>(r, p, B * H, st)
                        : dispatch_r<__nv_bfloat16>(r, p, B * H, st);
}

// The prefix pass (kdec_prefix.cuh): q (B, H, r, D) bf16 and the cache's
// stores, as kivi_fused_decode_rows takes them (batch row 0 is read),
// over [0, shared); lo (B,) int32 or NULL; part_acc (H, nsplit, B * r, D)
// and part_ml (H, nsplit, B * r, 2) f32, written; nsplit splits of cps
// 64-position chunks.  All 16-byte aligned.
extern "C" int kivi_decode_prefix(
        const void* q, const void* k_codes, const void* k_scale,
        const void* k_mn, const void* v_codes, const void* v_scale,
        const void* v_mn, const void* lo, void* part_acc, void* part_ml,
        int B, int H, int r, int D, int Tmax, int gs, int k_bits, int v_bits,
        int shared, int cps, int nsplit, int scale_is_f32, float sm_scale,
        void* stream) {
    const kdec::PrefixParams p{
        (const __nv_bfloat16*)q, (const uint32_t*)k_codes, k_scale, k_mn,
        (const uint32_t*)v_codes, v_scale, v_mn, (const int*)lo,
        (float*)part_acc, (float*)part_ml, B, H, r, D, Tmax, gs, k_bits,
        v_bits, shared, cps, nsplit, sm_scale};
    if (int e = kdec::check_prefix(p)) return e;
    cudaStream_t st = (cudaStream_t)stream;
    return scale_is_f32 ? kdec::launch_prefix<float>(p, st)
                        : kdec::launch_prefix<__nv_bfloat16>(p, st);
}

// Single-token decode attention over the KIVI cache, counters uniform over
// the batch.
//
// Replaces the TPU kernel `fused_decode_attention_wide` of
// kivi_tpu/kernels/fused_decode_wide.py (body `_kernel`).  Contract:
// kivi_tpu_torch/kernels/fused_decode_wide.py
// `fused_decode_attention_wide_plain` (the split two-half softmax of
// kivi_tpu/core/attention.py:156-216).
//
// Bound on the H100: bytes.  Each (batch, KV head) reads its live packed
// K and V codes, their bf16 scale/min rows and the fp windows once; at
// the full Llama-2-7B cache (B=8, H=32, 4096 tokens, 2-bit) that is
// about 118 MB, 35 us at 3.35 TB/s.  The FLOPs (4*r*D per position) are
// far below the card's rate.  One block per (batch, KV head) walking the
// history in series kept too few bytes in flight to approach that rate
// (15x the bound at fill 1081, 28x at 32K).
//
// Design: the split body of kdec_split.cuh (shared with
// fused_decode_rows.cu and the probe trimmed.cu): blocks over
// (S-position splits of [0, n_k_quant + n_k_win), batch * KV head), each
// split's loads in flight at once by cp.async, store and window in
// separate loops, one exact softmax per split, the last block of each
// head merging the splits in order.  The counters arrive as ints, the
// same for every block; the per-row lower bound `lo` (left pad, sliding
// window) from the device, so splits wholly below a row's bound write
// the neutral partial without reading the cache.

#include "kdec_split.cuh"

namespace {

template <typename ST>
int dispatch_r(int r, const kdec::Params& p, int BH, cudaStream_t st) {
    using A = kdec::Ablation<0>;
    switch (r) {
        case 1: return kdec::launch<1, ST, A, false>(p, BH, st);
        case 2: return kdec::launch<2, ST, A, false>(p, BH, st);
        case 4: return kdec::launch<4, ST, A, false>(p, BH, st);
        case 8: return kdec::launch<8, ST, A, false>(p, BH, st);
        default: return (int)cudaErrorInvalidValue;
    }
}

}  // namespace

// q (B, H, r, D) bf16; k_codes (B, H, KDw, Tmax) and v_codes (B, H, VDw,
// Tmax) packed words; k_scale/k_mn (B, H, Tmax/gs, D) and v_scale/v_mn
// (B, H, D/gs, Tmax), bf16 or (scale_is_f32) f32; k_win/v_win (B, H, W,
// D) bf16; lo (B,) int32 or NULL; out (B, H, r, D) f32; the workspace of
// kdec::Params for `nsplit` splits of `split` positions covering
// [0, n_k_quant + n_k_win).  All 16-byte aligned.
extern "C" int kivi_fused_decode(
        const void* q, const void* k_codes, const void* k_scale,
        const void* k_mn, const void* v_codes, const void* v_scale,
        const void* v_mn, const void* k_win, const void* v_win,
        const void* lo, void* out, void* part_acc, void* part_ml,
        void* tickets, int B, int H, int r, int D, int Tmax, int W, int gs,
        int k_bits, int v_bits, int n_k_quant, int n_k_win, int n_v_quant,
        int scale_is_f32, int split, int nsplit, float sm_scale,
        void* stream) {
    const kdec::Params p{
        (const __nv_bfloat16*)q, (const uint32_t*)k_codes, k_scale, k_mn,
        (const uint32_t*)v_codes, v_scale, v_mn,
        (const __nv_bfloat16*)k_win, (const __nv_bfloat16*)v_win, nullptr,
        (const int*)lo, (float*)out, (float*)part_acc, (float*)part_ml,
        (int*)tickets, H, D, Tmax, W, gs, k_bits, v_bits, n_k_quant,
        n_k_win, n_v_quant, nsplit, sm_scale};
    if (int e = kdec::check_args(p, split, n_k_quant + n_k_win)) return e;
    cudaStream_t st = (cudaStream_t)stream;
    return scale_is_f32 ? dispatch_r<float>(r, p, B * H, st)
                        : dispatch_r<__nv_bfloat16>(r, p, B * H, st);
}

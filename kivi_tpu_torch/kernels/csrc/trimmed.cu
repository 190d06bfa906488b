// Ablation probes of the KIVI decode body: kdec::decode_kernel of
// kdec_split.cuh, the kernel of fused_decode.cu and fused_decode_rows.cu,
// under one of its ablations (kdec::Ablation, documented there), each of
// which takes out one part of the work.  Two entries:
//   * kivi_trimmed: at full fill (no fp windows, no lower bound), variants
//     0-7 at r 1, 2, 4, 8 (32 instantiations), the probe of
//     kivi_tpu_torch/profile_wide_32k.py;
//   * kivi_wide_ablate: the wide decode kernel's own launch (the
//     arguments of kivi_fused_decode: windows live, lower bound, counters)
//     under variants 5, 6 and 8-11, at r 1 and bf16 scales only (the
//     attribution driver's geometry; 4 more instantiations, 5 and 6 are
//     kivi_trimmed's), the `_ablate` names of
//     fused_decode_attention_wide (kivi_tpu/kernels/fused_decode_wide.py
//     :77-86) timed by kivi_tpu_torch/profile_attribution.py.
//
// Replaces the TPU kernel `trimmed` of scripts/profile_wide_32k.py (body
// `_kernel`), the chunk phase of kivi_tpu/kernels/fused_decode_wide.py
// under ablations.  It runs this port's row-4 kernel itself, not a copy
// of the Pallas grid: blocks over (S-position splits, batch * KV head),
// the split's loads in flight by cp.async, two positions per thread for
// QK, two channels per thread for PV, one softmax per split
// and the in-order merge of the splits by the last block of each head.
// Variant 0 is the wide decode kernel's own instantiation
// (decode_kernel<R, bf16, Ablation<0>, false>) on its grid; the launch
// passes an empty window, no lower bound and nvq = nkq.  Contracts:
// kivi_tpu_torch/kernels/trimmed.py `trimmed_plain` (kivi_trimmed) and
// kivi_tpu_torch/kernels/fused_decode_wide.py
// `fused_decode_attention_wide_plain(..., _ablate=)` (kivi_wide_ablate).
//
// Bound on the H100: bytes.  Every variant loads the live packed K and V
// codes and their bf16 scale/min rows once; at the profiler's geometry
// (B=4, 32 KV heads, 32K positions, 2-bit, group 32) about 400 MB, 0.12 ms
// at 3.35 TB/s.

#include "kdec_split.cuh"

namespace {

template <int R>
int dispatch_var(int var, const kdec::Params& p, int BH, cudaStream_t st) {
    using BF = __nv_bfloat16;
#define KIVI_V(VV)                                                       \
    case VV:                                                             \
        return kdec::launch<R, BF, kdec::Ablation<VV>, false>(p, BH, st);
    switch (var) {
        KIVI_V(0) KIVI_V(1) KIVI_V(2) KIVI_V(3)
        KIVI_V(4) KIVI_V(5) KIVI_V(6) KIVI_V(7)
        default: return (int)cudaErrorInvalidValue;
    }
#undef KIVI_V
}

int dispatch_wide(int var, const kdec::Params& p, int BH, cudaStream_t st) {
    using BF = __nv_bfloat16;
#define KIVI_V(VV)                                                       \
    case VV:                                                             \
        return kdec::launch<1, BF, kdec::Ablation<VV>, false>(p, BH, st);
    switch (var) {
        KIVI_V(5) KIVI_V(6) KIVI_V(8) KIVI_V(9) KIVI_V(10) KIVI_V(11)
        default: return (int)cudaErrorInvalidValue;
    }
#undef KIVI_V
}

}  // namespace

// q (B, H, r, D) bf16; the quantized stores of kivi_fused_decode with
// bf16 scales, n_quant positions of both live; out (B, H, r, D) f32; the
// workspace for `nsplit` splits of `split` positions covering
// [0, n_quant).
extern "C" int kivi_trimmed(const void* q, const void* k_codes,
                            const void* k_scale, const void* k_mn,
                            const void* v_codes, const void* v_scale,
                            const void* v_mn, void* out, void* part_acc,
                            void* part_ml, void* tickets, int B, int H,
                            int r, int D, int Tmax, int gs, int k_bits,
                            int v_bits, int n_quant, int variant, int split,
                            int nsplit, float sm_scale, void* stream) {
    const kdec::Params p{
        (const __nv_bfloat16*)q, (const uint32_t*)k_codes, k_scale, k_mn,
        (const uint32_t*)v_codes, v_scale, v_mn, nullptr, nullptr, nullptr,
        nullptr, (float*)out, (float*)part_acc, (float*)part_ml,
        (int*)tickets, H, D, Tmax, 0, gs, k_bits, v_bits, n_quant, 0,
        n_quant, nsplit, sm_scale};
    if (int e = kdec::check_args(p, split, n_quant)) return e;
    cudaStream_t st = (cudaStream_t)stream;
    switch (r) {
        case 1: return dispatch_var<1>(variant, p, B * H, st);
        case 2: return dispatch_var<2>(variant, p, B * H, st);
        case 4: return dispatch_var<4>(variant, p, B * H, st);
        case 8: return dispatch_var<8>(variant, p, B * H, st);
        default: return (int)cudaErrorInvalidValue;
    }
}

// The arguments of kivi_fused_decode (fused_decode.cu) with bf16 scales
// and r = 1, and the ablation `variant` (5, 6 or 8-11).
extern "C" int kivi_wide_ablate(
        const void* q, const void* k_codes, const void* k_scale,
        const void* k_mn, const void* v_codes, const void* v_scale,
        const void* v_mn, const void* k_win, const void* v_win,
        const void* lo, void* out, void* part_acc, void* part_ml,
        void* tickets, int B, int H, int r, int D, int Tmax, int W, int gs,
        int k_bits, int v_bits, int n_k_quant, int n_k_win, int n_v_quant,
        int variant, int split, int nsplit, float sm_scale, void* stream) {
    const kdec::Params p{
        (const __nv_bfloat16*)q, (const uint32_t*)k_codes, k_scale, k_mn,
        (const uint32_t*)v_codes, v_scale, v_mn,
        (const __nv_bfloat16*)k_win, (const __nv_bfloat16*)v_win, nullptr,
        (const int*)lo, (float*)out, (float*)part_acc, (float*)part_ml,
        (int*)tickets, H, D, Tmax, W, gs, k_bits, v_bits, n_k_quant,
        n_k_win, n_v_quant, nsplit, sm_scale};
    if (int e = kdec::check_args(p, split, n_k_quant + n_k_win)) return e;
    if (r != 1) return (int)cudaErrorInvalidValue;
    return dispatch_wide(variant, p, B * H, (cudaStream_t)stream);
}

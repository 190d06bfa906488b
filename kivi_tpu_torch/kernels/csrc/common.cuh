// Shared helpers for the port's CUDA kernels: the packed word layout of
// kivi_tpu_torch/core/quant.py, scalar loads of the storage types and a
// block-wide reduction (the decode kernels).  The KIVI decode body (the
// two KIVI decode kernels and, with ablations, the decode probe) is in
// kdec_split.cuh; the prefill and the two extend kernels run on the
// tensor-core tile of attn_wgmma.cuh.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math_constants.h>
#include <stdint.h>

// Finite "minus infinity" of the attention masks (never -inf: exp of a
// difference of two -inf is NaN).
#define KIVI_NEG_INF (-1e30f)

__device__ __forceinline__ float to_f(__nv_bfloat16 x) {
    return __bfloat162float(x);
}
__device__ __forceinline__ float to_f(float x) { return x; }

// Slot k of a packed word, k in [0, 32/bits): the channel it holds and
// the bit position of its code.
//   crumbs (2/4-bit): slot k = j*2 + h  ->  channel j*(2*Dw) + 2*w + h,
//                     bits [16*h + bits*j, +bits)
//   planes (8-bit):   slot k = j        ->  channel j*Dw + w, bits [8*j, +8)
__device__ __forceinline__ int slot_channel(int w, int k, int Dw, int bits) {
    if (bits == 8) return k * Dw + w;
    const int j = k >> 1, h = k & 1;
    return j * (2 * Dw) + 2 * w + h;
}
__device__ __forceinline__ int slot_shift(int k, int bits) {
    if (bits == 8) return 8 * k;
    return 16 * (k & 1) + bits * (k >> 1);
}

// Inverse map: word and bit position of channel d.
__device__ __forceinline__ void channel_slot(int d, int Dw, int bits,
                                             int* w, int* shift) {
    if (bits == 8) {
        *w = d % Dw;
        *shift = 8 * (d / Dw);
    } else {
        const int j = d / (2 * Dw), rem = d % (2 * Dw);
        *w = rem >> 1;
        *shift = 16 * (rem & 1) + bits * j;
    }
}

// Reduce R values per thread across a block of NT threads (max or sum);
// every thread gets the R results.  red: R * (NT / 32) floats of shared
// memory.  Ends with a barrier, so it also orders shared writes made
// before it.
template <int R, int NT>
__device__ __forceinline__ void block_reduce(float (&v)[R], float* red,
                                             bool is_max) {
    constexpr int NW = NT / 32;
    const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
#pragma unroll
    for (int rr = 0; rr < R; ++rr) {
        float x = v[rr];
        for (int o = 16; o > 0; o >>= 1) {
            const float y = __shfl_xor_sync(0xffffffffu, x, o);
            x = is_max ? fmaxf(x, y) : x + y;
        }
        if (lane == 0) red[rr * NW + warp] = x;
    }
    __syncthreads();
#pragma unroll
    for (int rr = 0; rr < R; ++rr) {
        float x = red[rr * NW];
        for (int w = 1; w < NW; ++w)
            x = is_max ? fmaxf(x, red[rr * NW + w]) : x + red[rr * NW + w];
        v[rr] = x;
    }
    __syncthreads();
}

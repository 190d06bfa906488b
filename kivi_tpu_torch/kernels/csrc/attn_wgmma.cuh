// Tensor-core attention tile for Hopper (sm_90a), shared by flash.cu
// (one-shot causal prefill) and flash_extend_qhist.cu (extend queries
// over the quantized history).
//
// One warpgroup (4 warps, 128 threads) owns 64 query rows.  Both products
// run on the tensor cores through `wgmma.mma_async` (inline PTX, bf16
// operands, f32 accumulators in registers):
//   * S = Q K^T: A (Q) and B (K) from shared memory, both K-major;
//   * O += P V: A (P) from registers, converted from S's accumulator
//     fragment without a trip through shared memory; B (V) from shared
//     memory read transposed (MN-major), as bf16 allows.
// Operand tiles are staged in the no-swizzle core-matrix layout (8x8
// bf16 core matrices of 128 contiguous bytes) and described to wgmma by
// hand-built 64-bit matrix descriptors (start address, leading and
// stride byte offsets, layout 0).  Copies from device memory go through
// `cp.async` (16 bytes a thread, zero-filled past the edge), so a block
// can keep the next chunk's loads in flight while it multiplies this one.
// No CUTLASS or CuTe: the layouts are the PTX ISA's canonical ones.
//
// Accumulator fragment of m64nNk16 (f32): thread t of the warpgroup (warp
// w = t/32, lane l) holds N/2 values; value i sits at
//   row 16w + l/4 + 8*((i/2)%2),  column 8*(i/4) + 2*(l%4) + i%2,
// so a thread owns two rows (h = 0, 1), shared with the other three lanes
// of its quad.  The A-operand fragment of the k-step over columns
// [16kk, 16kk+16) is the pairs (S[8kk+2x], S[8kk+2x+1]), x < 4, packed to
// bf16x2: register m of the P fragment is (S[2m], S[2m+1]).
#pragma once

#include "common.cuh"

namespace wg {

constexpr float LOG2E = 1.4426950408889634f;

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
    return (uint32_t)__cvta_generic_to_shared(p);
}

// ---------------------------------------------------------------------------
// Shared-memory tiles: rows x DP bf16 (the kernels use DP = 128) as 8x8 core
// matrices of 128 contiguous bytes (8 rows of 16 bytes), the core matrices
// of one 8-row group side by side.
// ---------------------------------------------------------------------------
template <int DP>
__device__ __forceinline__ uint32_t tile_off(int row, int col) {
    return (uint32_t)((((row >> 3) * (DP / 8) + (col >> 3)) << 7)
                      + ((row & 7) << 4) + ((col & 7) << 1));
}

// Matrix descriptor: start address >> 4 (bits 0-13), leading byte offset
// >> 4 (16-29), stride byte offset >> 4 (32-45), base offset 0, layout 0
// (no swizzle).
__device__ __forceinline__ uint64_t desc(uint32_t saddr, uint32_t lbo,
                                         uint32_t sbo) {
    return (uint64_t)((saddr & 0x3FFFF) >> 4)
           | ((uint64_t)((lbo >> 4) & 0x3FFF) << 16)
           | ((uint64_t)((sbo >> 4) & 0x3FFF) << 32);
}

// K-major operand (Q as A, K as B) of a DP-column tile: the two 8-column
// halves of a k16 step are adjacent core matrices (LBO 128 bytes), 8-row
// groups DP*16 bytes apart (SBO); k-step s starts 256*s bytes in.
template <int DP>
__device__ __forceinline__ uint64_t desc_k(uint32_t tile, int s) {
    return desc(tile + 256u * s, 128u, DP * 16u);
}

// MN-major operand (V as B, rows = keys = the K dimension): the two 8-key
// halves of a k16 step are one 8-row group apart (LBO DP*16 bytes), the
// 8-column groups of N adjacent (SBO 128 bytes); k-step s starts at key
// 16*s.
template <int DP>
__device__ __forceinline__ uint64_t desc_mn(uint32_t tile, int s) {
    return desc(tile + 32u * DP * s, DP * 16u, 128u);
}

// ---------------------------------------------------------------------------
// wgmma: fences, groups, and the products (bf16 x bf16 -> f32).
// ---------------------------------------------------------------------------
__device__ __forceinline__ void arrive() {
    asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void commit() {
    asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wait_all() {
    asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}
// Keep the compiler from moving reads or writes of registers that an
// in-flight wgmma owns across the issue and the wait.
template <int M>
__device__ __forceinline__ void fence_regs(float (&d)[M]) {
#pragma unroll
    for (int i = 0; i < M; ++i) asm volatile("" : "+f"(d[i])::"memory");
}
template <int M>
__device__ __forceinline__ void fence_regs(uint32_t (&d)[M]) {
#pragma unroll
    for (int i = 0; i < M; ++i) asm volatile("" : "+r"(d[i])::"memory");
}

// d (+)= A B over one k16 step, m64nNk16: A and B from shared memory,
// both K-major.  accumulate = 0 overwrites d.
template <int N>
__device__ __forceinline__ void mma_ss(float (&d)[N / 2], uint64_t da,
                                       uint64_t db, int accumulate);
// d (+)= A B, A from registers (4 x bf16x2), B from shared memory
// MN-major (transposed).
template <int N>
__device__ __forceinline__ void mma_rs(float (&d)[N / 2], const uint32_t* a,
                                       uint64_t db, int accumulate);

// ---- generated wrappers ----
template <>
__device__ __forceinline__ void mma_ss<16>(float (&d)[8], uint64_t da,
                                          uint64_t db, int accumulate) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %10, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n16k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7"
        "}, %8, %9, p, 1, 1, 0, 0;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
          "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7])
        : "l"(da), "l"(db), "r"(accumulate));
}

template <>
__device__ __forceinline__ void mma_ss<64>(float (&d)[32], uint64_t da,
                                          uint64_t db, int accumulate) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7,"
        "%8, %9, %10, %11, %12, %13, %14, %15,"
        "%16, %17, %18, %19, %20, %21, %22, %23,"
        "%24, %25, %26, %27, %28, %29, %30, %31"
        "}, %32, %33, p, 1, 1, 0, 0;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
          "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
          "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
          "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
          "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
          "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
          "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
          "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
        : "l"(da), "l"(db), "r"(accumulate));
}

template <>
__device__ __forceinline__ void mma_ss<128>(float (&d)[64], uint64_t da,
                                          uint64_t db, int accumulate) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7,"
        "%8, %9, %10, %11, %12, %13, %14, %15,"
        "%16, %17, %18, %19, %20, %21, %22, %23,"
        "%24, %25, %26, %27, %28, %29, %30, %31,"
        "%32, %33, %34, %35, %36, %37, %38, %39,"
        "%40, %41, %42, %43, %44, %45, %46, %47,"
        "%48, %49, %50, %51, %52, %53, %54, %55,"
        "%56, %57, %58, %59, %60, %61, %62, %63"
        "}, %64, %65, p, 1, 1, 0, 0;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
          "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
          "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
          "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
          "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
          "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
          "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
          "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
          "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
          "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
          "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
          "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
          "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
          "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
          "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
          "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
        : "l"(da), "l"(db), "r"(accumulate));
}

template <>
__device__ __forceinline__ void mma_rs<64>(float (&d)[32], const uint32_t* a,
                                          uint64_t db, int accumulate) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7,"
        "%8, %9, %10, %11, %12, %13, %14, %15,"
        "%16, %17, %18, %19, %20, %21, %22, %23,"
        "%24, %25, %26, %27, %28, %29, %30, %31"
        "}, {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
          "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
          "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
          "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
          "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
          "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
          "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
          "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db),
          "r"(accumulate));
}

template <>
__device__ __forceinline__ void mma_rs<128>(float (&d)[64], const uint32_t* a,
                                          uint64_t db, int accumulate) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7,"
        "%8, %9, %10, %11, %12, %13, %14, %15,"
        "%16, %17, %18, %19, %20, %21, %22, %23,"
        "%24, %25, %26, %27, %28, %29, %30, %31,"
        "%32, %33, %34, %35, %36, %37, %38, %39,"
        "%40, %41, %42, %43, %44, %45, %46, %47,"
        "%48, %49, %50, %51, %52, %53, %54, %55,"
        "%56, %57, %58, %59, %60, %61, %62, %63"
        "}, {%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
          "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
          "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
          "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
          "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
          "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
          "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
          "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
          "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
          "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
          "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
          "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
          "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
          "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
          "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
          "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db),
          "r"(accumulate));
}


// S = Q K^T of one warpgroup: q the smem address of its 64 rows, k that of
// N key rows, both DP-column tiles; DP/16 k-steps.
template <int DP, int N>
__device__ __forceinline__ void qk(float (&s)[N / 2], uint32_t q,
                                   uint32_t k) {
#pragma unroll
    for (int ks = 0; ks < DP / 16; ++ks)
        mma_ss<N>(s, desc_k<DP>(q, ks), desc_k<DP>(k, ks), ks > 0);
}

// O += P V: p the bf16 A fragments of a CK-key chunk (CK/4 registers), v
// the smem address of its CK x DP value tile.
template <int DP, int CK>
__device__ __forceinline__ void pv(float (&o)[DP / 2],
                                   const uint32_t (&p)[CK / 4], uint32_t v) {
#pragma unroll
    for (int kk = 0; kk < CK / 16; ++kk)
        mma_rs<DP>(o, &p[4 * kk], desc_mn<DP>(v, kk), 1);
}

// ---------------------------------------------------------------------------
// Fragment coordinates (see the header comment).
// ---------------------------------------------------------------------------
__device__ __forceinline__ int frag_row(int i) {   // row in the warpgroup
    const int t = threadIdx.x & 127;
    return 16 * (t >> 5) + ((t & 31) >> 2) + 8 * ((i >> 1) & 1);
}
__device__ __forceinline__ int frag_col(int i) {
    return 8 * (i >> 2) + 2 * (threadIdx.x & 3) + (i & 1);
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
    __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
    return *reinterpret_cast<uint32_t*>(&v);
}

__device__ __forceinline__ float fast_exp2(float x) {
    float y;
    asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
    return y;
}

__device__ __forceinline__ float quad_max(float x) {
    x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 1));
    return fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 2));
}
__device__ __forceinline__ float quad_sum(float x) {
    x += __shfl_xor_sync(0xffffffffu, x, 1);
    return x + __shfl_xor_sync(0xffffffffu, x, 2);
}

// One online-softmax step of a thread's two rows over a chunk of N keys.
// s: the chunk's raw logits (unscaled); ok(i): whether value i is
// admitted (MASK = false: all are).  m is the running max of the scaled
// logits, l the thread's partial row sum (its quad's sum is the row's: the
// caller adds the quad at the end), o the output accumulator.  On return s
// holds p and pf the bf16 A fragments of P.  p is zeroed by the mask
// itself: a row with nothing admitted so far has m == KIVI_NEG_INF, where
// exp(s - m) would be 1; such a row keeps l == 0 and o == 0.
template <int N, int M, bool MASK, typename OK>
__device__ __forceinline__ void softmax_step(float (&s)[N / 2], OK ok,
                                             float sm_scale, float (&m)[2],
                                             float (&l)[2], float (&o)[M],
                                             uint32_t (&pf)[N / 4]) {
    float rmax[2] = {KIVI_NEG_INF, KIVI_NEG_INF};
#pragma unroll
    for (int i = 0; i < N / 2; ++i) {
        const int h = (i >> 1) & 1;
        if (!MASK || ok(i)) rmax[h] = fmaxf(rmax[h], s[i]);
    }
    const float c = sm_scale * LOG2E;
    float alpha[2], mb[2], rs[2] = {0.f, 0.f};
#pragma unroll
    for (int h = 0; h < 2; ++h) {
        const float r = quad_max(rmax[h]);
        const float mn = r > KIVI_NEG_INF ? fmaxf(m[h], r * sm_scale) : m[h];
        alpha[h] = fast_exp2((m[h] - mn) * LOG2E);
        mb[h] = mn * LOG2E;
        m[h] = mn;
    }
#pragma unroll
    for (int i = 0; i < N / 2; ++i) {
        const int h = (i >> 1) & 1;
        float p = fast_exp2(fmaf(s[i], c, -mb[h]));
        if (MASK && !ok(i)) p = 0.f;
        s[i] = p;
        rs[h] += p;
    }
#pragma unroll
    for (int h = 0; h < 2; ++h) l[h] = l[h] * alpha[h] + rs[h];
#pragma unroll
    for (int i = 0; i < M; ++i) o[i] *= alpha[(i >> 1) & 1];
#pragma unroll
    for (int x = 0; x < N / 4; ++x) pf[x] = pack_bf16(s[2 * x], s[2 * x + 1]);
}

// ---------------------------------------------------------------------------
// Asynchronous copies (cp.async, 16 bytes, zero-filled when !pred).
// ---------------------------------------------------------------------------
__device__ __forceinline__ void cp16(uint32_t saddr, const void* g,
                                     bool pred) {
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                     saddr),
                 "l"(g), "r"(pred ? 16 : 0)
                 : "memory");
}
__device__ __forceinline__ void cp_commit() {
    asm volatile("cp.async.commit_group;\n" ::: "memory");
}
__device__ __forceinline__ void cp_wait_all() {
    asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}
// Wait until at most N of this thread's committed groups are pending.
template <int N>
__device__ __forceinline__ void cp_wait() {
    asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}
// Make this thread's shared-memory writes (plain stores, landed cp.async)
// visible to the async proxy wgmma reads through; a barrier follows.
__device__ __forceinline__ void fence_async_smem() {
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// Stage rows [0, rows) of a row-major (., D) bf16 matrix into a DP-column
// tile at `tile` with nthreads threads: rows >= nvalid and columns >= D are
// zero-filled.  Lanes 0-7 of a warp fill one core matrix (8 rows, one
// 16-byte column), so the shared stores do not conflict and each row's
// 64 bytes per warp stay in whole sectors.
template <int DP>
__device__ __forceinline__ void stage_rows(uint32_t tile,
                                           const __nv_bfloat16* g, int rows,
                                           int nvalid, int D, int tid,
                                           int nthreads) {
    for (int idx = tid; idx < rows * (DP / 8); idx += nthreads) {
        const int r8 = idx & 7, cc = (idx >> 3) % (DP / 8);
        const int row = ((idx >> 3) / (DP / 8)) * 8 + r8;
        const bool ok = row < nvalid && cc * 8 < D;
        cp16(tile + tile_off<DP>(row, cc * 8),
             ok ? (const void*)(g + (long long)row * D + cc * 8)
                : (const void*)g,
             ok);
    }
}

}  // namespace wg

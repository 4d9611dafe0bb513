// Hopper building blocks shared by the kernels of this directory: shared-
// memory addresses, cp.async copies into a ring of stages, ldmatrix
// fragment loads, the bf16 and int8 mma.sync tensor-core products, the
// deterministic split-K sum of a thread-block cluster (fp32 or int32
// partials), programmatic dependent launch, and the int8 requantize
// (quant_code). Every source that includes this header is rebuilt when it
// changes (kernels/build.py:library_path hashes the headers a source
// includes).
#pragma once

#include <cstdint>
#include <cooperative_groups.h>
#include <cuda_runtime.h>

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes global -> shared, asynchronous; zero-filled when !valid (the
// source is then not read).
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src,
                                           bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               ::"r"(dst), "l"(src), "r"(valid ? 16 : 0) : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
// B = 4 or 8 bytes global -> shared, asynchronous, through L1 (.ca: .cg
// takes 16 bytes only); zero-filled when !valid.
template <int B>
__device__ __forceinline__ void cp_async_ca(uint32_t dst, const void* src,
                                            bool valid) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], %2, %3;\n"
               ::"r"(dst), "l"(src), "n"(B), "r"(valid ? B : 0) : "memory");
}
template <int N> __device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// Four (x2: two) 8x8 b16 matrices; lanes 8j..8j+7 give the row addresses
// of matrix j, and lane i receives row i/4, columns 2*(i%4) and +1 of
// each (.trans: column i/4, rows 2*(i%4) and +1).
__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], uint32_t a) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3]) : "r"(a) : "memory");
}
__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4],
                                                  uint32_t a) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3]) : "r"(a) : "memory");
}
__device__ __forceinline__ void ldmatrix_x2(uint32_t (&r)[2], uint32_t a) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x2.shared.b16 {%0,%1}, [%2];\n"
      : "=r"(r[0]), "=r"(r[1]) : "r"(a) : "memory");
}

// d += a (16x16, row) * b (16x8, col): bf16 products, fp32 sums
__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// d += a (16x32, row) * b (32x8, col): int8 products, exact int32 sums. A
// register holds 4 consecutive k of one row (a) or column (b), so both
// operands are k-contiguous in shared memory and come in through plain
// ldmatrix (an 8x8 b16 matrix is 8 rows x 16 int8). No .satfinite: the
// callers' sums cannot overflow.
__device__ __forceinline__ void mma_s8(int (&d)[4], const uint32_t (&a)[4],
                                       uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// The split-K tail of a thread-block cluster. Every block holds PARTS
// partial tiles part[q][row][feature] (8 rows x TNF features) of T (fp32,
// or int32: exact in any order) in its shared memory at the same offset.
// After a cluster barrier block `rank` finishes outputs rank*NT + tid,
// + ranks*NT, ... of the tile, each summed over the blocks in rank order
// and then over the parts in order, through distributed shared memory: the
// sum is deterministic, with no atomics and no scratch tensor. out(row,
// feature, sum) stores the outputs with row < rows and feature < feats.
// The closing barrier keeps every block's shared memory alive until it
// has been read.
template <int NT, int PARTS, int TNF, typename T, typename Out>
__device__ __forceinline__ void cluster_sum(
    cooperative_groups::cluster_group& cluster, T* part, int rows,
    int feats, Out out) {
  cluster.sync();
  const int ranks = (int)cluster.num_blocks();
  const int rank = (int)cluster.block_rank();
  for (int o = rank * NT + (int)threadIdx.x; o < 8 * TNF; o += ranks * NT) {
    const int r = o / TNF, f = o % TNF;
    if (r >= rows || f >= feats) continue;
    T s = 0;
    for (int q = 0; q < ranks; ++q) {
      const T* p = cluster.map_shared_rank(part, q);
#pragma unroll
      for (int wp = 0; wp < PARTS; ++wp) s += p[(wp * 8 + r) * TNF + f];
    }
    out(r, f, s);
  }
  cluster.sync();
}

// A launch as a programmatic dependent of the stream's previous kernel
// (programmatic stream serialization): it may start while that kernel
// drains, and waits for it with griddepcontrol.wait before reading.
template <typename... Params, typename... Args_>
int launch_dependent(void (*kernel)(Params...), dim3 grid, int threads,
                     int smem, cudaStream_t st, Args_... args) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = grid;
  cfg.blockDim = dim3(threads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = st;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeProgrammaticStreamSerialization;
  attr[0].val.programmaticStreamSerializationAllowed = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return (int)cudaLaunchKernelEx(&cfg, kernel, args...);
}

// The int8 code of v, clip(rint(v / out_scale), -127, 127), with the
// quotient rounded as __fdiv_rn rounds it, but without the division where it
// cannot matter: t = v * inv (inv = 1 / out_scale, rounded) lies within 1.5
// * 2^-23 * |t| of the rounded quotient q, so where t is more than |t| *
// 2^-20 from the nearest half-integer, t and q lie on the same side of it
// and rint(t) == rint(q); nearer, the division decides. Past +-127 the code
// is +-127 either way, so t is clipped first. The rounding and the cast take
// no conversion instruction (those run at a quarter of the fp32 rate): c +
// 1.5 * 2^23 lies in [2^23, 2^24), where the float's step is 1, so the sum
// rounds c half to even and its low byte is the code in two's complement.
constexpr float QUANT_MAGIC = 12582912.f;       // 1.5 * 2^23
__device__ __forceinline__ int8_t quant_code(float v, float out_scale,
                                             float inv) {
  float c = fminf(fmaxf(__fmul_rn(v, inv), -127.f), 127.f);
  const float r = __fsub_rn(__fadd_rn(c, QUANT_MAGIC), QUANT_MAGIC);
  if (!(fabsf(__fsub_rn(c, r)) < 0.5f - fabsf(c) * 0x1p-20f))
    c = fminf(fmaxf(__fdiv_rn(v, out_scale), -127.f), 127.f);
  return (int8_t)__float_as_int(__fadd_rn(c, QUANT_MAGIC));
}

// lrn_pwl: cross-channel LRN with the paper's piecewise-linear z^-beta.
//
// Replaces the TPU kernel src/repro/kernels/lrn_pwl.py:lrn_pwl (body
// _lrn_kernel, _pwlf), both of its element types. x (B, H, W, C) fp32 or
// bf16, NHWC; y the same shape and type.
//
//   acc = x[c]^2 + sum_{d=1..n/2} (x[c+d]^2 + x[c-d]^2)   (zeros past the edges)
//   z   = k + (alpha/n) * acc
//   a   = clip((bits(z) >> shift) - base, 0, n_seg-1)      (exponent addressing)
//   y   = x * (slope[a] * z + intercept[a])
//
// Bound on an H100: device-memory bytes, one read and one write of the
// activation (a handful of flops per element).
//
// Design: one thread per element over the flattened tensor, so a warp reads
// 32 consecutive channels and the window's neighbours come from L1. The LUT
// (slope and intercept, built on the host by build_pwl_lut) sits in shared
// memory, where the data-dependent addresses of a warp do not serialise as
// they would in __constant__ memory. Every multiply and add is an explicitly
// rounded __fmul_rn/__fadd_rn, in the order the reference uses, so nvcc
// contracts nothing into an FMA and z, the LUT address and y match the
// plain version bit for bit.
//
// bf16: every value is widened to fp32 on load and the computation is the
// fp32 one, in the same order; y is rounded once to bf16 on store, as the
// JAX kernel computes in fp32 and casts on output (lrn_pwl.py:74,85).
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

__device__ __forceinline__ float widen(float v) { return v; }
__device__ __forceinline__ float widen(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
__device__ __forceinline__ void put(float* y, long long i, float v) {
  y[i] = v;
}
__device__ __forceinline__ void put(__nv_bfloat16* y, long long i, float v) {
  y[i] = __float2bfloat16_rn(v);
}

template <typename T>
__global__ void lrn_pwl_kernel(const T* __restrict__ x, T* __restrict__ y,
                               const float* __restrict__ slope,
                               const float* __restrict__ icpt, int n_seg,
                               long long total, int C, int half, float k,
                               float alpha_n, int shift, int base) {
  extern __shared__ float lut[];               // [slope | intercept]
  for (int i = threadIdx.x; i < n_seg; i += blockDim.x) {
    lut[i] = slope[i];
    lut[n_seg + i] = icpt[i];
  }
  __syncthreads();
  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
       i < total; i += stride) {
    const int c = (int)(i % C);
    const float xc = widen(x[i]);
    float acc = __fmul_rn(xc, xc);
    for (int d = 1; d <= half; ++d) {
      const float r = c + d < C ? widen(x[i + d]) : 0.f;
      acc = __fadd_rn(acc, __fmul_rn(r, r));
      const float l = c - d >= 0 ? widen(x[i - d]) : 0.f;
      acc = __fadd_rn(acc, __fmul_rn(l, l));
    }
    const float z = __fadd_rn(k, __fmul_rn(alpha_n, acc));
    int a = (__float_as_int(z) >> shift) - base;
    a = min(max(a, 0), n_seg - 1);
    put(y, i,
        __fmul_rn(xc, __fadd_rn(__fmul_rn(lut[a], z), lut[n_seg + a])));
  }
}

template <typename T>
int launch(const T* x, T* y, const float* slope, const float* icpt, int n_seg,
           long long total, int C, int n, float k, float alpha_n, int shift,
           int base, int n_blocks, void* stream) {
  const int threads = 256;
  lrn_pwl_kernel<T><<<n_blocks, threads, 2 * n_seg * sizeof(float),
                      (cudaStream_t)stream>>>(x, y, slope, icpt, n_seg, total,
                                              C, n / 2, k, alpha_n, shift,
                                              base);
  return (int)cudaGetLastError();
}

}  // namespace

// Plain C entry points (fp32 and bf16 x/y; fp32 LUT); each returns
// cudaGetLastError().
extern "C" int lrn_pwl_f32(const float* x, float* y, const float* slope,
                           const float* icpt, int n_seg, long long total,
                           int C, int n, float k, float alpha_n, int shift,
                           int base, int n_blocks, void* stream) {
  return launch(x, y, slope, icpt, n_seg, total, C, n, k, alpha_n, shift,
                base, n_blocks, stream);
}

extern "C" int lrn_pwl_bf16(const __nv_bfloat16* x, __nv_bfloat16* y,
                            const float* slope, const float* icpt, int n_seg,
                            long long total, int C, int n, float k,
                            float alpha_n, int shift, int base, int n_blocks,
                            void* stream) {
  return launch(x, y, slope, icpt, n_seg, total, C, n, k, alpha_n, shift,
                base, n_blocks, stream);
}

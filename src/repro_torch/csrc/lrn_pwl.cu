// lrn_pwl: cross-channel LRN with the paper's piecewise-linear z^-beta.
//
// Replaces the TPU kernel src/repro/kernels/lrn_pwl.py:lrn_pwl (body
// _lrn_kernel, _pwlf), both of its element types. x (B, H, W, C) fp32 or
// bf16, NHWC; y the same shape and type. A third mode, int8, replaces what
// XLA fused around that kernel in the JAX package's int8 CNN fold: int8
// codes in and out, dequantized on load and requantized on store.
//
//   acc = x[c]^2 + sum_{d=1..n/2} (x[c+d]^2 + x[c-d]^2)   (zeros past the edges)
//   z   = k + (alpha/n) * acc
//   a   = clip((bits(z) >> shift) - base, 0, n_seg-1)      (exponent addressing)
//   y   = x * (slope[a] * z + intercept[a])
//
// Bound on an H100: device-memory bytes, one read and one write of the
// activation (a handful of flops per element). The first version, one
// thread an element over a 64-bit grid-stride loop, was bound by its
// instructions instead: a 64-bit i % C, five scalar loads each behind its
// own bounds check, and a grid capped at 16 blocks an SM. At AlexNet's
// batch-8 LRNs the activation is 3-9 MB, so a launch's fixed costs weigh
// as much as its bytes.
//
// Design (vector path, C a multiple of the 16-byte vector and n <= 5): one
// thread takes one 16-byte vector of consecutive channels of one pixel (4
// fp32, 8 bf16 or 16 int8 values), with 32-bit offsets and one 32-bit
// division a vector for its place in the pixel. The squares of its +-1 and +-2
// neighbours come from the adjacent lanes (__shfl_up_sync /
// __shfl_down_sync); lanes 0 and 31 read the two channels across the
// warp's edge from memory, and the halo is zero at a pixel's first and
// last channel. The grid covers the tensor in one pass, with no loop.
// Other C or n take the scalar path: one thread an element, the old
// arithmetic on 32-bit offsets (the tensor holds fewer than 2^31
// elements, so an offset fits; the thread index is unsigned, as the last
// block may reach past 2^31). Both launch as programmatic dependents: a
// block stages the LUT, releases the next kernel and waits for the one
// before it (griddepcontrol.wait) before reading x. That overlaps an LRN
// with an LRN before it (back to back in a CUDA graph); behind conv_pipe,
// which releases no dependent early, as in the forward, it overlaps
// nothing. Two vectors a thread, blocks of 128 or 512 threads, and
// releasing the next kernel before the LUT is staged were no faster. The
// LUT (slope and intercept, built on the host by build_pwl_lut) sits in
// shared memory, where the data-dependent addresses of a warp do not
// serialise as they would in __constant__ memory. Every multiply and add
// is an explicitly rounded __fmul_rn/__fadd_rn, in the order the
// reference uses (x_c^2, + x_{c+1}^2, + x_{c-1}^2, + x_{c+2}^2,
// + x_{c-2}^2), so nvcc contracts nothing into an FMA and z, the LUT
// address and y match the plain version bit for bit.
//
// AlexNet's batch-8 LRNs on an NVIDIA H100 80GB HBM3 at 700 W, in a CUDA
// graph over at least 64 MiB of distinct inputs and outputs
// (chip_smoke.py), fp32 | bf16, behind its conv as in the forward (back
// to back): lrn1 (8x55x55x96) 0.0086 | 0.0113 ms (0.0080 | 0.0051); lrn2
// (8x27x27x256) 0.0065 | 0.0044 ms (0.0056 | 0.0037); the first version, behind
// its conv, 0.0137 | 0.0166 and 0.0089 | 0.0088 ms.
//
// bf16: every value is widened to fp32 on load and the computation is the
// fp32 one, in the same order; y is rounded once to bf16 on store, as the
// JAX kernel computes in fp32 and casts on output (lrn_pwl.py:74,85).
//
// int8 (the fixed-point fold's LRN, between two int8 conv groups): each code
// q is dequantized on load, x = __fmul_rn((float)q, x_step), the fp32
// computation runs as above, and y is requantized on store, clip(rint(y /
// y_step), -127, 127) with the quotient rounded as __fdiv_rn rounds it
// (quant_code): bit for bit quantize(lrn_pwl(dequantize(q))), the chain the
// fold ran before in about nine launches, which moved 4-byte values through
// device memory at every step (1.9 GB and 1.2 GB at AlexNet's batch-128
// LRNs against 122 MB for one pass of codes). One 16-byte vector is 16
// channels, so AlexNet's C of 96 and 256 takes the vector path. At 1 + 1
// bytes a value the bytes no longer bound it: the instructions do. A
// vector's path is about 615 SASS instructions (38 a value: the
// dequantize, the five-term window, the LUT and the requantize, none a
// conversion and a division only near a rounding tie), 0.070 ms at the
// card's issue rate for AlexNet's two batch-128 LRNs against 0.036 ms of
// bytes; timed alone (CUDA events, 4 rotating inputs) lrn1 (128x55x55x96)
// takes 0.0584 ms and lrn2 (128x27x27x256) 0.0387 ms, against 0.76 and
// 0.50 ms for the chain. A float2 LUT, a byte-permute dequantize and the
// near-tie divisions moved out of the vector's loop were no faster.
#include <cstdint>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "hopper.cuh"

namespace {

constexpr int THREADS = 256;
constexpr int MAX_HALF = 2;      // the vector path's widest window: n <= 5

// The int8 mode's steps: a code q is the value q * x; a value v has the
// code clip(rint(v / y), -127, 127). The float modes ignore them.
struct Steps {
  float x, y, y_inv;             // y_inv = 1 / y, rounded (quant_code)
};

// One value of T widened to fp32 (an int8 code dequantized), and an fp32
// value stored as T (rounded once to bf16, requantized to int8)
__device__ __forceinline__ float widen(float v, Steps) { return v; }
__device__ __forceinline__ float widen(__nv_bfloat16 v, Steps) {
  return __bfloat162float(v);
}
// (float)v as 1.5 * 2^23 + v less 1.5 * 2^23, without a conversion
// instruction (quant_code)
__device__ __forceinline__ float widen(int8_t v, Steps s) {
  const float f = __fsub_rn(__int_as_float(__float_as_int(QUANT_MAGIC) + v),
                            QUANT_MAGIC);
  return __fmul_rn(f, s.x);
}
__device__ __forceinline__ void put(float* y, int i, float v, Steps) {
  y[i] = v;
}
__device__ __forceinline__ void put(__nv_bfloat16* y, int i, float v, Steps) {
  y[i] = __float2bfloat16_rn(v);
}
__device__ __forceinline__ void put(int8_t* y, int i, float v, Steps s) {
  y[i] = quant_code(v, s.y, s.y_inv);
}

// 16 bytes of T: V values, widened to fp32 on load, rounded on store
template <typename T> struct Vec16;
template <> struct Vec16<float> {
  static constexpr int V = 4;
  __device__ static void load(const float* p, float (&f)[4], Steps) {
    const float4 t = __ldg(reinterpret_cast<const float4*>(p));
    f[0] = t.x; f[1] = t.y; f[2] = t.z; f[3] = t.w;
  }
  __device__ static void store(float* p, const float (&f)[4], Steps) {
    *reinterpret_cast<float4*>(p) = make_float4(f[0], f[1], f[2], f[3]);
  }
  // channels p[0] and p[1] (8-byte aligned)
  __device__ static void load2(const float* p, float& a, float& b, Steps) {
    const float2 t = __ldg(reinterpret_cast<const float2*>(p));
    a = t.x; b = t.y;
  }
};
template <> struct Vec16<__nv_bfloat16> {
  static constexpr int V = 8;
  __device__ static void load(const __nv_bfloat16* p, float (&f)[8], Steps) {
    const uint4 t = __ldg(reinterpret_cast<const uint4*>(p));
    const uint32_t u[4] = {t.x, t.y, t.z, t.w};
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const __nv_bfloat162 b = *reinterpret_cast<const __nv_bfloat162*>(&u[e]);
      f[2 * e] = __low2float(b);
      f[2 * e + 1] = __high2float(b);
    }
  }
  __device__ static void store(__nv_bfloat16* p, const float (&f)[8],
                               Steps) {
    uint32_t u[4];
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const __nv_bfloat162 b =
          __halves2bfloat162(__float2bfloat16_rn(f[2 * e]),
                             __float2bfloat16_rn(f[2 * e + 1]));
      u[e] = *reinterpret_cast<const uint32_t*>(&b);
    }
    *reinterpret_cast<uint4*>(p) = make_uint4(u[0], u[1], u[2], u[3]);
  }
  // channels p[0] and p[1] (4-byte aligned)
  __device__ static void load2(const __nv_bfloat16* p, float& a, float& b,
                               Steps) {
    const __nv_bfloat162 t = *reinterpret_cast<const __nv_bfloat162*>(p);
    a = __low2float(t);
    b = __high2float(t);
  }
};
template <> struct Vec16<int8_t> {
  static constexpr int V = 16;
  union Codes {
    uint4 u;
    int8_t c[16];
  };
  __device__ static void load(const int8_t* p, float (&f)[16], Steps s) {
    Codes t;
    t.u = __ldg(reinterpret_cast<const uint4*>(p));
#pragma unroll
    for (int e = 0; e < 16; ++e) f[e] = widen(t.c[e], s);
  }
  __device__ static void store(int8_t* p, const float (&f)[16], Steps s) {
    Codes t;
#pragma unroll
    for (int e = 0; e < 16; ++e) t.c[e] = quant_code(f[e], s.y, s.y_inv);
    *reinterpret_cast<uint4*>(p) = t.u;
  }
  // channels p[0] and p[1] (2-byte aligned)
  __device__ static void load2(const int8_t* p, float& a, float& b, Steps s) {
    const char2 t = __ldg(reinterpret_cast<const char2*>(p));
    a = widen((int8_t)t.x, s);
    b = widen((int8_t)t.y, s);
  }
};

// The LUT into shared memory; then let the stream's next kernel start
// launching, and wait for the kernel before this one to finish (x may be
// its output): the LUT's staging overlaps that kernel's last blocks.
__device__ __forceinline__ void stage(float* lut, const float* slope,
                                      const float* icpt, int n_seg) {
  for (int i = threadIdx.x; i < n_seg; i += blockDim.x) {
    lut[i] = slope[i];
    lut[n_seg + i] = icpt[i];
  }
  __syncthreads();
  asm volatile("griddepcontrol.launch_dependents;\n" ::: "memory");
  asm volatile("griddepcontrol.wait;\n" ::: "memory");
}

// y = x * (slope[a] * z + intercept[a]) for the window sum acc
__device__ __forceinline__ float pwl(const float* lut, int n_seg, float xc,
                                     float acc, float k, float alpha_n,
                                     int shift, int base) {
  const float z = __fadd_rn(k, __fmul_rn(alpha_n, acc));
  int a = (__float_as_int(z) >> shift) - base;
  a = min(max(a, 0), n_seg - 1);
  return __fmul_rn(xc, __fadd_rn(__fmul_rn(lut[a], z), lut[n_seg + a]));
}

// One 16-byte vector of one pixel's channels a thread (V channels); n_vec
// vectors in all, nv a pixel. A warp wholly past n_vec returns; in the
// last warp, lanes past n_vec take part in the shuffles but load and
// store nothing.
template <typename T>
__global__ void lrn_pwl_vec_kernel(const T* __restrict__ x, T* __restrict__ y,
                                   const float* __restrict__ slope,
                                   const float* __restrict__ icpt, int n_seg,
                                   int n_vec, int nv, int half, float k,
                                   float alpha_n, int shift, int base,
                                   Steps st) {
  using Vt = Vec16<T>;
  constexpr int V = Vt::V;
  extern __shared__ float lut[];               // [slope | intercept]
  stage(lut, slope, icpt, n_seg);
  const int lane = threadIdx.x % 32;
  const int g = blockIdx.x * blockDim.x + threadIdx.x;
  if (g - lane >= n_vec) return;
  const bool in = g < n_vec;
  const int cv = in ? g % nv : 0;              // its place in its pixel
  float xc[V] = {}, w[V + 4];
  if (in) Vt::load(x + g * V, xc, st);
#pragma unroll
  for (int e = 0; e < V; ++e) w[e + 2] = __fmul_rn(xc[e], xc[e]);
  // w[0..1]: the squares of channels c-2, c-1 before the vector, from the
  // lane before; w[V+2..V+3]: of c+V, c+V+1 after it, from the lane after
  w[0] = __shfl_up_sync(0xffffffffu, w[V], 1);
  w[1] = __shfl_up_sync(0xffffffffu, w[V + 1], 1);
  w[V + 2] = __shfl_down_sync(0xffffffffu, w[2], 1);
  w[V + 3] = __shfl_down_sync(0xffffffffu, w[3], 1);
  if (lane == 0 && in && cv > 0) {             // across the warp's first edge
    Vt::load2(x + g * V - 2, w[0], w[1], st);
    w[0] = __fmul_rn(w[0], w[0]);
    w[1] = __fmul_rn(w[1], w[1]);
  }
  if (lane == 31 && in && cv < nv - 1) {       // across its last edge
    Vt::load2(x + g * V + V, w[V + 2], w[V + 3], st);
    w[V + 2] = __fmul_rn(w[V + 2], w[V + 2]);
    w[V + 3] = __fmul_rn(w[V + 3], w[V + 3]);
  }
  if (cv == 0) w[0] = w[1] = 0.f;               // the pixel's first channel
  if (cv == nv - 1) w[V + 2] = w[V + 3] = 0.f;  // ... and its last
  float out[V];
#pragma unroll
  for (int e = 0; e < V; ++e) {
    float acc = w[e + 2];
    if (half >= 1) {
      acc = __fadd_rn(acc, w[e + 3]);
      acc = __fadd_rn(acc, w[e + 1]);
    }
    if (half >= 2) {
      acc = __fadd_rn(acc, w[e + 4]);
      acc = __fadd_rn(acc, w[e]);
    }
    out[e] = pwl(lut, n_seg, xc[e], acc, k, alpha_n, shift, base);
  }
  if (in) Vt::store(y + g * V, out, st);
}

// One element a thread (C not a multiple of the vector, or a wider
// window), 32-bit offsets.
template <typename T>
__global__ void lrn_pwl_kernel(const T* __restrict__ x, T* __restrict__ y,
                               const float* __restrict__ slope,
                               const float* __restrict__ icpt, int n_seg,
                               int total, int C, int half, float k,
                               float alpha_n, int shift, int base, Steps st) {
  extern __shared__ float lut[];               // [slope | intercept]
  stage(lut, slope, icpt, n_seg);
  const unsigned u = blockIdx.x * blockDim.x + threadIdx.x;
  if (u >= (unsigned)total) return;
  const int i = (int)u;
  const int c = i % C;
  const float xc = widen(x[i], st);
  float acc = __fmul_rn(xc, xc);
  for (int d = 1; d <= half; ++d) {
    const float r = c + d < C ? widen(x[i + d], st) : 0.f;
    acc = __fadd_rn(acc, __fmul_rn(r, r));
    const float l = c - d >= 0 ? widen(x[i - d], st) : 0.f;
    acc = __fadd_rn(acc, __fmul_rn(l, l));
  }
  put(y, i, pwl(lut, n_seg, xc, acc, k, alpha_n, shift, base), st);
}

// One pass over the tensor: a thread a vector where the vector path
// applies, else a thread an element.
template <typename T>
int launch(const T* x, T* y, const float* slope, const float* icpt, int n_seg,
           long long total, int C, int n, float k, float alpha_n, int shift,
           int base, Steps steps, void* stream) {
  constexpr int V = Vec16<T>::V;
  if (total < 1 || total >= (1LL << 31)) return (int)cudaErrorInvalidValue;
  const size_t lut_bytes = 2 * n_seg * sizeof(float);
  cudaStream_t st = (cudaStream_t)stream;
  const int half = n / 2;
  const bool aligned =
      ((reinterpret_cast<uintptr_t>(x) | reinterpret_cast<uintptr_t>(y)) %
       16) == 0;
  if (C % V == 0 && half <= MAX_HALF && aligned) {
    const int n_vec = (int)(total / V);
    return launch_dependent(lrn_pwl_vec_kernel<T>,
                            dim3((n_vec + THREADS - 1) / THREADS), THREADS,
                            lut_bytes, st, x, y, slope, icpt, n_seg, n_vec,
                            C / V, half, k, alpha_n, shift, base, steps);
  }
  return launch_dependent(lrn_pwl_kernel<T>,
                          dim3((unsigned)((total + THREADS - 1) / THREADS)),
                          THREADS, lut_bytes, st, x, y, slope, icpt, n_seg,
                          (int)total, C, half, k, alpha_n, shift, base,
                          steps);
}

}  // namespace

// Plain C entry points (fp32, bf16 or int8 x/y; fp32 LUT). The vector path
// takes C a multiple of 4 fp32, 8 bf16 or 16 int8 channels, n <= 5, x and y
// 16-byte aligned; anything else the scalar path. total from 1 to 2^31 - 1.
// Each returns the launch's error (or cudaErrorInvalidValue).
extern "C" int lrn_pwl_f32(const float* x, float* y, const float* slope,
                           const float* icpt, int n_seg, long long total,
                           int C, int n, float k, float alpha_n, int shift,
                           int base, void* stream) {
  return launch(x, y, slope, icpt, n_seg, total, C, n, k, alpha_n, shift,
                base, Steps{}, stream);
}

extern "C" int lrn_pwl_bf16(const __nv_bfloat16* x, __nv_bfloat16* y,
                            const float* slope, const float* icpt, int n_seg,
                            long long total, int C, int n, float k,
                            float alpha_n, int shift, int base,
                            void* stream) {
  return launch(x, y, slope, icpt, n_seg, total, C, n, k, alpha_n, shift,
                base, Steps{}, stream);
}

// int8 codes in (step x_step) and out (step y_step, positive and finite)
extern "C" int lrn_pwl_s8(const int8_t* x, int8_t* y, const float* slope,
                          const float* icpt, int n_seg, long long total,
                          int C, int n, float k, float alpha_n, int shift,
                          int base, float x_step, float y_step,
                          void* stream) {
  return launch(x, y, slope, icpt, n_seg, total, C, n, k, alpha_n, shift,
                base, Steps{x_step, y_step, 1.0f / y_step}, stream);
}

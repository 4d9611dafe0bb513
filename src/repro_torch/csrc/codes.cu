// codes: the int8 CNN fold's two passes over codes outside the fused
// kernels: the network edge's quantize (fp32 images -> int8 codes) and a
// standalone max-pool on codes (AlexNet's pool after each LRN).
//
// Replaces no TPU kernel: in the JAX package's int8 fold XLA fuses each of
// them into one pass (repro/quant/core.py:quantize, repro/kernels/ref.py:
// pool_ref under jit). Run eagerly, the port paid five launches for the
// quantize (fill, divide, round, clamp, cast: about 650 MB of traffic at
// AlexNet's batch-128 input of 79 MB) and an unfold and a strided amax
// reduce for each pool. Both are bound by device-memory bytes: one read of
// the input and one write of the codes, 79 + 20 MB for AlexNet's edge at
// batch 128 (0.030 ms at 3.35 TB/s) and 37 + 9 and 24 + 5.5 MB for its two
// pools (0.022 ms together).
//
// quantize_s8_kernel: x fp32 of any shape (elementwise), y int8 codes
// clip(rint(x / step), -127, 127), the quotient rounded as __fdiv_rn rounds
// it (quant_code), bit for bit quant/core.py:quantize with a per-tensor
// step. A thread takes 4 values: one 16-byte load, one 4-byte store, so a
// warp reads 512 contiguous bytes and writes 128, where x is 16-byte and y
// 4-byte aligned; else, and for the last partial 4, one value at a time.
//
// max_pool_s8_kernel: x int8 NHWC (B, H, W, C), VALID k x k / s windows,
// y (B, PH, PW, C). Max commutes with the int8 map, so the codes' max is
// the max's code: bit for bit pool_ref on the codes. Where C % 16 == 0 and
// x and y are 16-byte aligned a thread takes 16 channels of one output
// pixel, one 16-byte load a window position and __vmaxs4 on its four words
// of 4 codes; else one code a thread. Windows that overlap (k > s) read
// their shared rows and columns again, from L1 and L2.
//
// Timed alone at AlexNet's batch 128 on an NVIDIA H100 80GB HBM3 at 700 W
// (CUDA events, 4 rotating inputs): the edge quantize 0.0356 ms (83 % of its
// byte bound; the five launches it replaces 0.237 ms), pool1 0.0245 ms and
// pool2 0.016-0.033 ms (47-56 %; pool_ref 0.115 and 0.074 ms).
#include <cstdint>
#include <cuda_runtime.h>

#include "hopper.cuh"

namespace {

constexpr int THREADS = 256;

__global__ void quantize_s8_kernel(const float* __restrict__ x,
                                   int8_t* __restrict__ y, long long total,
                                   float step, float inv, int vec) {
  const long long i = ((long long)blockIdx.x * blockDim.x + threadIdx.x) * 4;
  if (i >= total) return;
  if (vec && i + 4 <= total) {
    const float4 v = __ldg(reinterpret_cast<const float4*>(x + i));
    const char4 q =
        make_char4(quant_code(v.x, step, inv), quant_code(v.y, step, inv),
                   quant_code(v.z, step, inv), quant_code(v.w, step, inv));
    *reinterpret_cast<char4*>(y + i) = q;
    return;
  }
  for (long long e = i; e < total && e < i + 4; ++e)
    y[e] = quant_code(x[e], step, inv);
}

// One output pixel's 16 channels a thread: n_vec = B * PH * PW * (C / 16)
__global__ void max_pool_s8_vec_kernel(const int8_t* __restrict__ x,
                                       int8_t* __restrict__ y, int n_vec,
                                       int C, int H, int W, int PH, int PW,
                                       int k, int s) {
  const int g = blockIdx.x * blockDim.x + threadIdx.x;
  if (g >= n_vec) return;
  const int cv = C / 16;
  int p = g / cv;
  const int c = (g - p * cv) * 16;
  const int ow = p % PW;
  p /= PW;
  const int oh = p % PH, b = p / PH;
  const int8_t* src = x + ((b * H + oh * s) * W + ow * s) * C + c;
  uint4 m = __ldg(reinterpret_cast<const uint4*>(src));
  for (int i = 0; i < k; ++i)
    for (int j = 0; j < k; ++j) {
      const uint4 v =
          __ldg(reinterpret_cast<const uint4*>(src + (i * W + j) * C));
      m.x = __vmaxs4(m.x, v.x);
      m.y = __vmaxs4(m.y, v.y);
      m.z = __vmaxs4(m.z, v.z);
      m.w = __vmaxs4(m.w, v.w);
    }
  *reinterpret_cast<uint4*>(y + g * 16) = m;
}

// One output code a thread: total = B * PH * PW * C
__global__ void max_pool_s8_kernel(const int8_t* __restrict__ x,
                                   int8_t* __restrict__ y, int total, int C,
                                   int H, int W, int PH, int PW, int k,
                                   int s) {
  const int g = blockIdx.x * blockDim.x + threadIdx.x;
  if (g >= total) return;
  int p = g / C;
  const int c = g - p * C;
  const int ow = p % PW;
  p /= PW;
  const int oh = p % PH, b = p / PH;
  const int8_t* src = x + ((b * H + oh * s) * W + ow * s) * C + c;
  int m = src[0];
  for (int i = 0; i < k; ++i)
    for (int j = 0; j < k; ++j) m = max(m, (int)src[(i * W + j) * C]);
  y[g] = (int8_t)m;
}

bool aligned(const void* p, int bytes) {
  return reinterpret_cast<uintptr_t>(p) % bytes == 0;
}

unsigned blocks(long long threads) {
  return (unsigned)((threads + THREADS - 1) / THREADS);
}

}  // namespace

// Plain C entry points; each returns the launch's error (or
// cudaErrorInvalidValue for what it does not take).

// y = the int8 codes of x at step (positive and finite); total >= 1.
extern "C" int quantize_s8(const float* x, int8_t* y, long long total,
                           float step, void* stream) {
  if (total < 1) return (int)cudaErrorInvalidValue;
  const int vec = aligned(x, 16) && aligned(y, 4);
  quantize_s8_kernel<<<blocks((total + 3) / 4), THREADS, 0,
                       (cudaStream_t)stream>>>(x, y, total, step,
                                               1.0f / step, vec);
  return (int)cudaGetLastError();
}

// y (B, PH, PW, C) = the k x k / s max-pool of x (B, H, W, C), VALID;
// x's elements fewer than 2^31 and PH, PW >= 1.
extern "C" int max_pool_s8(const int8_t* x, int8_t* y, int B, int H, int W,
                           int C, int k, int s, void* stream) {
  if (B < 1 || C < 1 || k < 1 || s < 1 || H < k || W < k ||
      (long long)B * H * W * C >= (1LL << 31))
    return (int)cudaErrorInvalidValue;
  const int PH = (H - k) / s + 1, PW = (W - k) / s + 1;
  cudaStream_t st = (cudaStream_t)stream;
  if (C % 16 == 0 && aligned(x, 16) && aligned(y, 16)) {
    const int n_vec = B * PH * PW * (C / 16);
    max_pool_s8_vec_kernel<<<blocks(n_vec), THREADS, 0, st>>>(
        x, y, n_vec, C, H, W, PH, PW, k, s);
  } else {
    const int total = B * PH * PW * C;
    max_pool_s8_kernel<<<blocks(total), THREADS, 0, st>>>(x, y, total, C, H,
                                                          W, PH, PW, k, s);
  }
  return (int)cudaGetLastError();
}

// matmul_pipe: y = relu?(x @ w + b), fp32 with fp32 FFMA accumulation; int8
// x and w with an int32 accumulator and a requantize epilogue; or bf16 x, w
// and b with an fp32 accumulator and bf16 y.
//
// Replaces the TPU kernel src/repro/kernels/matmul_pipe.py:matmul_pipe (body
// _matmul_kernel), all three modes. x (M, K), w (K, N), b (N,), y (M, N), all
// row-major.
//
// Bound on an H100: device-memory bytes of w. At the serving shape M is the
// micro-batch (8), so each weight element takes 2*M operations: AlexNet fc6
// reads 151 MB of fp32 weights (75 MB in bf16, 38 MB in int8) for 0.6 GOP.
//
// Design: the paper's batched-FC reuse. A block owns a slab of NCOL columns
// and MT rows of x (all of them at M <= MT), so every weight element is read
// from device memory once per call and applied to every image in registers.
// The TPU's sequential K-tile grid axis and its VMEM accumulator become a
// loop inside the block: KL lanes of threads split K, each keeps MT x 4
// partial sums, and the lanes are summed in shared memory in a fixed order
// (deterministic, no atomics). Each thread issues all its weight loads of a
// chunk before using any of them, to keep enough bytes in flight to stream
// HBM. x is staged a chunk at a time in shared memory. Ragged M, N and K
// edges are masked.
//
// fp32 mode: each thread issues KC/KL 16-byte loads (4 columns of one row)
// a chunk; the float4 path needs N % 4 == 0, else loads are scalar.
//
// int8 mode: a weight row of the thread's 4 columns is one 4-byte word, so
// to keep the fp32 mode's 128 bytes in flight a thread issues 32 word loads
// a chunk: U groups of 4 consecutive rows. Each group of 4 rows x 4 columns
// is transposed in registers with __byte_perm into 4 words of 4 k each, and
// __dp4a multiplies each with the packed x word of the same 4 k (staged
// packed in shared memory) into the int32 sums: 4 products an instruction.
// Epilogue, as the JAX kernel rounds it (matmul_pipe.py:52-63): y =
// float(acc) * scale[n], then + b[n] (two roundings, never one FMA), ReLU,
// then clip(rint(y / out_scale), -127, 127) to int8, or y itself as fp32.
//
// bf16 mode: a weight row of the thread's 4 columns is 8 bytes, so to keep
// the fp32 mode's 128 bytes in flight a thread issues 16 such loads a chunk
// (twice the fp32 mode's K per chunk). Each bf16 is widened to fp32 exactly
// (its bits moved to the top of the word) and multiplied into fp32 sums by
// FFMA; x is staged in shared memory as bf16. Epilogue, as the JAX kernel
// rounds it (matmul_pipe.py:52-63, out in x's dtype): the fp32 sum + b
// (widened), ReLU, then one rounding to bf16.
#include <cstdint>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int MT = 8;            // rows of x per block
constexpr int NCOL = 32;         // columns per block: 8 threads x float4
constexpr int KL = 32;           // K lanes
constexpr int NT = (NCOL / 4) * KL;
constexpr int KC = 256;          // K columns of x staged per chunk
constexpr int U = KC / KL;       // weight loads in flight per thread

__device__ __forceinline__ float4 load_w(const float* __restrict__ w, int k,
                                         int n, int K, int N, bool vec) {
  if (k >= K) return make_float4(0.f, 0.f, 0.f, 0.f);
  const float* row = w + (size_t)k * N;
  if (vec && n + 3 < N) return __ldg(reinterpret_cast<const float4*>(row + n));
  float v[4];
#pragma unroll
  for (int j = 0; j < 4; ++j) v[j] = n + j < N ? __ldg(row + n + j) : 0.f;
  return make_float4(v[0], v[1], v[2], v[3]);
}

__global__ void __launch_bounds__(NT)
matmul_pipe_kernel(const float* __restrict__ x, const float* __restrict__ w,
                   const float* __restrict__ b, float* __restrict__ y, int M,
                   int K, int N, int relu) {
  __shared__ float xs[MT][KC];
  __shared__ float red[KL][MT][NCOL];
  const int tx = threadIdx.x % (NCOL / 4), ty = threadIdx.x / (NCOL / 4);
  const int n = blockIdx.x * NCOL + tx * 4;
  const int m0 = blockIdx.y * MT;
  const bool vec = (N % 4) == 0;

  float acc[MT][4];
#pragma unroll
  for (int m = 0; m < MT; ++m)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[m][j] = 0.f;

  for (int k0 = 0; k0 < K; k0 += KC) {
    for (int i = threadIdx.x; i < MT * KC; i += NT) {
      const int m = i / KC, kk = i % KC;
      xs[m][kk] = (m0 + m < M && k0 + kk < K)
                      ? x[(size_t)(m0 + m) * K + k0 + kk] : 0.f;
    }
    __syncthreads();
    float4 wv[U];
#pragma unroll
    for (int u = 0; u < U; ++u) wv[u] = load_w(w, k0 + ty + u * KL, n, K, N, vec);
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int kk = ty + u * KL;
#pragma unroll
      for (int m = 0; m < MT; ++m) {
        const float xv = xs[m][kk];
        acc[m][0] = fmaf(xv, wv[u].x, acc[m][0]);
        acc[m][1] = fmaf(xv, wv[u].y, acc[m][1]);
        acc[m][2] = fmaf(xv, wv[u].z, acc[m][2]);
        acc[m][3] = fmaf(xv, wv[u].w, acc[m][3]);
      }
    }
    __syncthreads();
  }

#pragma unroll
  for (int m = 0; m < MT; ++m)
#pragma unroll
    for (int j = 0; j < 4; ++j) red[ty][m][tx * 4 + j] = acc[m][j];
  __syncthreads();
  for (int i = threadIdx.x; i < MT * NCOL; i += NT) {
    const int m = i / NCOL, c = i % NCOL;
    const int row = m0 + m, col = blockIdx.x * NCOL + c;
    if (row >= M || col >= N) continue;
    float s = 0.f;
    for (int l = 0; l < KL; ++l) s += red[l][m][c];
    s += b[col];
    if (relu) s = fmaxf(s, 0.f);
    y[(size_t)row * N + col] = s;
  }
}

// ---- int8 mode ------------------------------------------------------------

constexpr int U8 = 8;              // groups of 4 weight rows per thread
constexpr int KC8 = KL * 4 * U8;   // K columns of x staged per chunk

__device__ __forceinline__ int pack4(const int8_t (&v)[4]) {
  return (int)((uint32_t)(uint8_t)v[0] | (uint32_t)(uint8_t)v[1] << 8 |
               (uint32_t)(uint8_t)v[2] << 16 | (uint32_t)(uint8_t)v[3] << 24);
}

// columns n..n+3 of weight row k as one word (byte j = column n+j)
__device__ __forceinline__ int load_w4(const int8_t* __restrict__ w, int k,
                                       int n, int K, int N, bool vec) {
  if (k >= K) return 0;
  const int8_t* row = w + (size_t)k * N;
  if (vec && n + 3 < N) return __ldg(reinterpret_cast<const int*>(row + n));
  int8_t v[4];
#pragma unroll
  for (int j = 0; j < 4; ++j) v[j] = n + j < N ? __ldg(row + n + j) : 0;
  return pack4(v);
}

__device__ __forceinline__ void store(float* y, size_t o, float v, float) {
  y[o] = v;
}
__device__ __forceinline__ void store(int8_t* y, size_t o, float v,
                                      float out_scale) {
  const float q = rintf(__fdiv_rn(v, out_scale));
  y[o] = (int8_t)fminf(fmaxf(q, -127.f), 127.f);
}

template <typename TO>
__global__ void __launch_bounds__(NT)
matmul_pipe_s8_kernel(const int8_t* __restrict__ x,
                      const int8_t* __restrict__ w,
                      const float* __restrict__ b,
                      const float* __restrict__ scale, TO* __restrict__ y,
                      int M, int K, int N, int relu, float out_scale) {
  __shared__ int xs[MT][KC8 / 4];        // x, 4 consecutive k a word
  __shared__ int red[KL][MT][NCOL];
  const int tx = threadIdx.x % (NCOL / 4), ty = threadIdx.x / (NCOL / 4);
  const int n = blockIdx.x * NCOL + tx * 4;
  const int m0 = blockIdx.y * MT;
  const bool vec = (N % 4) == 0, xvec = (K % 4) == 0;

  int acc[MT][4];
#pragma unroll
  for (int m = 0; m < MT; ++m)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[m][j] = 0;

  for (int k0 = 0; k0 < K; k0 += KC8) {
    for (int i = threadIdx.x; i < MT * (KC8 / 4); i += NT) {
      const int m = i / (KC8 / 4), k = k0 + 4 * (i % (KC8 / 4));
      int v = 0;
      if (m0 + m < M) {
        const int8_t* row = x + (size_t)(m0 + m) * K;
        if (xvec && k < K) {
          v = *reinterpret_cast<const int*>(row + k);
        } else {
          int8_t e[4];
#pragma unroll
          for (int j = 0; j < 4; ++j) e[j] = k + j < K ? row[k + j] : 0;
          v = pack4(e);
        }
      }
      xs[m][i % (KC8 / 4)] = v;
    }
    __syncthreads();
    int r[U8][4];
#pragma unroll
    for (int u = 0; u < U8; ++u)
#pragma unroll
      for (int e = 0; e < 4; ++e)
        r[u][e] = load_w4(w, k0 + (ty + u * KL) * 4 + e, n, K, N, vec);
#pragma unroll
    for (int u = 0; u < U8; ++u) {
      // 4 rows x 4 columns -> 4 columns x 4 rows (byte e of c[j]: row e)
      const int t0 = __byte_perm(r[u][0], r[u][1], 0x5140);
      const int t1 = __byte_perm(r[u][0], r[u][1], 0x7362);
      const int t2 = __byte_perm(r[u][2], r[u][3], 0x5140);
      const int t3 = __byte_perm(r[u][2], r[u][3], 0x7362);
      const int c[4] = {__byte_perm(t0, t2, 0x5410),
                        __byte_perm(t0, t2, 0x7632),
                        __byte_perm(t1, t3, 0x5410),
                        __byte_perm(t1, t3, 0x7632)};
      const int kq = ty + u * KL;
#pragma unroll
      for (int m = 0; m < MT; ++m) {
        const int xw = xs[m][kq];
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[m][j] = __dp4a(xw, c[j], acc[m][j]);
      }
    }
    __syncthreads();
  }

#pragma unroll
  for (int m = 0; m < MT; ++m)
#pragma unroll
    for (int j = 0; j < 4; ++j) red[ty][m][tx * 4 + j] = acc[m][j];
  __syncthreads();
  for (int i = threadIdx.x; i < MT * NCOL; i += NT) {
    const int m = i / NCOL, c = i % NCOL;
    const int row = m0 + m, col = blockIdx.x * NCOL + c;
    if (row >= M || col >= N) continue;
    int s = 0;
    for (int l = 0; l < KL; ++l) s += red[l][m][c];
    float v = __fadd_rn(__fmul_rn(__int2float_rn(s), scale[col]), b[col]);
    if (relu) v = fmaxf(v, 0.f);
    store(y, (size_t)row * N + col, v, out_scale);
  }
}

// ---- bf16 mode ------------------------------------------------------------

constexpr int U16 = 16;            // 8-byte weight loads in flight a thread
constexpr int KC16 = KL * U16;     // K columns of x staged per chunk

__device__ __forceinline__ float lo(uint32_t v) {
  return __uint_as_float(v << 16);
}
__device__ __forceinline__ float hi(uint32_t v) {
  return __uint_as_float(v & 0xffff0000u);
}

// columns n..n+3 of weight row k as raw bf16 bits (uint2.x: n, n+1)
__device__ __forceinline__ uint2 load_w_bf16(
    const unsigned short* __restrict__ w, int k, int n, int K, int N,
    bool vec) {
  if (k >= K) return make_uint2(0u, 0u);
  const unsigned short* row = w + (size_t)k * N;
  if (vec && n + 3 < N) return __ldg(reinterpret_cast<const uint2*>(row + n));
  uint32_t v[4];
#pragma unroll
  for (int j = 0; j < 4; ++j) v[j] = n + j < N ? __ldg(row + n + j) : 0u;
  return make_uint2(v[0] | v[1] << 16, v[2] | v[3] << 16);
}

__global__ void __launch_bounds__(NT)
matmul_pipe_bf16_kernel(const unsigned short* __restrict__ x,
                        const unsigned short* __restrict__ w,
                        const __nv_bfloat16* __restrict__ b,
                        __nv_bfloat16* __restrict__ y, int M, int K, int N,
                        int relu) {
  __shared__ unsigned short xs[MT][KC16];
  __shared__ float red[KL][MT][NCOL];
  const int tx = threadIdx.x % (NCOL / 4), ty = threadIdx.x / (NCOL / 4);
  const int n = blockIdx.x * NCOL + tx * 4;
  const int m0 = blockIdx.y * MT;
  const bool vec = (N % 4) == 0;

  float acc[MT][4];
#pragma unroll
  for (int m = 0; m < MT; ++m)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[m][j] = 0.f;

  for (int k0 = 0; k0 < K; k0 += KC16) {
    for (int i = threadIdx.x; i < MT * KC16; i += NT) {
      const int m = i / KC16, kk = i % KC16;
      xs[m][kk] = (m0 + m < M && k0 + kk < K)
                      ? x[(size_t)(m0 + m) * K + k0 + kk] : (unsigned short)0;
    }
    __syncthreads();
    uint2 wv[U16];
#pragma unroll
    for (int u = 0; u < U16; ++u)
      wv[u] = load_w_bf16(w, k0 + ty + u * KL, n, K, N, vec);
#pragma unroll
    for (int u = 0; u < U16; ++u) {
      const int kk = ty + u * KL;
      const float w0 = lo(wv[u].x), w1 = hi(wv[u].x);
      const float w2 = lo(wv[u].y), w3 = hi(wv[u].y);
#pragma unroll
      for (int m = 0; m < MT; ++m) {
        const float xv = __uint_as_float((uint32_t)xs[m][kk] << 16);
        acc[m][0] = fmaf(xv, w0, acc[m][0]);
        acc[m][1] = fmaf(xv, w1, acc[m][1]);
        acc[m][2] = fmaf(xv, w2, acc[m][2]);
        acc[m][3] = fmaf(xv, w3, acc[m][3]);
      }
    }
    __syncthreads();
  }

#pragma unroll
  for (int m = 0; m < MT; ++m)
#pragma unroll
    for (int j = 0; j < 4; ++j) red[ty][m][tx * 4 + j] = acc[m][j];
  __syncthreads();
  for (int i = threadIdx.x; i < MT * NCOL; i += NT) {
    const int m = i / NCOL, c = i % NCOL;
    const int row = m0 + m, col = blockIdx.x * NCOL + c;
    if (row >= M || col >= N) continue;
    float s = 0.f;
    for (int l = 0; l < KL; ++l) s += red[l][m][c];
    s = __fadd_rn(s, __bfloat162float(b[col]));
    if (relu) s = fmaxf(s, 0.f);
    y[(size_t)row * N + col] = __float2bfloat16_rn(s);
  }
}

}  // namespace

// Plain C entry point; returns cudaGetLastError().
extern "C" int matmul_pipe_f32(const float* x, const float* w, const float* b,
                               float* y, int M, int K, int N, int relu,
                               void* stream) {
  dim3 grid((N + NCOL - 1) / NCOL, (M + MT - 1) / MT);
  matmul_pipe_kernel<<<grid, NT, 0, (cudaStream_t)stream>>>(x, w, b, y, M, K,
                                                            N, relu);
  return (int)cudaGetLastError();
}

// int8 x and w, fp32 b and scale (N,) = s_x * s_w[n]. out_s8: the output is
// int8 quantized by out_scale, else fp32. Returns cudaGetLastError().
extern "C" int matmul_pipe_s8(const int8_t* x, const int8_t* w, const float* b,
                              const float* scale, void* y, int out_s8,
                              float out_scale, int M, int K, int N, int relu,
                              void* stream) {
  dim3 grid((N + NCOL - 1) / NCOL, (M + MT - 1) / MT);
  if (out_s8)
    matmul_pipe_s8_kernel<int8_t><<<grid, NT, 0, (cudaStream_t)stream>>>(
        x, w, b, scale, (int8_t*)y, M, K, N, relu, out_scale);
  else
    matmul_pipe_s8_kernel<float><<<grid, NT, 0, (cudaStream_t)stream>>>(
        x, w, b, scale, (float*)y, M, K, N, relu, out_scale);
  return (int)cudaGetLastError();
}

// bf16 x, w, b and y; fp32 accumulation, one rounding. Returns
// cudaGetLastError().
extern "C" int matmul_pipe_bf16(const __nv_bfloat16* x, const __nv_bfloat16* w,
                                const __nv_bfloat16* b, __nv_bfloat16* y,
                                int M, int K, int N, int relu, void* stream) {
  dim3 grid((N + NCOL - 1) / NCOL, (M + MT - 1) / MT);
  matmul_pipe_bf16_kernel<<<grid, NT, 0, (cudaStream_t)stream>>>(
      reinterpret_cast<const unsigned short*>(x),
      reinterpret_cast<const unsigned short*>(w), b, y, M, K, N, relu);
  return (int)cudaGetLastError();
}

// matmul_pipe: y = relu?(x @ w + b), fp32 with fp32 FFMA accumulation.
//
// Replaces the TPU kernel src/repro/kernels/matmul_pipe.py:matmul_pipe (body
// _matmul_kernel), fp32 mode. x (M, K), w (K, N), b (N,), y (M, N), all
// row-major.
//
// Bound on an H100: device-memory bytes of w. At the serving shape M is the
// micro-batch (8), so each weight element takes 2*M flops: AlexNet fc6 reads
// 151 MB of weights for 0.6 GFLOP.
//
// Design: the paper's batched-FC reuse. A block owns a slab of NCOL columns
// and MT rows of x (all of them at M <= MT), so every weight element is read
// from device memory once per call and applied to every image in registers.
// The TPU's sequential K-tile grid axis and its VMEM accumulator become a
// loop inside the block: KL lanes of threads split K, each keeps MT x 4
// partial sums, and the lanes are summed in shared memory in a fixed order
// (deterministic, no atomics). Each thread issues KC/KL 16-byte weight loads
// before using any of them, to keep enough bytes in flight to stream HBM.
// x is staged KC columns at a time in shared memory. Ragged M, N and K edges
// are masked; the float4 path needs N % 4 == 0, else loads are scalar.
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

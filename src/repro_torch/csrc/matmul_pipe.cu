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
// fp32 and int8 design: the paper's batched-FC reuse. A block owns a slab
// of NCOL columns and MT rows of x (all of them at M <= MT), so every
// weight element is read from device memory once per call and applied to
// every image in registers.
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
// bf16 mode (matmul_bf16_kernel<TNF>): a split-K weight stream on the
// tensor cores. At batch 8 each weight is used for 16 operations, so only
// the bytes of w count: 205 MB at VGG-16 fc6, 61 us at 3.35 TB/s. The
// product is taken transposed, y^T = w^T x^T, with mma.sync.m16n8k16: A is
// a 16-feature x 16-k slab of w, read from w's [k][n] layout by
// ldmatrix.trans; B is x^T, whose column-major layout is x's row-major
// one, read by plain ldmatrix; the 8 images of a micro-batch fill the
// mma's n = 8 exactly (more rows of x take more grid rows, 8 at a time,
// zero-filled past M). A block of 4 warps owns TNF (64 or 32) output
// features; the `ranks` blocks of a thread-block cluster (at most 8, the
// portable size) share those features and split the reduction into ranges
// of BKW-wide chunks, chosen by the wrapper (kernels/matmul_pipe.py:
// fc_split) so that fc6 and fc7 give at least two blocks an SM and fc8
// every SM a block. w and x chunks stream through a 4-stage cp.async ring
// (16-byte vectors of 8 features or 8 k; N % 8 != 0 or K % 8 != 0 take an
// element path into the same layout, and the last feature tile is masked),
// one __syncthreads a chunk; each warp multiplies its 16-k slice of the
// chunk. At the end each block stages its warps' fp32 partial tiles in its
// shared memory, and after a cluster barrier block r sums a share of the
// outputs over every block's and warp's partial through distributed shared
// memory, in rank order and then warp order: the sum is deterministic, with
// no scratch tensor and no atomics. Epilogue, as the JAX kernel rounds it
// (matmul_pipe.py:52-63, out in x's dtype): the fp32 sum + b (widened,
// __fadd_rn), ReLU, then one rounding to bf16. The kernel's dynamic
// shared memory limit is raised once, at its first launch; a refused
// cluster launch is returned as the error.
#include <cstdint>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <cooperative_groups.h>

#include "hopper.cuh"

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

constexpr int NTW = 128;          // threads per block: 4 warps
constexpr int BKW = 64;           // reduction chunk: a 16-k slice a warp
constexpr int STAGES_W = 4;       // cp.async ring depth
constexpr int LDX = BKW + 8;      // x row stride in bf16: 144 B, so the 8
                                  // rows of an ldmatrix hit distinct banks

// The geometry of one block: TNF features, 4 warps.
template <int TNF> struct FcTile {
  static constexpr int MI = TNF / 16;           // mma row tiles a warp
  static constexpr int LDW = TNF + 8;           // w row stride in bf16
  static constexpr int W_STAGE = BKW * LDW;     // bf16 elements
  static constexpr int STAGE = W_STAGE + 8 * LDX;
  static constexpr int SMEM = STAGES_W * STAGE * 2;          // bytes
  static constexpr int PART = NTW / 32 * 8 * TNF;            // fp32 partials
  static_assert(MI >= 1 && BKW == NTW / 32 * 16, "a 16-k slice a warp");
  static_assert(PART * 4 <= SMEM, "the partials fit the ring's memory");
  static_assert(BKW * TNF / 8 % NTW == 0 && 8 * BKW / 8 <= NTW,
                "whole 16-byte vectors a thread");
};

// wvec: w's 16-byte vectors hold 8 features (N % 8 == 0); xvec: x's hold 8
// k (K % 8 == 0); both need 16-byte aligned bases (the wrapper checks).
template <int TNF>
__global__ void __launch_bounds__(NTW)
matmul_bf16_kernel(const __nv_bfloat16* __restrict__ x,
                   const __nv_bfloat16* __restrict__ w,
                   const __nv_bfloat16* __restrict__ b,
                   __nv_bfloat16* __restrict__ y, int M, int K, int N,
                   int relu, int wvec, int xvec) {
  using Tl = FcTile<TNF>;
  constexpr int LDW = Tl::LDW;
  namespace cg = cooperative_groups;
  cg::cluster_group cluster = cg::this_cluster();
  const int ranks = (int)cluster.num_blocks();
  const int rank = (int)cluster.block_rank();
  extern __shared__ __align__(16) unsigned char smem[];
  __nv_bfloat16* const ring = reinterpret_cast<__nv_bfloat16*>(smem);

  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  const int n0 = blockIdx.x / ranks * TNF;      // the cluster's features
  const int m0 = blockIdx.z * 8;                // its 8 rows of x
  const int nk = (K + BKW - 1) / BKW;           // this rank's chunks:
  const int c0 = rank * nk / ranks, c1 = (rank + 1) * nk / ranks;

  // Fill ring stage `st` with chunk c: w rows [k0, k0+BKW) x the block's
  // features, and x rows m0..m0+7 x the same k.
  auto load_stage = [&](int st, int c) {
    __nv_bfloat16* const Ws = ring + st * Tl::STAGE;
    __nv_bfloat16* const Xs = Ws + Tl::W_STAGE;
    const int k0 = c * BKW;
    if (wvec) {
#pragma unroll
      for (int i = 0; i < BKW * TNF / 8 / NTW; ++i) {
        const int v = tid + NTW * i, kr = v / (TNF / 8), n = v % (TNF / 8) * 8;
        const bool ok = k0 + kr < K && n0 + n < N;
        const __nv_bfloat16* src = ok ? w + (size_t)(k0 + kr) * N + n0 + n : w;
        cp_async16(smem_u32(Ws + kr * LDW + n), src, ok);
      }
    } else {
#pragma unroll 4
      for (int i = 0; i < BKW * TNF / NTW; ++i) {
        const int n = tid % TNF, kr = tid / TNF + NTW / TNF * i;
        Ws[kr * LDW + n] = k0 + kr < K && n0 + n < N
                               ? w[(size_t)(k0 + kr) * N + n0 + n]
                               : __ushort_as_bfloat16((unsigned short)0);
      }
    }
    if (xvec) {
      if (tid < 8 * BKW / 8) {
        const int r = tid / (BKW / 8), kk = tid % (BKW / 8) * 8;
        const bool ok = m0 + r < M && k0 + kk < K;
        const __nv_bfloat16* src = ok ? x + (size_t)(m0 + r) * K + k0 + kk : x;
        cp_async16(smem_u32(Xs + r * LDX + kk), src, ok);
      }
    } else {
#pragma unroll
      for (int i = 0; i < 8 * BKW / NTW; ++i) {
        const int kk = tid % BKW, r = tid / BKW + NTW / BKW * i;
        Xs[r * LDX + kk] = m0 + r < M && k0 + kk < K
                               ? x[(size_t)(m0 + r) * K + k0 + kk]
                               : __ushort_as_bfloat16((unsigned short)0);
      }
    }
  };

  float acc[Tl::MI][4];
#pragma unroll
  for (int i = 0; i < Tl::MI; ++i)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[i][e] = 0.f;

  const int n_own = c1 - c0;
#pragma unroll
  for (int s = 0; s < STAGES_W - 1; ++s) {
    if (s < n_own) load_stage(s, c0 + s);
    cp_async_commit();
  }
  // this lane's ldmatrix rows: A (w, .trans) k rows lane%8 (+8 for lanes
  // 16-31) at features +8 for lanes 8-15 and 24-31; B (x) rows lane%8 at k
  // +8 for lanes 8-15
  const int ks = warp * 16;
  const int a_off = (ks + lane % 8 + lane / 16 * 8) * LDW + lane / 8 % 2 * 8;
  const int b_off = lane % 8 * LDX + ks + lane / 8 % 2 * 8;
  for (int t = 0; t < n_own; ++t) {
    cp_async_wait<STAGES_W - 2>();  // chunk t has landed (this thread's)
    __syncthreads();                // ... everyone's; stage t-1 is free
    const int nxt = t + STAGES_W - 1;
    if (nxt < n_own) load_stage(nxt % STAGES_W, c0 + nxt);
    cp_async_commit();
    const __nv_bfloat16* Ws = ring + t % STAGES_W * Tl::STAGE;
    const __nv_bfloat16* Xs = Ws + Tl::W_STAGE;
    uint32_t bx[2];
    ldmatrix_x2(bx, smem_u32(Xs + b_off));
#pragma unroll
    for (int i = 0; i < Tl::MI; ++i) {
      uint32_t a[4];
      ldmatrix_x4_trans(a, smem_u32(Ws + a_off + i * 16));
      mma_bf16(acc[i], a, bx[0], bx[1]);
    }
  }
  cp_async_wait<0>();
  __syncthreads();                  // the ring is free for the partials

  // this warp's partial tile, part[warp][row of x][feature] (a lane holds
  // features lane/4 and +8, rows 2*(lane%4) and +1 of each mma tile)
  float* const part = reinterpret_cast<float*>(smem);
#pragma unroll
  for (int i = 0; i < Tl::MI; ++i)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int f = i * 16 + lane / 4 + e / 2 * 8, r = lane % 4 * 2 + e % 2;
      part[(warp * 8 + r) * TNF + f] = acc[i][e];
    }
  cluster.sync();                   // every block's partials are visible

  // block `rank` finishes outputs rank, rank + ranks, ... of the 8 x TNF
  // tile: the partials summed over ranks, then warps, in that order
  for (int o = rank * NTW + tid; o < 8 * TNF; o += ranks * NTW) {
    const int r = o / TNF, f = o % TNF;
    if (m0 + r >= M || n0 + f >= N) continue;
    float s = 0.f;
    for (int q = 0; q < ranks; ++q) {
      const float* p = cluster.map_shared_rank(part, q);
#pragma unroll
      for (int wp = 0; wp < NTW / 32; ++wp) s += p[(wp * 8 + r) * TNF + f];
    }
    s = __fadd_rn(s, __bfloat162float(b[n0 + f]));
    if (relu) s = fmaxf(s, 0.f);
    y[(size_t)(m0 + r) * N + n0 + f] = __float2bfloat16_rn(s);
  }
  cluster.sync();                   // no block leaves while read
}

// One bf16 launch: TNF features a cluster of `ranks` blocks.
template <int TNF>
int launch_bf16(const __nv_bfloat16* x, const __nv_bfloat16* w,
                const __nv_bfloat16* b, __nv_bfloat16* y, int M, int K, int N,
                int relu, int ranks, void* stream) {
  constexpr int smem = FcTile<TNF>::SMEM;
  static const cudaError_t attr = cudaFuncSetAttribute(
      matmul_bf16_kernel<TNF>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      smem);
  if (attr != cudaSuccess) return (int)attr;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((N + TNF - 1) / TNF * ranks, 1, (M + 7) / 8);
  cfg.blockDim = dim3(NTW);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = (cudaStream_t)stream;
  cudaLaunchAttribute cluster[1];
  cluster[0].id = cudaLaunchAttributeClusterDimension;
  cluster[0].val.clusterDim.x = ranks;
  cluster[0].val.clusterDim.y = 1;
  cluster[0].val.clusterDim.z = 1;
  cfg.attrs = cluster;
  cfg.numAttrs = 1;
  const cudaError_t e = cudaLaunchKernelEx(
      &cfg, matmul_bf16_kernel<TNF>, x, w, b, y, M, K, N, relu,
      (int)(N % 8 == 0), (int)(K % 8 == 0));
  return e != cudaSuccess ? (int)e : (int)cudaGetLastError();
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

// bf16 x, w, b and y on the tensor cores; fp32 accumulation, one rounding.
// (tnf, ranks): the features a cluster (64 or 32) and its blocks (1 to 8),
// which split K. Returns the launch's error, else cudaGetLastError().
extern "C" int matmul_pipe_bf16(const __nv_bfloat16* x, const __nv_bfloat16* w,
                                const __nv_bfloat16* b, __nv_bfloat16* y,
                                int M, int K, int N, int relu, int tnf,
                                int ranks, void* stream) {
  if (ranks < 1 || ranks > 8) return (int)cudaErrorInvalidValue;
  if (tnf == 64)
    return launch_bf16<64>(x, w, b, y, M, K, N, relu, ranks, stream);
  if (tnf == 32)
    return launch_bf16<32>(x, w, b, y, M, K, N, relu, ranks, stream);
  return (int)cudaErrorInvalidValue;
}

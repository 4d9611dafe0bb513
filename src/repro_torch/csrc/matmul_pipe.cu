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
// Design, every mode: a split-K weight stream over a thread-block
// cluster, the paper's batched-FC reuse. A block of 4 warps owns TNF output
// features and 8 rows of x, so every weight element is read from device
// memory once per call and applied to all 8 images (more rows of x take
// more grid rows, 8 at a time, zero-filled past M). The `ranks` blocks of a
// cluster (at most 8, the portable size) share those features and split
// the reduction into ranges of chunks, chosen by the wrapper (kernels/
// matmul_pipe.py:fc_split, one rule a mode) so that every SM holds enough
// blocks to keep megabytes of w in flight. w and x chunks stream through a
// 4-stage cp.async ring (16-byte vectors; N or K not a multiple of the
// vector take an element path into the same layout, and the last feature
// tile is masked), one __syncthreads a chunk. At the end each block stages
// its warps' partial tiles (fp32; int32 in int8) in its shared memory,
// and the cluster sums them through distributed shared memory in rank
// order and then warp order (hopper.cuh:cluster_sum): deterministic, with
// no scratch tensor and no atomics. Float epilogue, as the JAX kernel
// rounds it (matmul_pipe.py:52-63): the fp32 sum + b (__fadd_rn), ReLU,
// out in x's dtype. The kernels' dynamic shared memory limit is raised
// once, at their first launch; a refused cluster launch is returned as the
// error.
//
// fp32 (matmul_f32_kernel<TNF>, TNF 128, 64 or 32): FFMA on the CUDA cores
// (TF32 would break the reference's 1e-4). A thread owns 4 features x 4 k of
// every chunk: TNF/4 feature groups x 128/(TNF/4) k lanes, so a chunk is
// 2048/TNF k deep and 8 KB of w whatever TNF. Per chunk it reads its 4 w
// rows (one 16-byte shared load each) and its 4 k of all 8 x rows (8 more)
// and does 128 FFMA into 8 rows x 4 features of fp32 sums: each weight is
// read once and used 8 times. The k lanes of a warp are folded by shuffles
// (a + b is b + a, so the fold is deterministic) before the cluster sum.
//
// bf16 (matmul_bf16_kernel<TNF>, TNF 64 or 32): the tensor cores. At batch
// 8 each weight is used for 16 operations, so only the bytes of w count:
// 205 MB at VGG-16 fc6, 61 us at 3.35 TB/s. The product is taken
// transposed, y^T = w^T x^T, with mma.sync.m16n8k16: A is a 16-feature x
// 16-k slab of w, read from w's [k][n] layout by ldmatrix.trans; B is x^T,
// whose column-major layout is x's row-major one, read by plain ldmatrix;
// the 8 images of a micro-batch fill the mma's n = 8 exactly. Chunks are 64
// k, 16 a warp; the epilogue rounds once to bf16.
//
// int8 (matmul_s8_kernel<TNF, TO>, TNF 128 or 32; TO int8 or fp32 out):
// the same stream at 1 byte a weight, so the bound is 103 MB of w at
// VGG-16 fc6, 31 us at 3.35 TB/s. The products run on the int8 tensor
// cores (mma.sync.m16n8k32, exact int32 sums), y^T = w^T x^T as in bf16:
// B is x^T, whose k-contiguous rows a lane reads as words; A is w^T, which
// the .row.col int8 mma wants k-contiguous too while w lies [k][n]. No
// transposed copy and no trip back through shared memory: the mma's rows
// and its k order are free to name, so a lane takes 4 or 8 features (its
// mma rows g and g + 8, two mmas a 4-feature group) x k quads t and t + 4
// of a 32-k slab, loads each of those 8 w rows' bytes with one shared
// load, and turns every 4x4 byte block into 4 words of 4 k with six
// __byte_perm: a 1 KB slab of w costs a warp 8 loads, 12-24 byte permutes
// and 2 x words a lane for 2-4 mma. __dp4a, tried first on the same
// stream, was compute-bound: a chunk's 16,384 IDP.4A took about 1000
// clocks an SM on the H100, which caps it near 63 % of the byte bound. A
// chunk is 8192/TNF k deep (8 KB of w whatever TNF); the 4 warps split its
// 32-k slabs (and at TNF 128 its two 64-feature sets). With the products
// off the critical path a block streams some 17 GB/s whatever its tile or
// ring depth (8 stages measured no faster than 4), so the split sets the
// rate: fc_split's int8 rule spreads about 1.4 blocks an SM (128 features
// x 6 ranks at fc6 and fc7). N or K not a multiple of 16 take 8- or 4-byte
// cp.async vectors, or bytes. Each warp stages its int32 partial tile
// (zero outside its features) and the cluster sums them in rank and warp
// order (cluster_sum<int>): integer sums are exact, so every split gives
// the same bits. Epilogue, as the JAX kernel rounds it (matmul_pipe.py:
// 52-63): y = float(acc) * scale[n], then + b[n] (__fmul_rn, __fadd_rn:
// two roundings, never one FMA), ReLU, then clip(rint(y / out_scale),
// -127, 127) to int8 (__fdiv_rn), or y as fp32.
#include <cstdint>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <cooperative_groups.h>

#include "hopper.cuh"

namespace {

namespace cg = cooperative_groups;

// ---- split-K streams over a cluster ----------------------------------------

constexpr int NTW = 128;          // threads per block: 4 warps
constexpr int STAGES_W = 4;       // cp.async ring depth
// bf16
constexpr int BKW = 64;           // reduction chunk: a 16-k slice a warp
constexpr int LDX = BKW + 8;      // x row stride in bf16: 144 B, so the 8
                                  // rows of an ldmatrix hit distinct banks

// The geometry of one bf16 block: TNF features, 4 warps.
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
  cluster_sum<NTW, NTW / 32, TNF>(
      cluster, part, M - m0, N - n0, [&](int r, int f, float s) {
        s = __fadd_rn(s, __bfloat162float(b[n0 + f]));
        if (relu) s = fmaxf(s, 0.f);
        y[(size_t)(m0 + r) * N + n0 + f] = __float2bfloat16_rn(s);
      });
}

// fp32: the same stream on FFMA

// The geometry of one fp32 block: TNF features, 4 warps, a thread 4
// features x 4 k of each chunk.
template <int TNF> struct FcF32Tile {
  static constexpr int FG = TNF / 4;            // feature groups
  static constexpr int KLF = NTW / FG;          // k lanes
  static constexpr int BK = KLF * 4;            // chunk depth: 8 KB of w
  static constexpr int LDW = TNF + 4;           // w row stride in floats
  static constexpr int LDX = BK + 4;            // x row stride in floats
  static constexpr int W_STAGE = BK * LDW;      // floats
  static constexpr int STAGE = W_STAGE + 8 * LDX;
  static constexpr int SMEM = STAGES_W * STAGE * 4;          // bytes
  static constexpr int PART = NTW / 32 * 8 * TNF;            // fp32 partials
  static_assert(32 % FG == 0 && BK <= NTW, "whole k lanes a warp");
  static_assert(PART * 4 <= SMEM, "the partials fit the ring's memory");
  static_assert(BK * TNF / 4 % NTW == 0 && 8 * BK / 4 <= NTW &&
                    8 * BK % NTW == 0,
                "whole 16-byte vectors a thread");
};

// wvec: w's 16-byte vectors hold 4 features (N % 4 == 0); xvec: x's hold 4
// k (K % 4 == 0); both need 16-byte aligned bases (the wrapper checks).
template <int TNF>
__global__ void __launch_bounds__(NTW)
matmul_f32_kernel(const float* __restrict__ x, const float* __restrict__ w,
                  const float* __restrict__ b, float* __restrict__ y, int M,
                  int K, int N, int relu, int wvec, int xvec) {
  using Tl = FcF32Tile<TNF>;
  constexpr int BK = Tl::BK, LDW = Tl::LDW, LDX = Tl::LDX, FG = Tl::FG;
  cg::cluster_group cluster = cg::this_cluster();
  const int ranks = (int)cluster.num_blocks();
  const int rank = (int)cluster.block_rank();
  extern __shared__ __align__(16) unsigned char smem[];
  float* const ring = reinterpret_cast<float*>(smem);

  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  const int n0 = blockIdx.x / ranks * TNF;      // the cluster's features
  const int m0 = blockIdx.z * 8;                // its 8 rows of x
  const int nk = (K + BK - 1) / BK;             // this rank's chunks:
  const int c0 = rank * nk / ranks, c1 = (rank + 1) * nk / ranks;

  // Fill ring stage `st` with chunk c: w rows [k0, k0+BK) x the block's
  // features, and x rows m0..m0+7 x the same k.
  auto load_stage = [&](int st, int c) {
    float* const Ws = ring + st * Tl::STAGE;
    float* const Xs = Ws + Tl::W_STAGE;
    const int k0 = c * BK;
    if (wvec) {
#pragma unroll
      for (int i = 0; i < BK * TNF / 4 / NTW; ++i) {
        const int v = tid + NTW * i, kr = v / FG, n = v % FG * 4;
        const bool ok = k0 + kr < K && n0 + n < N;
        const float* src = ok ? w + (size_t)(k0 + kr) * N + n0 + n : w;
        cp_async16(smem_u32(Ws + kr * LDW + n), src, ok);
      }
    } else {
#pragma unroll 4
      for (int i = 0; i < BK * TNF / NTW; ++i) {
        const int n = tid % TNF, kr = tid / TNF + NTW / TNF * i;
        Ws[kr * LDW + n] = k0 + kr < K && n0 + n < N
                               ? w[(size_t)(k0 + kr) * N + n0 + n] : 0.f;
      }
    }
    if (xvec) {
      if (tid < 8 * BK / 4) {
        const int r = tid / (BK / 4), kk = tid % (BK / 4) * 4;
        const bool ok = m0 + r < M && k0 + kk < K;
        const float* src = ok ? x + (size_t)(m0 + r) * K + k0 + kk : x;
        cp_async16(smem_u32(Xs + r * LDX + kk), src, ok);
      }
    } else {
#pragma unroll
      for (int i = 0; i < 8 * BK / NTW; ++i) {
        const int kk = tid % BK, r = tid / BK + NTW / BK * i;
        Xs[r * LDX + kk] = m0 + r < M && k0 + kk < K
                               ? x[(size_t)(m0 + r) * K + k0 + kk] : 0.f;
      }
    }
  };

  float acc[8][4];
#pragma unroll
  for (int r = 0; r < 8; ++r)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[r][j] = 0.f;

  const int n_own = c1 - c0;
#pragma unroll
  for (int s = 0; s < STAGES_W - 1; ++s) {
    if (s < n_own) load_stage(s, c0 + s);
    cp_async_commit();
  }
  const int fg = tid % FG, kl = tid / FG;       // 4 features x 4 k
  for (int t = 0; t < n_own; ++t) {
    cp_async_wait<STAGES_W - 2>();  // chunk t has landed (this thread's)
    __syncthreads();                // ... everyone's; stage t-1 is free
    const int nxt = t + STAGES_W - 1;
    if (nxt < n_own) load_stage(nxt % STAGES_W, c0 + nxt);
    cp_async_commit();
    const float* Ws = ring + t % STAGES_W * Tl::STAGE;
    const float* Xs = Ws + Tl::W_STAGE;
    float4 wv[4];
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
      wv[kk] = *reinterpret_cast<const float4*>(
          &Ws[(kl * 4 + kk) * LDW + fg * 4]);
#pragma unroll
    for (int r = 0; r < 8; ++r) {
      const float4 xv =
          *reinterpret_cast<const float4*>(&Xs[r * LDX + kl * 4]);
      const float xr[4] = {xv.x, xv.y, xv.z, xv.w};
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        acc[r][0] = fmaf(xr[kk], wv[kk].x, acc[r][0]);
        acc[r][1] = fmaf(xr[kk], wv[kk].y, acc[r][1]);
        acc[r][2] = fmaf(xr[kk], wv[kk].z, acc[r][2]);
        acc[r][3] = fmaf(xr[kk], wv[kk].w, acc[r][3]);
      }
    }
  }
  cp_async_wait<0>();
  __syncthreads();                  // the ring is free for the partials

  // fold the k lanes of a warp (lanes fg, fg + FG, ...), then the first
  // lane of each feature group stages part[warp][row of x][feature]
  float* const part = reinterpret_cast<float*>(smem);
#pragma unroll
  for (int r = 0; r < 8; ++r)
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      float v = acc[r][j];
#pragma unroll
      for (int off = FG; off < 32; off *= 2)
        v += __shfl_xor_sync(0xffffffffu, v, off);
      if (lane < FG) part[(warp * 8 + r) * TNF + fg * 4 + j] = v;
    }
  cluster_sum<NTW, NTW / 32, TNF>(
      cluster, part, M - m0, N - n0, [&](int r, int f, float s) {
        s = __fadd_rn(s, b[n0 + f]);
        if (relu) s = fmaxf(s, 0.f);
        y[(size_t)(m0 + r) * N + n0 + f] = s;
      });
}

// int8: the same stream on the int8 tensor cores

// The geometry of one int8 block: TNF features, 4 warps. A warp takes FW
// features (a lane 8 or 4 bytes of each w row) x KSW 32-k slabs of each
// chunk: the 4 warps split the chunk's BK/32 slabs and, at TNF 128, its
// two 64-feature sets.
template <int TNF> struct FcS8Tile {
  static constexpr int BK = 8192 / TNF;         // chunk depth: 8 KB of w
  static constexpr int FW = TNF < 64 ? TNF : 64;    // features a warp
  static constexpr int FSETS = TNF / FW;        // feature sets a block
  static constexpr int WPS = 4 / FSETS;         // warps a feature set
  static constexpr int KSW = BK / 32 / WPS;     // 32-k slabs a warp a chunk
  static constexpr int LDW = TNF + 16;          // w row stride in bytes
  static constexpr int LDX = BK + 16;           // x row stride in bytes
  static constexpr int W_STAGE = BK * LDW;      // bytes
  static constexpr int STAGE = W_STAGE + 8 * LDX;
  static constexpr int SMEM = STAGES_W * STAGE;              // bytes
  static constexpr int PART = NTW / 32 * 8 * TNF;            // int32 partials
  static_assert(NTW == 128 && KSW >= 1 && FW % 32 == 0, "4 warps cover it");
  static_assert(PART * 4 <= SMEM, "the partials fit the ring's memory");
};

// 4 rows x 4 columns of bytes -> 4 columns x 4 rows: byte e of c[j] is
// byte j of r[e]
__device__ __forceinline__ void transpose4x4(uint32_t r0, uint32_t r1,
                                             uint32_t r2, uint32_t r3,
                                             uint32_t (&c)[4]) {
  const uint32_t t0 = __byte_perm(r0, r1, 0x5140);
  const uint32_t t1 = __byte_perm(r0, r1, 0x7362);
  const uint32_t t2 = __byte_perm(r2, r3, 0x5140);
  const uint32_t t3 = __byte_perm(r2, r3, 0x7362);
  c[0] = __byte_perm(t0, t2, 0x5410);
  c[1] = __byte_perm(t0, t2, 0x7632);
  c[2] = __byte_perm(t1, t3, 0x5410);
  c[3] = __byte_perm(t1, t3, 0x7632);
}

// The largest cp.async vector (16, 8 or 4 bytes) that a row of n int8
// elements is a whole number of, else 1 (byte by byte). The bases are
// 16-byte aligned (the wrapper checks).
inline int vec_bytes(int n) {
  return n % 16 == 0 ? 16 : n % 8 == 0 ? 8 : n % 4 == 0 ? 4 : 1;
}

// Rows [r0, r0 + ROWS) x columns [c0, c0 + COLS) of a row-major int8 (R, C)
// matrix into shared memory (row stride LD), in V-byte cp.async vectors (C
// a multiple of V), or byte by byte where V is 1; zero past R and C.
template <int V, int ROWS, int COLS, int LD>
__device__ __forceinline__ void stage_s8(int8_t* s, const int8_t* g, int r0,
                                         int c0, int R, int C) {
  if constexpr (V == 1) {
    for (int i = threadIdx.x; i < ROWS * COLS; i += NTW) {
      const int r = i / COLS, c = i % COLS;
      s[r * LD + c] = r0 + r < R && c0 + c < C
                          ? g[(size_t)(r0 + r) * C + c0 + c] : (int8_t)0;
    }
  } else {
    constexpr int PER = COLS / V, N = ROWS * PER;
#pragma unroll
    for (int j = 0; j < (N + NTW - 1) / NTW; ++j) {
      const int i = threadIdx.x + j * NTW;
      if (N % NTW != 0 && i >= N) break;
      const int r = i / PER, c = i % PER * V;
      const bool ok = r0 + r < R && c0 + c < C;
      const int8_t* src = ok ? g + (size_t)(r0 + r) * C + c0 + c : g;
      if constexpr (V == 16)
        cp_async16(smem_u32(s + r * LD + c), src, ok);
      else
        cp_async_ca<V>(smem_u32(s + r * LD + c), src, ok);
    }
  }
}

__device__ __forceinline__ void store(float* y, size_t o, float v, float) {
  y[o] = v;
}
__device__ __forceinline__ void store(int8_t* y, size_t o, float v,
                                      float out_scale) {
  const float q = rintf(__fdiv_rn(v, out_scale));
  y[o] = (int8_t)fminf(fmaxf(q, -127.f), 127.f);
}

// wv, xv: the cp.async vector bytes of w's rows (N) and x's rows (K).
template <int TNF, typename TO>
__global__ void __launch_bounds__(NTW)
matmul_s8_kernel(const int8_t* __restrict__ x, const int8_t* __restrict__ w,
                 const float* __restrict__ b,
                 const float* __restrict__ scale, TO* __restrict__ y, int M,
                 int K, int N, int relu, float out_scale, int wv, int xv) {
  using Tl = FcS8Tile<TNF>;
  constexpr int BK = Tl::BK, LDW = Tl::LDW, LDX = Tl::LDX, FW = Tl::FW;
  constexpr int KSW = Tl::KSW;
  cg::cluster_group cluster = cg::this_cluster();
  const int ranks = (int)cluster.num_blocks();
  const int rank = (int)cluster.block_rank();
  extern __shared__ __align__(16) unsigned char smem[];
  int8_t* const ring = reinterpret_cast<int8_t*>(smem);

  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  const int n0 = blockIdx.x / ranks * TNF;      // the cluster's features
  const int m0 = blockIdx.z * 8;                // its 8 rows of x
  const int nk = (K + BK - 1) / BK;             // this rank's chunks:
  const int c0 = rank * nk / ranks, c1 = (rank + 1) * nk / ranks;

  // Fill ring stage `st` with chunk c: w rows [k0, k0+BK) x the block's
  // features, and x rows m0..m0+7 x the same k.
  auto load_stage = [&](int st, int c) {
    int8_t* const Ws = ring + st * Tl::STAGE;
    int8_t* const Xs = Ws + Tl::W_STAGE;
    const int k0 = c * BK;
    switch (wv) {
      case 16: stage_s8<16, BK, TNF, LDW>(Ws, w, k0, n0, K, N); break;
      case 8: stage_s8<8, BK, TNF, LDW>(Ws, w, k0, n0, K, N); break;
      case 4: stage_s8<4, BK, TNF, LDW>(Ws, w, k0, n0, K, N); break;
      default: stage_s8<1, BK, TNF, LDW>(Ws, w, k0, n0, K, N);
    }
    switch (xv) {
      case 16: stage_s8<16, 8, BK, LDX>(Xs, x, m0, k0, M, K); break;
      case 8: stage_s8<8, 8, BK, LDX>(Xs, x, m0, k0, M, K); break;
      case 4: stage_s8<4, 8, BK, LDX>(Xs, x, m0, k0, M, K); break;
      default: stage_s8<1, 8, BK, LDX>(Xs, x, m0, k0, M, K);
    }
  };

  // a lane's mma fragments: rows g (and g + 8) are its features, k quads
  // t and t + 4 of each 32-k slab, columns g the rows of x; acc[grp][i]
  // holds features fb + grp*4 + 2i (c0, c1) and + 1 (c2, c3), rows of x
  // 2t and 2t + 1
  constexpr int GRPS = FW / 32;                 // 4-feature groups a lane
  const int g = lane / 4, t = lane % 4;
  const int fset = warp / Tl::WPS, slab0 = warp % Tl::WPS;
  const int fb = fset * FW + g * 4 * GRPS;      // the lane's first feature
  int acc[GRPS][2][4];
#pragma unroll
  for (int q = 0; q < GRPS; ++q)
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[q][i][e] = 0;

  const int n_own = c1 - c0;
#pragma unroll
  for (int s = 0; s < STAGES_W - 1; ++s) {
    if (s < n_own) load_stage(s, c0 + s);
    cp_async_commit();
  }
  for (int it = 0; it < n_own; ++it) {
    cp_async_wait<STAGES_W - 2>();    // chunk it has landed (this thread's)
    __syncthreads();                // ... everyone's; stage it-1 is free
    const int nxt = it + STAGES_W - 1;
    if (nxt < n_own) load_stage(nxt % STAGES_W, c0 + nxt);
    cp_async_commit();
    const int8_t* Ws = ring + it % STAGES_W * Tl::STAGE;
    const int8_t* Xs = Ws + Tl::W_STAGE;
#pragma unroll
    for (int j = 0; j < KSW; ++j) {
      const int kr = (slab0 + j * Tl::WPS) * 32 + 4 * t;
      const uint32_t b0 = *reinterpret_cast<const uint32_t*>(
          &Xs[g * LDX + kr]);
      const uint32_t b1 = *reinterpret_cast<const uint32_t*>(
          &Xs[g * LDX + kr + 16]);
      uint32_t c[2][GRPS][4];       // [quad t, t + 4][group][feature]
#pragma unroll
      for (int qd = 0; qd < 2; ++qd) {
        uint32_t r[4][GRPS];
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int8_t* row = &Ws[(kr + 16 * qd + e) * LDW + fb];
          if constexpr (GRPS == 2) {
            const uint2 u = *reinterpret_cast<const uint2*>(row);
            r[e][0] = u.x;
            r[e][1] = u.y;
          } else {
            r[e][0] = *reinterpret_cast<const uint32_t*>(row);
          }
        }
#pragma unroll
        for (int q = 0; q < GRPS; ++q)
          transpose4x4(r[0][q], r[1][q], r[2][q], r[3][q], c[qd][q]);
      }
#pragma unroll
      for (int q = 0; q < GRPS; ++q)
#pragma unroll
        for (int i = 0; i < 2; ++i) {
          const uint32_t a[4] = {c[0][q][2 * i], c[0][q][2 * i + 1],
                                 c[1][q][2 * i], c[1][q][2 * i + 1]};
          mma_s8(acc[q][i], a, b0, b1);
        }
    }
  }
  cp_async_wait<0>();
  __syncthreads();                  // the ring is free for the partials

  // this warp's partial tile, part[warp][row of x][feature]; zero outside
  // its feature set
  int* const part = reinterpret_cast<int*>(smem);
  for (int i = lane; i < 8 * TNF; i += 32)
    if (i % TNF / FW != fset) part[warp * 8 * TNF + i] = 0;
#pragma unroll
  for (int q = 0; q < GRPS; ++q)
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int e = 0; e < 4; ++e)
        part[(warp * 8 + 2 * t + e % 2) * TNF + fb + q * 4 + 2 * i + e / 2] =
            acc[q][i][e];
  cluster_sum<NTW, NTW / 32, TNF>(
      cluster, part, M - m0, N - n0, [&](int r, int f, int s) {
        float v = __fadd_rn(__fmul_rn(__int2float_rn(s), scale[n0 + f]),
                            b[n0 + f]);
        if (relu) v = fmaxf(v, 0.f);
        store(y, (size_t)(m0 + r) * N + n0 + f, v, out_scale);
      });
}

// One launch of a split-K kernel: `tnf` features a cluster of `ranks`
// blocks, `smem` bytes of dynamic shared memory, its limit raised at the
// kernel's first launch (`attr`); `args` are the kernel's.
template <typename... P, typename... A>
int launch_cluster(void (*kernel)(P...), cudaError_t attr, int smem,
                   int tnf, int ranks, int M, int N, void* stream,
                   A... args) {
  if (attr != cudaSuccess) return (int)attr;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((N + tnf - 1) / tnf * ranks, 1, (M + 7) / 8);
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
  const cudaError_t e = cudaLaunchKernelEx(&cfg, kernel, args...);
  return e != cudaSuccess ? (int)e : (int)cudaGetLastError();
}

template <int TNF>
int launch_bf16(const __nv_bfloat16* x, const __nv_bfloat16* w,
                const __nv_bfloat16* b, __nv_bfloat16* y, int M, int K, int N,
                int relu, int ranks, void* stream) {
  constexpr int smem = FcTile<TNF>::SMEM;
  static const cudaError_t attr = cudaFuncSetAttribute(
      matmul_bf16_kernel<TNF>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      smem);
  return launch_cluster(matmul_bf16_kernel<TNF>, attr, smem, TNF, ranks, M,
                        N, stream, x, w, b, y, M, K, N, relu,
                        (int)(N % 8 == 0), (int)(K % 8 == 0));
}

template <int TNF>
int launch_f32(const float* x, const float* w, const float* b, float* y,
               int M, int K, int N, int relu, int ranks, void* stream) {
  constexpr int smem = FcF32Tile<TNF>::SMEM;
  static const cudaError_t attr = cudaFuncSetAttribute(
      matmul_f32_kernel<TNF>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      smem);
  return launch_cluster(matmul_f32_kernel<TNF>, attr, smem, TNF, ranks, M,
                        N, stream, x, w, b, y, M, K, N, relu,
                        (int)(N % 4 == 0), (int)(K % 4 == 0));
}

template <int TNF, typename TO>
int launch_s8(const int8_t* x, const int8_t* w, const float* b,
              const float* scale, TO* y, float out_scale, int M, int K,
              int N, int relu, int ranks, void* stream) {
  constexpr int smem = FcS8Tile<TNF>::SMEM;
  static const cudaError_t attr = cudaFuncSetAttribute(
      matmul_s8_kernel<TNF, TO>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      smem);
  return launch_cluster(matmul_s8_kernel<TNF, TO>, attr, smem, TNF, ranks, M,
                        N, stream, x, w, b, scale, y, M, K, N, relu,
                        out_scale, vec_bytes(N), vec_bytes(K));
}

template <typename TO>
int dispatch_s8(const int8_t* x, const int8_t* w, const float* b,
                const float* scale, TO* y, float out_scale, int M, int K,
                int N, int relu, int tnf, int ranks, void* stream) {
  if (tnf == 128)
    return launch_s8<128>(x, w, b, scale, y, out_scale, M, K, N, relu, ranks,
                          stream);
  if (tnf == 32)
    return launch_s8<32>(x, w, b, scale, y, out_scale, M, K, N, relu, ranks,
                         stream);
  return (int)cudaErrorInvalidValue;
}

}  // namespace

// fp32 x, w, b and y, FFMA on the CUDA cores. (tnf, ranks): the features a
// cluster (128, 64 or 32) and its blocks (1 to 8), which split K. Returns
// the launch's error, else cudaGetLastError().
extern "C" int matmul_pipe_f32(const float* x, const float* w, const float* b,
                               float* y, int M, int K, int N, int relu,
                               int tnf, int ranks, void* stream) {
  if (ranks < 1 || ranks > 8) return (int)cudaErrorInvalidValue;
  if (tnf == 128)
    return launch_f32<128>(x, w, b, y, M, K, N, relu, ranks, stream);
  if (tnf == 64)
    return launch_f32<64>(x, w, b, y, M, K, N, relu, ranks, stream);
  if (tnf == 32)
    return launch_f32<32>(x, w, b, y, M, K, N, relu, ranks, stream);
  return (int)cudaErrorInvalidValue;
}

// int8 x and w, fp32 b and scale (N,) = s_x * s_w[n], on the int8 tensor
// cores, exact int32 sums. out_s8: the output is int8 quantized by
// out_scale, else fp32. (tnf, ranks): the features a cluster (128 or 32)
// and its blocks (1 to 8), which split K. Returns the launch's error,
// else cudaGetLastError().
extern "C" int matmul_pipe_s8(const int8_t* x, const int8_t* w, const float* b,
                              const float* scale, void* y, int out_s8,
                              float out_scale, int M, int K, int N, int relu,
                              int tnf, int ranks, void* stream) {
  if (ranks < 1 || ranks > 8) return (int)cudaErrorInvalidValue;
  if (out_s8)
    return dispatch_s8(x, w, b, scale, (int8_t*)y, out_scale, M, K, N, relu,
                       tnf, ranks, stream);
  return dispatch_s8(x, w, b, scale, (float*)y, out_scale, M, K, N, relu,
                     tnf, ranks, stream);
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

// flash_attention: causal attention with an online softmax, GQA read in
// place; fp32 elements on the CUDA cores, or bf16 on the tensor cores.
//
// Replaces the TPU kernel src/repro/kernels/flash_attention.py:flash_attention
// (body _flash_kernel), and the head repeat that src/repro/kernels/ops.py:
// attention puts in front of it. q (B, Hq, Sq, D), k and v (B, Hkv, Sk, D),
// o (B, Hq, Sq, D), all contiguous. Query head h reads KV head h / (Hq/Hkv),
// the order jnp.repeat(k, g, axis=1) gives.
//
// Bound on an H100: operations. The causal product takes 4*D operations for
// each of the Sq(Sq+1)/2 (query, key) pairs below the diagonal; at Qwen3-8B
// prefill (S 4096, D 128, 32 query and 8 KV heads) that is 137 GOP against
// 84 MB of bf16 q, k, v and o, some 1600 operations a byte.
//
// fp32 (flash_f32_kernel<D>): FFMA on the CUDA cores, as the TPU kernel
// computes in fp32 (TF32 would break the reference's 1e-4). One block of
// 8 warps per (batch*head, 128-row query tile), one block an SM (227 KB of
// shared memory at D 128); the TPU's sequential KV-tile grid axis becomes
// a loop inside the block, and its VMEM scratch (running max m, normaliser
// l, accumulator acc) becomes registers. The FFMA pipe needs an issue slot
// for every FFMA, so what bounds the kernel is the instructions and
// shared-memory wavefronts that feed them. The first version (64-row
// tiles, 4 rows x 4 keys a thread, K then V copied through registers into
// one buffer, three barriers a tile) spent one 16-byte shared load on 8
// FFMAs and waited on device memory at every tile: 4.29 ms at Qwen3-8B's
// prefill (S 4096, 48 % of the 2.05 ms FFMA bound; NVIDIA H100 80GB HBM3,
// 700 W; chip_smoke.py). Now:
//  - a lane (h, tx) of warp w holds rows 16w + 2i + h (i < 8) and keys
//    tx + 16j (j < 4) of S, and the same 8 rows x D/16 columns of O, so
//    each 16-byte shared load of K, V or P feeds 32 FFMAs and of Q 16; a
//    warp's two rows of a Q or P load fall on different banks (row h XORs
//    its 16-byte chunk index with 4), K rows are D + 4 floats apart, and a
//    warp reads one V row whole, so every load takes the fewest
//    wavefronts its bytes need;
//  - K and V stream into separate two-stage rings by 16-byte cp.async a
//    tile ahead, so K_{t+1} and V_t are in flight while S_t is computed,
//    and one barrier separates the two products (two a tile);
//  - the softmax's row max is a 16-lane shuffle; each lane keeps its own
//    share of l, summed once at the end.
// A warp whose 16 rows all lie above a tile skips it. 3.37 ms at the same
// shape (61 % of the bound; the same card, in one call with the first
// version); an unroll of 4 or 2 chunks in either product (fewer registers
// than the 254 this one takes) was slower.
//
// bf16 (flash_bf16_mma_kernel<D>): the tensor cores, in the shape of
// FlashAttention-2 on mma.sync.m16n8k16 (bf16 products, fp32 sums). Each
// warp owns 16 query rows, a block of 4 warps 64, and two blocks fit an SM
// (226 registers a thread at D 128; a 128-row block of 8 warps, one an
// SM, was slower at Qwen3-8B's prefill in a first card run). The Q tile and
// double-buffered 64-key K and V tiles stream in through cp.async (K and V
// in separate groups, so S = Q K^T starts while V lands), at a row stride
// of D + 8 bf16, which puts the 8 rows of every ldmatrix on distinct banks.
// Q comes into registers once (ldmatrix) as the A operand; K, stored
// [key][d], is already the column-major B operand (plain ldmatrix). The
// scores stay in their fp32 accumulator fragments: scaled by 1/sqrt(D)
// there (the TPU kernel scales q instead), masked k_pos > q_pos with
// -1e30, their row max and the running m from shuffles across the quad of
// lanes that shares a row. P = exp(S - m) is rounded once to bf16 and
// reused in registers as the A operand of O += P V, with V read by
// ldmatrix.trans; l sums the rounded P, so the weights that multiply V
// are the ones that normalise. Against the reference (fp32 throughout)
// the products round once more each: P to bf16 (at most 2^-9 relative)
// and the scores in another order; chip_smoke.py prints the worst error
// beside the 2e-2 allowance. A warp whose 16 rows all lie above a tile
// skips it. mma.sync, not wgmma: the A operand of wgmma from registers
// needs a warpgroup's 64 rows, and this kernel keeps the FA2 shape for a
// first tensor-core version. What holds it back is latency more than
// issue work: at 226 registers a thread two blocks fit an SM, two warps a
// scheduler, each tile's two products and softmax a dependent chain
// between two barriers (folding the scale into the exponent's fmaf and
// skipping O's rescale where no max moved cut the softmax's instructions
// and left the time as it was).
//
// Both: the loop stops at the causal edge: a tile entirely above the
// diagonal has every score at -1e30, so the TPU kernel's update with it is
// exact identity and skipping it gives the same output. Blocks of the last
// (longest) query tiles are scheduled first. Ragged S is masked (zero rows
// in shared memory, no stores). Epilogue: acc / max(l, 1e-30), rounded once
// to bf16 (__float2bfloat16_rn) where the output is bf16. expf, never
// __expf: the build uses no fast math.
#include <cstdint>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "hopper.cuh"

namespace {

constexpr int BQ = 64;           // bf16: query rows per block
constexpr int BK = 64;           // keys per tile (both kernels)
constexpr float NEG_INF = -1e30f;

// ---- fp32: FFMA on the CUDA cores ------------------------------------------

// The geometry of one fp32 block: 8 warps of 16 query rows each. Lane
// (h, tx) = (lane / 16, lane % 16) of warp w holds rows 16w + 2i + h
// (i < RM) of the tile, keys tx + 16j (j < 4) of S and columns
// tx*VEC + 16*VEC*n (n < NJ) of O.
template <int D> struct F32Tile {
  static constexpr int BQ = 128;
  static constexpr int NT = 256;
  static constexpr int RM = 8;                  // query rows a thread
  static constexpr int CH = D / 4;              // 16-byte chunks a row
  static constexpr int U = CH < 8 ? CH : 8;     // chunks an unrolled step
  // A warp-wide load of Q or P meets rows 2i + h for h 0 and 1; row h = 1
  // XORs its chunk index with 4, so the two fall on different banks (at
  // D 16 two 64-byte rows already share a 128-byte line). P rows are BK
  // wide, so P always swizzles.
  static constexpr int SWZ = CH >= 8 ? 4 : 0;
  static constexpr int KLD = D + 4;             // K row stride: the 16 rows
                                                // of a load on 8 banks
  static constexpr int VEC = D / 16 >= 4 ? 4 : D / 16;
  static constexpr int NJ = D / (16 * VEC);     // O column groups a thread
  static constexpr int Q_FLOATS = BQ * D;
  static constexpr int K_FLOATS = BK * KLD;     // one stage of the ring
  static constexpr int V_FLOATS = BK * D;       // one stage of the ring
  static constexpr int P_FLOATS = BQ * BK;
  static constexpr int SMEM =
      4 * (Q_FLOATS + 2 * K_FLOATS + 2 * V_FLOATS + P_FLOATS);   // bytes
  static_assert(SMEM <= 232448, "fits an H100 block's shared memory");
};

// Rows [r0, r0 + ROWS) of a row-major (n_rows, D) matrix of T into shared
// memory (row stride LD elements) in 16-byte cp.async vectors; rows past
// n_rows zero-filled.
template <int ROWS, int D, int LD, int NTH, typename T>
__device__ __forceinline__ void stage_rows(T* s, const T* g, int r0,
                                           int n_rows) {
  constexpr int PER = 16 / sizeof(T);           // elements a vector
  constexpr int VR = D / PER;                   // vectors a row
  static_assert(ROWS * VR % NTH == 0, "whole vectors a thread");
#pragma unroll
  for (int j = 0; j < ROWS * VR / NTH; ++j) {
    const int i = threadIdx.x + j * NTH, r = i / VR, c = i % VR * PER;
    const bool ok = r0 + r < n_rows;
    cp_async16(smem_u32(s + r * LD + c), ok ? g + (size_t)(r0 + r) * D + c : g,
               ok);
  }
}

template <int N>
__device__ __forceinline__ void lds(const float* p, float (&v)[N]);
template <>
__device__ __forceinline__ void lds<1>(const float* p, float (&v)[1]) {
  v[0] = *p;
}
template <>
__device__ __forceinline__ void lds<2>(const float* p, float (&v)[2]) {
  const float2 t = *reinterpret_cast<const float2*>(p);
  v[0] = t.x; v[1] = t.y;
}
template <>
__device__ __forceinline__ void lds<4>(const float* p, float (&v)[4]) {
  const float4 t = *reinterpret_cast<const float4*>(p);
  v[0] = t.x; v[1] = t.y; v[2] = t.z; v[3] = t.w;
}

__device__ __forceinline__ float lane_of(const float4& v, int e) {
  return e == 0 ? v.x : e == 1 ? v.y : e == 2 ? v.z : v.w;
}

template <int D>
__global__ void __launch_bounds__(256, 1)
flash_f32_kernel(const float* __restrict__ q, const float* __restrict__ k,
                 const float* __restrict__ v, float* __restrict__ o, int Hq,
                 int Hkv, int Sq, int Sk, float scale) {
  using Tl = F32Tile<D>;
  constexpr int NT = Tl::NT, RM = Tl::RM, CH = Tl::CH, U = Tl::U;
  constexpr int SWZ = Tl::SWZ, KLD = Tl::KLD, VEC = Tl::VEC, NJ = Tl::NJ;
  extern __shared__ float4 smem4[];
  float* const Qs = reinterpret_cast<float*>(smem4);   // [BQ][D], swizzled
  float* const Ks = Qs + Tl::Q_FLOATS;                 // [2][BK][KLD]
  float* const Vs = Ks + 2 * Tl::K_FLOATS;             // [2][BK][D]
  float* const Ps = Vs + 2 * Tl::V_FLOATS;             // [BQ][BK], swizzled

  const int lane = threadIdx.x % 32, w = threadIdx.x / 32;
  const int h = lane / 16, tx = lane % 16;
  const int bh = blockIdx.x;
  const int b = bh / Hq, hq = bh % Hq;
  const int kvh = b * Hkv + hq / (Hq / Hkv);
  const int q0 = (gridDim.y - 1 - blockIdx.y) * Tl::BQ;   // longest first
  const int r0 = 16 * w;                        // the warp's first row
  const float* qg = q + (size_t)bh * Sq * D;
  const float* kg = k + (size_t)kvh * Sk * D;
  const float* vg = v + (size_t)kvh * Sk * D;

  const int n_tiles = (min(min(q0 + Tl::BQ, Sq), Sk) - 1) / BK + 1;
  stage_rows<BK, D, KLD, NT>(Ks, kg, 0, Sk);
  cp_async_commit();                            // group: K_0
  stage_rows<BK, D, D, NT>(Vs, vg, 0, Sk);
  cp_async_commit();                            // group: V_0
  // Q times 1/sqrt(D), as the TPU kernel scales it, while K_0 and V_0 land;
  // chunk c of row r at c ^ (SWZ * (r & 1)); rows past Sq are zero
  for (int i = threadIdx.x; i < Tl::BQ * CH; i += NT) {
    const int r = i / CH, c = i % CH;
    float4 f = make_float4(0.f, 0.f, 0.f, 0.f);
    if (q0 + r < Sq)
      f = __ldg(reinterpret_cast<const float4*>(qg + (size_t)(q0 + r) * D) +
                c);
    *reinterpret_cast<float4*>(Qs + r * D + 4 * (c ^ (SWZ * (r & 1)))) =
        make_float4(f.x * scale, f.y * scale, f.z * scale, f.w * scale);
  }

  // Chunk c of row r0 + 2i + h sits at base + 2i * D + 4c + 4 * SWZ * h
  // when bit 2 of c is clear and - 4 * SWZ * h when it is set; every chunk
  // index below is a compile-time step of 8, so the choice is too.
  const float* const q_lo = Qs + (r0 + h) * D + 4 * SWZ * h;
  const float* const q_hi = Qs + (r0 + h) * D - 4 * SWZ * h;
  float* const p_lo = Ps + (r0 + h) * BK + 16 * h;
  float* const p_hi = Ps + (r0 + h) * BK - 16 * h;

  float m[RM], l[RM], acc[RM][NJ * VEC];
#pragma unroll
  for (int i = 0; i < RM; ++i) {
    m[i] = NEG_INF;
    l[i] = 0.f;                                 // this lane's keys' share
#pragma unroll
    for (int n = 0; n < NJ * VEC; ++n) acc[i][n] = 0.f;
  }

  for (int t = 0; t < n_tiles; ++t) {
    const int k0 = t * BK, cur = t & 1;
    cp_async_wait<1>();             // K_t landed: this thread's
    __syncthreads();                // ... everyone's; tile t-1 is read
    if (t + 1 < n_tiles)
      stage_rows<BK, D, KLD, NT>(Ks + (cur ^ 1) * Tl::K_FLOATS, kg, k0 + BK,
                                Sk);
    cp_async_commit();
    if (t + 1 < n_tiles)
      stage_rows<BK, D, D, NT>(Vs + (cur ^ 1) * Tl::V_FLOATS, vg, k0 + BK, Sk);
    cp_async_commit();
    // a warp whose 16 rows all lie above the tile (or past Sq) skips it:
    // every score would be masked, and the update would leave m, l and O
    // as they are
    const bool live = q0 + r0 < Sq && k0 <= q0 + r0 + 15;
    if (live) {
      const float* const Kt = Ks + cur * Tl::K_FLOATS + tx * KLD;
      float s[RM][4];
#pragma unroll
      for (int i = 0; i < RM; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
      for (int c8 = 0; c8 < CH; c8 += U) {
#pragma unroll
        for (int u = 0; u < U; ++u) {
          const int c = c8 + u;
          const float* const qb = ((c & 4) ? q_hi : q_lo) + 4 * c;
          float4 qv[RM], kk[4];
#pragma unroll
          for (int i = 0; i < RM; ++i)
            qv[i] = *reinterpret_cast<const float4*>(qb + 2 * i * D);
#pragma unroll
          for (int j = 0; j < 4; ++j)
            kk[j] = *reinterpret_cast<const float4*>(Kt + 16 * j * KLD + 4 * c);
#pragma unroll
          for (int i = 0; i < RM; ++i)
#pragma unroll
            for (int j = 0; j < 4; ++j) {
              s[i][j] = fmaf(qv[i].x, kk[j].x, s[i][j]);
              s[i][j] = fmaf(qv[i].y, kk[j].y, s[i][j]);
              s[i][j] = fmaf(qv[i].z, kk[j].z, s[i][j]);
              s[i][j] = fmaf(qv[i].w, kk[j].w, s[i][j]);
            }
        }
      }
      // mask k_pos > q_pos (and keys past Sk) with -1e30, as the TPU kernel
      // masks, where the tile reaches past the warp's first row; the row
      // max over the 16 lanes of a half-warp; P = exp(S - m) to shared
      // memory at key column (tx + 16j) ^ 16h
      const bool edge = k0 + BK - 1 > q0 + r0 || k0 + BK > Sk;
#pragma unroll
      for (int i = 0; i < RM; ++i) {
        const int qp = q0 + r0 + 2 * i + h;
        float mx = NEG_INF;
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int kp = k0 + tx + 16 * j;
          if (edge && (kp > qp || kp >= Sk)) s[i][j] = NEG_INF;
          mx = fmaxf(mx, s[i][j]);
        }
#pragma unroll
        for (int off = 8; off > 0; off >>= 1)
          mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
        const float m_new = fmaxf(m[i], mx);
        float sum = 0.f;
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const float p = expf(s[i][j] - m_new);
          ((j & 1) ? p_hi : p_lo)[2 * i * BK + tx + 16 * j] = p;
          sum += p;
        }
        const float coef = expf(m[i] - m_new);
        l[i] = l[i] * coef + sum;
        m[i] = m_new;
#pragma unroll
        for (int n = 0; n < NJ * VEC; ++n) acc[i][n] *= coef;
      }
    }
    cp_async_wait<2>();             // V_t landed: this thread's
    __syncthreads();                // ... everyone's, and P
    if (live) {
      const float* const Vt = Vs + cur * Tl::V_FLOATS + tx * VEC;
      for (int c8 = 0; c8 < BK / 4; c8 += 8) {
#pragma unroll
        for (int u = 0; u < 8; ++u) {
          const int c4 = c8 + u;                // keys 4*c4 .. 4*c4 + 3
          const float* const pb = ((c4 & 4) ? p_hi : p_lo) + 4 * c4;
          float4 pv[RM];
#pragma unroll
          for (int i = 0; i < RM; ++i)
            pv[i] = *reinterpret_cast<const float4*>(pb + 2 * i * BK);
#pragma unroll
          for (int cc = 0; cc < 4; ++cc) {
            const float* const vrow = Vt + (4 * c4 + cc) * D;
#pragma unroll
            for (int n = 0; n < NJ; ++n) {
              float vv[VEC];
              lds<VEC>(vrow + n * 16 * VEC, vv);
#pragma unroll
              for (int i = 0; i < RM; ++i) {
                const float p = lane_of(pv[i], cc);
#pragma unroll
                for (int e = 0; e < VEC; ++e)
                  acc[i][n * VEC + e] = fmaf(p, vv[e], acc[i][n * VEC + e]);
              }
            }
          }
        }
      }
    }
  }

  // l: the sum of the 16 lanes' shares of each row; acc / max(l, 1e-30)
  float* const og = o + (size_t)bh * Sq * D;
#pragma unroll
  for (int i = 0; i < RM; ++i) {
#pragma unroll
    for (int off = 8; off > 0; off >>= 1)
      l[i] += __shfl_xor_sync(0xffffffffu, l[i], off);
  }
#pragma unroll
  for (int i = 0; i < RM; ++i) {
    const int qp = q0 + r0 + 2 * i + h;
    if (qp >= Sq) continue;
    const float den = fmaxf(l[i], 1e-30f);
#pragma unroll
    for (int n = 0; n < NJ; ++n) {
      float* const dst = og + (size_t)qp * D + n * 16 * VEC + tx * VEC;
      if constexpr (VEC == 4) {
        *reinterpret_cast<float4*>(dst) =
            make_float4(acc[i][n * 4] / den, acc[i][n * 4 + 1] / den,
                        acc[i][n * 4 + 2] / den, acc[i][n * 4 + 3] / den);
      } else {
#pragma unroll
        for (int e = 0; e < VEC; ++e) dst[e] = acc[i][n * VEC + e] / den;
      }
    }
  }
}

template <int D>
int launch_f32(const float* q, const float* k, const float* v, float* o,
               int B, int Hq, int Hkv, int Sq, int Sk, float scale,
               cudaStream_t st) {
  using Tl = F32Tile<D>;
  static const cudaError_t attr = cudaFuncSetAttribute(
      flash_f32_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      Tl::SMEM);
  if (attr != cudaSuccess) return (int)attr;
  dim3 grid(B * Hq, (Sq + Tl::BQ - 1) / Tl::BQ);
  flash_f32_kernel<D><<<grid, Tl::NT, Tl::SMEM, st>>>(q, k, v, o, Hq, Hkv,
                                                      Sq, Sk, scale);
  return (int)cudaGetLastError();
}

// ---- bf16: the tensor cores ----------------------------------------------

// The geometry of one bf16 block: 4 warps of 16 query rows each (BQ).
template <int D> struct FlashTile {
  static constexpr int NT = 128;
  static constexpr int LD = D + 8;              // shared row stride (bf16):
                                                // 8 ldmatrix rows, 8 banks
  static constexpr int Q_ELEMS = BQ * LD;
  static constexpr int KV_ELEMS = BK * LD;
  static constexpr int SMEM = (Q_ELEMS + 4 * KV_ELEMS) * 2;   // bytes
};

__device__ __forceinline__ uint32_t bf16x2_bits(__nv_bfloat162 v) {
  return *reinterpret_cast<uint32_t*>(&v);
}

template <int D>
__global__ void __launch_bounds__(128, 2)
flash_bf16_mma_kernel(const __nv_bfloat16* __restrict__ q,
                      const __nv_bfloat16* __restrict__ k,
                      const __nv_bfloat16* __restrict__ v,
                      __nv_bfloat16* __restrict__ o, int Hq, int Hkv, int S,
                      float scale) {
  using Tl = FlashTile<D>;
  constexpr int NTH = Tl::NT, LD = Tl::LD;
  constexpr int DK = D / 16;                    // k steps of S = Q K^T
  constexpr int DN = D / 8;                     // n tiles of O
  constexpr int NN = BK / 8;                    // n tiles of S
  extern __shared__ __align__(16) unsigned char smem[];
  __nv_bfloat16* const Qs = reinterpret_cast<__nv_bfloat16*>(smem);
  __nv_bfloat16* const Ks = Qs + Tl::Q_ELEMS;   // [2][BK][LD]
  __nv_bfloat16* const Vs = Ks + 2 * Tl::KV_ELEMS;   // [2][BK][LD]

  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  const int g = lane / 4, t4 = lane % 4;        // the mma fragment's row, pair
  const int bh = blockIdx.x;
  const int b = bh / Hq, h = bh % Hq;
  const int kvh = b * Hkv + h / (Hq / Hkv);
  const int q0 = (gridDim.y - 1 - blockIdx.y) * BQ;      // longest first
  const int r0 = q0 + warp * 16;                // this warp's first row
  const __nv_bfloat16* qg = q + (size_t)bh * S * D;
  const __nv_bfloat16* kg = k + (size_t)kvh * S * D;
  const __nv_bfloat16* vg = v + (size_t)kvh * S * D;

  const int n_tiles = (min(q0 + BQ, S) - 1) / BK + 1;    // the causal edge
  stage_rows<BQ, D, LD, NTH>(Qs, qg, q0, S);
  stage_rows<BK, D, LD, NTH>(Ks, kg, 0, S);
  cp_async_commit();                            // group: Q, K_0
  stage_rows<BK, D, LD, NTH>(Vs, vg, 0, S);
  cp_async_commit();                            // group: V_0

  uint32_t qf[DK][4];                           // Q, the A operand
  float oacc[DN][4];                            // O, rows g and g + 8
  float m[2] = {NEG_INF, NEG_INF}, l[2] = {0.f, 0.f};
#pragma unroll
  for (int n = 0; n < DN; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) oacc[n][e] = 0.f;

  for (int t = 0; t < n_tiles; ++t) {
    const int k0 = t * BK, cur = t % 2;
    cp_async_wait<1>();             // K_t (and Q) landed: this thread's
    __syncthreads();                // ... everyone's; tile t-1 is read
    if (t + 1 < n_tiles)
      stage_rows<BK, D, LD, NTH>(Ks + (1 - cur) * Tl::KV_ELEMS, kg, k0 + BK,
                                 S);
    cp_async_commit();
    if (t + 1 < n_tiles)
      stage_rows<BK, D, LD, NTH>(Vs + (1 - cur) * Tl::KV_ELEMS, vg, k0 + BK,
                                 S);
    cp_async_commit();
    if (t == 0) {
#pragma unroll
      for (int kk = 0; kk < DK; ++kk)
        ldmatrix_x4(qf[kk], smem_u32(Qs + (warp * 16 + lane % 16) * LD +
                                     kk * 16 + lane / 16 * 8));
    }
    // a warp whose rows all lie above the tile (or past S) skips it: every
    // score would be masked, and the update would leave m, l and O as they
    // are
    const bool live = r0 < S && k0 <= r0 + 15;
    uint32_t pa[BK / 16][4];                    // P, the A operand of P V
    float coef[2];
    if (live) {
      const __nv_bfloat16* Kt = Ks + cur * Tl::KV_ELEMS;
      float sc[NN][4];
#pragma unroll
      for (int n = 0; n < NN; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) sc[n][e] = 0.f;
#pragma unroll
      for (int kk = 0; kk < DK; ++kk)
#pragma unroll
        for (int np = 0; np < NN / 2; ++np) {
          uint32_t kb[4];                       // keys np*16 .. +15
          ldmatrix_x4(kb, smem_u32(Kt + (np * 16 + lane / 16 * 8 + lane % 8) *
                                            LD + kk * 16 + lane / 8 % 2 * 8));
          mma_bf16(sc[2 * np], qf[kk], kb[0], kb[1]);
          mma_bf16(sc[2 * np + 1], qf[kk], kb[2], kb[3]);
        }
      // scale and mask in fp32 (k_pos > q_pos: -1e30, as the TPU kernel
      // masks; keys past S are above every row that is stored), then the
      // row max over the quad that shares a row
      const bool edge = k0 + BK - 1 > r0;
      float mx[2] = {NEG_INF, NEG_INF};
#pragma unroll
      for (int n = 0; n < NN; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          float s = sc[n][e] * scale;
          if (edge && k0 + n * 8 + 2 * t4 + e % 2 > r0 + g + e / 2 * 8)
            s = NEG_INF;
          sc[n][e] = s;
          mx[e / 2] = fmaxf(mx[e / 2], s);
        }
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 1));
        mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 2));
        const float m_new = fmaxf(m[i], mx[i]);
        coef[i] = expf(m[i] - m_new);
        m[i] = m_new;
      }
      // P = exp(S - m), rounded once to bf16; l sums the rounded P, the
      // weights the second product applies
      float rs[2] = {0.f, 0.f};
#pragma unroll
      for (int n = 0; n < NN; ++n) {
        const __nv_bfloat162 lo = __floats2bfloat162_rn(
            expf(sc[n][0] - m[0]), expf(sc[n][1] - m[0]));
        const __nv_bfloat162 hi = __floats2bfloat162_rn(
            expf(sc[n][2] - m[1]), expf(sc[n][3] - m[1]));
        rs[0] += __low2float(lo) + __high2float(lo);
        rs[1] += __low2float(hi) + __high2float(hi);
        pa[n / 2][n % 2 * 2] = bf16x2_bits(lo);
        pa[n / 2][n % 2 * 2 + 1] = bf16x2_bits(hi);
      }
#pragma unroll
      for (int i = 0; i < 2; ++i) l[i] = l[i] * coef[i] + rs[i];
    }
    cp_async_wait<2>();             // V_t landed: this thread's
    __syncthreads();                // ... everyone's
    if (live) {
      const __nv_bfloat16* Vt = Vs + cur * Tl::KV_ELEMS;
#pragma unroll
      for (int n = 0; n < DN; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) oacc[n][e] *= coef[e / 2];
#pragma unroll
      for (int ks = 0; ks < BK / 16; ++ks)
#pragma unroll
        for (int dp = 0; dp < DN / 2; ++dp) {
          uint32_t vb[4];                       // d dp*16 .. +15
          ldmatrix_x4_trans(vb, smem_u32(Vt + (ks * 16 + lane / 8 % 2 * 8 +
                                               lane % 8) * LD + dp * 16 +
                                         lane / 16 * 8));
          mma_bf16(oacc[2 * dp], pa[ks], vb[0], vb[1]);
          mma_bf16(oacc[2 * dp + 1], pa[ks], vb[2], vb[3]);
        }
    }
  }

  __nv_bfloat16* og = o + (size_t)bh * S * D;
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    l[i] += __shfl_xor_sync(0xffffffffu, l[i], 1);
    l[i] += __shfl_xor_sync(0xffffffffu, l[i], 2);
    const int qp = r0 + g + 8 * i;
    if (qp >= S) continue;
    const float den = fmaxf(l[i], 1e-30f);
#pragma unroll
    for (int n = 0; n < DN; ++n)
      *reinterpret_cast<__nv_bfloat162*>(og + (size_t)qp * D + n * 8 +
                                         2 * t4) =
          __floats2bfloat162_rn(oacc[n][2 * i] / den,
                                oacc[n][2 * i + 1] / den);
  }
}

template <int D>
int launch_bf16(const __nv_bfloat16* q, const __nv_bfloat16* k,
                const __nv_bfloat16* v, __nv_bfloat16* o, int B, int Hq,
                int Hkv, int S, float scale, cudaStream_t st) {
  using Tl = FlashTile<D>;
  static const cudaError_t attr = cudaFuncSetAttribute(
      flash_bf16_mma_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      Tl::SMEM);
  if (attr != cudaSuccess) return (int)attr;
  dim3 grid(B * Hq, (S + BQ - 1) / BQ);
  flash_bf16_mma_kernel<D><<<grid, Tl::NT, Tl::SMEM, st>>>(q, k, v, o, Hq,
                                                           Hkv, S, scale);
  return (int)cudaGetLastError();
}

}  // namespace

// Plain C entry points; D in {16, 32, 64, 128}, Hq a multiple of Hkv, every
// pointer 16-byte aligned. scale = 1/sqrt(D) in fp32 (the fp32 kernel
// multiplies it into q, as the TPU kernel does; the bf16 kernel into the
// fp32 scores). Return cudaGetLastError() (or the attribute error).
extern "C" int flash_attention_f32(const float* q, const float* k,
                                   const float* v, float* o, int B, int Hq,
                                   int Hkv, int Sq, int Sk, int D,
                                   float scale, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  switch (D) {
    case 16: return launch_f32<16>(q, k, v, o, B, Hq, Hkv, Sq, Sk, scale, st);
    case 32: return launch_f32<32>(q, k, v, o, B, Hq, Hkv, Sq, Sk, scale, st);
    case 64: return launch_f32<64>(q, k, v, o, B, Hq, Hkv, Sq, Sk, scale, st);
    case 128:
      return launch_f32<128>(q, k, v, o, B, Hq, Hkv, Sq, Sk, scale, st);
    default: return (int)cudaErrorInvalidValue;
  }
}

// bf16 q, k, v and o on the tensor cores; queries as long as keys.
extern "C" int flash_attention_bf16(const __nv_bfloat16* q,
                                    const __nv_bfloat16* k,
                                    const __nv_bfloat16* v, __nv_bfloat16* o,
                                    int B, int Hq, int Hkv, int Sq, int Sk,
                                    int D, float scale, void* stream) {
  if (Sq != Sk) return (int)cudaErrorInvalidValue;
  const int S = Sq;
  cudaStream_t st = (cudaStream_t)stream;
  switch (D) {
    case 16: return launch_bf16<16>(q, k, v, o, B, Hq, Hkv, S, scale, st);
    case 32: return launch_bf16<32>(q, k, v, o, B, Hq, Hkv, S, scale, st);
    case 64: return launch_bf16<64>(q, k, v, o, B, Hq, Hkv, S, scale, st);
    case 128: return launch_bf16<128>(q, k, v, o, B, Hq, Hkv, S, scale, st);
    default: return (int)cudaErrorInvalidValue;
  }
}

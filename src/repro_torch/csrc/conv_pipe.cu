// conv_pipe: fused conv + bias + ReLU (+ max/avg pool), grouped, in one
// launch per fusion group; fp32, int8 with an int32 accumulator, or bf16
// with an fp32 accumulator.
//
// Replaces the TPU kernel src/repro/kernels/conv_pipe.py:conv_pipe (line
// 198, body _conv_pipe_kernel), all three modes. Layouts as there: x NHWC,
// w HWIO (KH, KW, C/G, M), b (M,), out NHWC.
//
// Bound on an H100: operations. fp32 runs FFMA on the CUDA cores (no TF32:
// the reference holds fp32 to 1e-4 at K in the thousands), 66.9 TFLOP/s at
// 132 SMs x 1980 MHz (VGG-16's 13 convs at batch 8: 3.68 ms). The bf16
// and int8 modes run on the tensor cores (conv_bf16_mma_kernel and
// conv_s8_mma_kernel below): their bound is their operations at the dense
// bf16 rate, 1070.5 TFLOP/s (VGG-16: 0.244 ms), and at the dense int8
// rate, 2141 TOP/s (VGG-16: 0.122 ms).
//
// Every mode is an implicit GEMM: a block owns a tile of conv output
// positions (GEMM rows) x output channels of one group (GEMM cols) and
// loops over the reduction K = KH*KW*C/G in chunks inside the block: the
// TPU's sequential C-tile grid axis and its VMEM accumulator become this
// loop and registers. k past the end of the reduction is zero in both
// operands. The im2col gather bounds-checks every input read, so zero
// padding costs no copy (exact in int8: the scheme is symmetric, zero
// point 0). The group is picked by blockIdx.y, which selects the group's
// input-channel slab and weight columns: no per-group launch, no
// concatenate. The epilogue applies the requantize multiplier (int8 mode),
// the bias and ReLU and stages the conv tile in shared memory as fp32, and
// the pool reads its windows from there: the unpooled activation never
// reaches device memory (the paper's Conv->Pool channel). With a pool the
// tile is a 2-D patch of conv rows/cols of one image that covers whole
// pool windows; conv outputs shared by windows of neighbouring tiles are
// recomputed. Without a pool the tile is consecutive positions of the
// flattened (B, OH, OW).
//
// fp32 design (conv_f32_kernel<TPB, TN>): the classic SIMT SGEMM. 256
// threads own a TPB x TN tile (128 or 64 positions x 128 or 64 channels,
// chosen by the wrapper per layer so that small layers still give every SM
// a block), each thread a TPB/16 x TN/16 micro-tile (8x8 at 128x128: per k,
// two 16-byte shared loads of A and two of B feed 64 FFMA), its rows and
// columns in groups of 4 spaced 64 apart so a quarter-warp's B loads hit
// 128 contiguous bytes. K moves in chunks of BKF = 16 with one
// __syncthreads a chunk. B, the group's [k][m] weight slab, is already the
// layout the outer product reads: it streams through a 3-stage cp.async
// ring (16-byte vectors of 4 channels; Mg % 4 != 0 element by element). A
// is the im2col gather, a 16-byte vector being 4 channels of one pixel
// (C/G % 4 == 0: every conv but the first of each model) with its (kh, kw,
// c) advanced without a division; the first convs (C/G = 3) gather element
// by element. The next chunk's A is loaded into registers while the
// current chunk's FFMAs run, then stored transposed ([k][position]) into
// the other of two shared buffers. Products and sums are fp32 FFMA, one
// chain a output in k order. Epilogue: + b (__fadd_rn), ReLU, the tile
// staged as fp32, the pool read from there (max; or avg summed in
// row-major order, then __fdiv_rn), 16-byte stores.
//
// bf16 design: the same implicit GEMM on mma.sync.m16n8k16 (bf16 operands,
// exact products, fp32 sums: what the TPU's MXU computes for this mode). A
// block of 8 warps owns TPB x TN (128 or 64 positions x 128 or 64 channels,
// chosen by the wrapper per layer so that small layers still give a block
// an SM; each warp a 64x32, 32x32 or 32x16 piece) and walks K in chunks of
// BK = 32 through a ring of STAGES = 4 shared-memory stages filled by
// cp.async, so three chunks are in flight while one is multiplied; one
// __syncthreads a chunk. A is the im2col gather: a 16-byte vector is 8
// channels of one pixel (C/G % 8 == 0: every conv but the first of each
// model), its own (kh, kw, c), zero-filled by cp.async's src-size 0 for
// padding, rows past the end and k past K. The first convs (C/G = 3, K = 363
// and 27) gather element by element through registers into the same layout.
// B is a 2-D tile of the group's [k][m] weight slab (Mg % 8 == 0: 16-byte
// vectors, else element by element). Fragments come in through ldmatrix (A)
// and ldmatrix.trans (B, so the [k][m] weights need no transposed copy);
// rows padded by 16 bytes keep both conflict-free. The epilogue is the fp32
// mode's on the fragments: + b (bf16, widened; __fadd_rn), ReLU, the tile
// staged as fp32 in the ring's memory, the pool read from there, one
// __float2bfloat16_rn on store (8 channels a 16-byte store), as the JAX
// kernel rounds it (conv_pipe.py:162-195, out in x's dtype :311).
//
// int8 design (conv_s8_mma_kernel<TPB, TN, TO>): the bf16 skeleton on
// mma.sync.m16n8k32.s32.s8.s8.s32 (int8 products, exact int32 sums: |acc|
// <= 4608 * 127^2 < 2^31, so no saturation), the same tiles and warp
// layout, K in chunks of BK = 128 k (64 for the element gather of the first
// convs, where it wastes less of the last chunk). The int8 mma takes only
// .row.col, so both operands must be k-contiguous in shared memory, and
// ldmatrix.trans moves 16-bit elements, not bytes. A, the im2col gather,
// is k-contiguous already: 16-byte vectors of 16 channels of one pixel
// (C/G % 16 == 0: every conv but the first of each model) through the
// 4-stage cp.async ring, zero-filled by src-size 0; the first convs (C/G =
// 3) and C/G not a multiple of 16 gather element by element into the same
// layout. B, the group's HWIO [k][m] weight slab, is transposed while it
// is staged: each thread loads 4 k rows x 4, 8 or 16 channels (one 4-,
// 8- or 16-byte load a row) into registers one chunk ahead, so the loads
// fly during a chunk's mma, then swaps the bytes with __byte_perm into one
// word of 4 k a channel and stores [channel][k] rows that plain ldmatrix
// reads, into the other of two buffers. No transposed copy of the
// weights exists anywhere. Epilogue on the fragments, step for step as
// the JAX kernel rounds it (conv_pipe.py:165-195): y = float(acc) *
// scale[m], then + b[m] (two roundings, never one FMA), ReLU, the tile
// staged as fp32 in the ring's memory, the pool read from there (max; or
// avg summed in row-major order, then divided), then clip(rint(y /
// out_scale), -127, 127) to int8 (16 channels a 16-byte store, gathered
// from 4 lanes by shuffles; the division taken only where a cheaper
// product could round to another code, quant_code) or y itself as fp32 (4
// a store).
//
// Each tile kernel's dynamic shared memory limit is raised once, at its
// first launch (cudaFuncSetAttribute); a refusal is returned as the error.
#include <cstdint>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "hopper.cuh"

namespace {

constexpr int NT = 256;      // threads per block, every mode

struct Geo {
  int B, H, W, C, KH, KW, Cg, M, Mg, stride, pad, OH, OW;
  int relu, pool, pk, ps, PH, PW;   // pool: 0 none, 1 max, 2 avg
  int tph, tpw, cw, tiles_h, tiles_w, ktot, m_tiles;
  float out_scale;                  // int8 output step (int8 out only)
};

// Tile decode: which image and conv position each row p < tp of this
// block's tile computes (s_img[p] = -1 past the valid rows; s_ih/s_iw the
// input origin of its window, s_pix its flattened output position). With a
// pool the tile is the conv patch under pooled outputs (th, tw) of image
// img; without one, tp consecutive positions of the flattened (B, OH, OW).
__device__ __forceinline__ void decode_rows(const Geo& g, int tp, int tid,
                                            int* s_img, int* s_ih, int* s_iw,
                                            int* s_pix, int& img, int& th,
                                            int& tw) {
  int oh0 = 0, ow0 = 0;
  img = th = tw = 0;
  if (g.pool) {
    const int per_img = g.tiles_h * g.tiles_w;
    img = blockIdx.x / per_img;
    th = (blockIdx.x % per_img) / g.tiles_w;
    tw = blockIdx.x % g.tiles_w;
    oh0 = th * g.tph * g.ps;
    ow0 = tw * g.tpw * g.ps;
  }
  if (tid < tp) {
    int b = -1, oh = 0, ow = 0;
    if (g.pool) {
      const int ch = (g.tph - 1) * g.ps + g.pk;
      const int r = tid / g.cw, c = tid % g.cw;
      oh = oh0 + r;
      ow = ow0 + c;
      if (r < ch && oh < g.OH && ow < g.OW) b = img;
    } else {
      const int q = blockIdx.x * tp + tid;
      if (q < g.B * g.OH * g.OW) {
        b = q / (g.OH * g.OW);
        oh = (q / g.OW) % g.OH;
        ow = q % g.OW;
      }
    }
    s_img[tid] = b;
    s_ih[tid] = oh * g.stride - g.pad;
    s_iw[tid] = ow * g.stride - g.pad;
    s_pix[tid] = b < 0 ? -1 : (b * g.OH + oh) * g.OW + ow;
  }
}

// ---- bf16 mode: implicit GEMM on the tensor cores ------------------------

constexpr int BK = 32;          // reduction chunk, in bf16 (two k16 steps)
constexpr int STAGES = 4;       // cp.async ring depth
constexpr int LDA = BK + 8;     // A row stride in bf16: 80 B, so the 8 rows
                                // of an ldmatrix hit distinct bank groups

// The geometry of one bf16 tile: TPB positions x TN channels, 8 warps in
// WARPS_M x WARPS_N, each a WTM x WTN piece of MI x NI mma tiles.
template <int TPB, int TN> struct BfTile {
  static constexpr int WARPS_M = TPB >= 2 * TN ? 4 : 2;
  static constexpr int WARPS_N = NT / 32 / WARPS_M;
  static constexpr int WTM = TPB / WARPS_M, WTN = TN / WARPS_N;
  static constexpr int MI = WTM / 16, NI = WTN / 8;
  static constexpr int LDB = TN + 8;            // B row stride in bf16
  static constexpr int LDC = TN + 8;            // staged fp32 tile stride
  static constexpr int A_STAGE = TPB * LDA;     // bf16 elements a stage
  static constexpr int STAGE = A_STAGE + BK * LDB;
  static constexpr int RING = STAGES * STAGE * 2;            // bytes
  static constexpr int CTILE = TPB * LDC * 4;                // bytes
  static constexpr int SMEM = RING > CTILE ? RING : CTILE;
  static_assert(MI >= 1 && NI % 2 == 0, "a warp takes whole x4 B loads");
  static_assert(TPB * BK / 8 % NT == 0 && BK * TN / 8 % NT == 0,
                "every thread moves the same number of 16-byte vectors");
};

// avec: x's 16-byte vectors hold 8 channels of one pixel (C/G % 8 == 0, x
// 16-byte aligned); bvec: w's hold 8 output channels of one group (Mg % 8
// == 0, w 16-byte aligned); ovec: out takes 16-byte stores (Mg % 8 == 0).
template <int TPB, int TN>
__global__ void __launch_bounds__(NT, 2)
conv_bf16_mma_kernel(const __nv_bfloat16* __restrict__ x,
                     const __nv_bfloat16* __restrict__ w,
                     const __nv_bfloat16* __restrict__ bias,
                     __nv_bfloat16* __restrict__ out, Geo g, int avec,
                     int bvec, int ovec) {
  using Tl = BfTile<TPB, TN>;
  constexpr int LDB = Tl::LDB, LDC = Tl::LDC;
  extern __shared__ __align__(16) unsigned char smem[];
  __nv_bfloat16* const ring = reinterpret_cast<__nv_bfloat16*>(smem);
  __shared__ int s_img[TPB], s_ih[TPB], s_iw[TPB], s_pix[TPB];

  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  const int grp = blockIdx.y / g.m_tiles;
  const int m0 = (blockIdx.y % g.m_tiles) * TN;
  const int cbase = grp * g.Cg;                 // this group's input slab
  const int obase = grp * g.Mg + m0;            // first output channel
  int img, th, tw;
  decode_rows(g, TPB, tid, s_img, s_ih, s_iw, s_pix, img, th, tw);
  __syncthreads();

  // A, vector path: vector v = tid + NT*i is row v/KV, k offset (v%KV)*8
  // of the chunk; this thread's rows are fixed, its k moves BK a chunk,
  // and its (kh, kw, c) follow k without a division.
  constexpr int KV = BK / 8, AV = TPB * KV / NT;
  const int akv = tid % KV;
  int a_b[AV], a_ih[AV], a_iw[AV];
#pragma unroll
  for (int i = 0; i < AV; ++i) {
    const int p = tid / KV + NT / KV * i;
    a_b[i] = s_img[p];
    a_ih[i] = s_ih[p];
    a_iw[i] = s_iw[p];
  }
  int ak = akv * 8, ac = ak % g.Cg, akw = ak / g.Cg % g.KW,
      akh = ak / (g.Cg * g.KW);

  // Fill ring stage `st` with chunk k0 (chunks are loaded in order, once).
  auto load_stage = [&](int st, int k0) {
    __nv_bfloat16* const As = ring + st * Tl::STAGE;
    __nv_bfloat16* const Bs = As + Tl::A_STAGE;
    if (avec) {
      const bool kin = ak < g.ktot;
#pragma unroll
      for (int i = 0; i < AV; ++i) {
        const int ih = a_ih[i] + akh, iw = a_iw[i] + akw;
        const bool ok = kin && a_b[i] >= 0 && ih >= 0 && ih < g.H &&
                        iw >= 0 && iw < g.W;
        const __nv_bfloat16* src =
            ok ? x + ((size_t)(a_b[i] * g.H + ih) * g.W + iw) * g.C + cbase +
                     ac
               : x;
        cp_async16(smem_u32(As + (tid / KV + NT / KV * i) * LDA + akv * 8),
                   src, ok);
      }
      ak += BK;
      ac += BK;
      while (ac >= g.Cg) {
        ac -= g.Cg;
        if (++akw == g.KW) {
          akw = 0;
          ++akh;
        }
      }
    } else {
      // element by element (C/G = 3): thread column kk, rows tid/BK + i*NT/BK
      const int kk = tid % BK, k = k0 + kk;
      const bool kin = k < g.ktot;
      const int c = k % g.Cg, kw = k / g.Cg % g.KW, kh = k / (g.Cg * g.KW);
#pragma unroll
      for (int i = 0; i < TPB * BK / NT; ++i) {
        const int p = tid / BK + NT / BK * i;
        const int b = s_img[p], ih = s_ih[p] + kh, iw = s_iw[p] + kw;
        __nv_bfloat16 v = __ushort_as_bfloat16((unsigned short)0);
        if (kin && b >= 0 && ih >= 0 && ih < g.H && iw >= 0 && iw < g.W)
          v = x[((size_t)(b * g.H + ih) * g.W + iw) * g.C + cbase + c];
        As[p * LDA + kk] = v;
      }
    }
    if (bvec) {
#pragma unroll
      for (int i = 0; i < BK * TN / 8 / NT; ++i) {
        const int v = tid + NT * i, kr = v / (TN / 8), n = v % (TN / 8) * 8;
        const bool ok = k0 + kr < g.ktot && m0 + n < g.Mg;
        const __nv_bfloat16* src =
            ok ? w + (size_t)(k0 + kr) * g.M + obase + n : w;
        cp_async16(smem_u32(Bs + kr * LDB + n), src, ok);
      }
    } else {
#pragma unroll
      for (int i = 0; i < BK * TN / NT; ++i) {
        const int n = tid % TN, kr = tid / TN + NT / TN * i;
        __nv_bfloat16 v = __ushort_as_bfloat16((unsigned short)0);
        if (k0 + kr < g.ktot && m0 + n < g.Mg)
          v = w[(size_t)(k0 + kr) * g.M + obase + n];
        Bs[kr * LDB + n] = v;
      }
    }
  };

  float acc[Tl::MI][Tl::NI][4];
#pragma unroll
  for (int i = 0; i < Tl::MI; ++i)
#pragma unroll
    for (int j = 0; j < Tl::NI; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] = 0.f;

  const int nk = (g.ktot + BK - 1) / BK;
#pragma unroll
  for (int s = 0; s < STAGES - 1; ++s) {
    if (s < nk) load_stage(s, s * BK);
    cp_async_commit();
  }
  const int wm = warp / Tl::WARPS_N, wn = warp % Tl::WARPS_N;
  // this lane's ldmatrix rows: A rows lane%16 at k half lane/16; B k rows
  // lane%8 (+8 for lanes 8-15 and 24-31) at n half lane/16
  const int a_off = (wm * Tl::WTM + lane % 16) * LDA + lane / 16 * 8;
  const int b_off = (lane % 8 + lane / 8 % 2 * 8) * LDB + wn * Tl::WTN +
                    lane / 16 * 8;
  for (int kt = 0; kt < nk; ++kt) {
    cp_async_wait<STAGES - 2>();    // chunk kt has landed (this thread's)
    __syncthreads();                // ... everyone's; stage kt-1 is free
    const int nxt = kt + STAGES - 1;
    if (nxt < nk) load_stage(nxt % STAGES, nxt * BK);
    cp_async_commit();
    const __nv_bfloat16* As = ring + kt % STAGES * Tl::STAGE;
    const __nv_bfloat16* Bs = As + Tl::A_STAGE;
#pragma unroll
    for (int ks = 0; ks < BK; ks += 16) {
      uint32_t a[Tl::MI][4], b[Tl::NI][2];
#pragma unroll
      for (int i = 0; i < Tl::MI; ++i)
        ldmatrix_x4(a[i], smem_u32(As + a_off + i * 16 * LDA + ks));
#pragma unroll
      for (int j = 0; j < Tl::NI; j += 2) {
        uint32_t r[4];
        ldmatrix_x4_trans(r, smem_u32(Bs + b_off + ks * LDB + j * 8));
        b[j][0] = r[0];
        b[j][1] = r[1];
        b[j + 1][0] = r[2];
        b[j + 1][1] = r[3];
      }
#pragma unroll
      for (int i = 0; i < Tl::MI; ++i)
#pragma unroll
        for (int j = 0; j < Tl::NI; ++j)
          mma_bf16(acc[i][j], a[i], b[j][0], b[j][1]);
    }
  }
  cp_async_wait<0>();
  __syncthreads();                  // the ring is free for the staged tile

  // epilogue 1: + bias, ReLU on the fragments, staged as fp32 (a lane holds
  // rows lane/4 and +8, columns 2*(lane%4) and +1 of each mma tile)
  float* const Cs = reinterpret_cast<float*>(smem);
#pragma unroll
  for (int j = 0; j < Tl::NI; ++j) {
    const int col = wn * Tl::WTN + j * 8 + lane % 4 * 2;
    const int m = m0 + col;
    const float b0 = m < g.Mg ? __bfloat162float(bias[grp * g.Mg + m]) : 0.f;
    const float b1 =
        m + 1 < g.Mg ? __bfloat162float(bias[grp * g.Mg + m + 1]) : 0.f;
#pragma unroll
    for (int i = 0; i < Tl::MI; ++i)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        float v0 = __fadd_rn(acc[i][j][2 * h], b0);
        float v1 = __fadd_rn(acc[i][j][2 * h + 1], b1);
        if (g.relu) {
          v0 = fmaxf(v0, 0.f);
          v1 = fmaxf(v1, 0.f);
        }
        const int row = wm * Tl::WTM + i * 16 + lane / 4 + 8 * h;
        *reinterpret_cast<float2*>(&Cs[row * LDC + col]) =
            make_float2(v0, v1);
      }
  }
  __syncthreads();

  // epilogue 2: pool windows out of the staged tile (or copy it out), 8
  // channels at a time, one rounding to bf16 on store
  const int nq = g.pool ? g.tph * g.tpw : TPB;
  const int mvalid = min(TN, g.Mg - m0);
  for (int idx = tid; idx < nq * (TN / 8); idx += NT) {
    const int m = idx % (TN / 8) * 8, q = idx / (TN / 8);
    if (m >= mvalid) continue;
    auto load8 = [&](int row, float (&u)[8]) {
      const float4 lo = *reinterpret_cast<const float4*>(&Cs[row * LDC + m]);
      const float4 hi =
          *reinterpret_cast<const float4*>(&Cs[row * LDC + m + 4]);
      u[0] = lo.x; u[1] = lo.y; u[2] = lo.z; u[3] = lo.w;
      u[4] = hi.x; u[5] = hi.y; u[6] = hi.z; u[7] = hi.w;
    };
    float v[8];
    size_t o;
    if (g.pool) {
      const int qh = q / g.tpw, qw = q % g.tpw;
      const int ph = th * g.tph + qh, pw = tw * g.tpw + qw;
      if (ph >= g.PH || pw >= g.PW) continue;
      const int r0 = qh * g.ps, c0 = qw * g.ps;
      load8(r0 * g.cw + c0, v);
      for (int i = 0; i < g.pk; ++i)
        for (int j = 0; j < g.pk; ++j) {
          if (i == 0 && j == 0) continue;
          float u[8];
          load8((r0 + i) * g.cw + c0 + j, u);
#pragma unroll
          for (int e = 0; e < 8; ++e)
            v[e] = g.pool == 1 ? fmaxf(v[e], u[e]) : __fadd_rn(v[e], u[e]);
        }
      if (g.pool == 2)
#pragma unroll
        for (int e = 0; e < 8; ++e)
          v[e] = __fdiv_rn(v[e], (float)(g.pk * g.pk));
      o = ((size_t)(img * g.PH + ph) * g.PW + pw) * g.M + obase + m;
    } else {
      const int pix = s_pix[q];
      if (pix < 0) continue;
      load8(q, v);
      o = (size_t)pix * g.M + obase + m;
    }
    if (ovec && m + 8 <= mvalid) {
      __align__(16) __nv_bfloat162 h[4];
#pragma unroll
      for (int e = 0; e < 4; ++e)
        h[e] = __floats2bfloat162_rn(v[2 * e], v[2 * e + 1]);
      *reinterpret_cast<uint4*>(out + o) = *reinterpret_cast<const uint4*>(h);
    } else {
#pragma unroll
      for (int e = 0; e < 8; ++e)
        if (m + e < mvalid) out[o + e] = __float2bfloat16_rn(v[e]);
    }
  }
}

// ---- fp32 mode: register-blocked implicit GEMM on the CUDA cores ---------

constexpr int BKF = 16;         // reduction chunk, in fp32
constexpr int STAGES_F = 3;     // cp.async ring depth of the weight slab

// The geometry of one fp32 tile: TPB positions x TN channels, a 16 x 16
// grid of threads, each an RM x RN micro-tile whose rows (columns) are
// groups of 4 spaced 64 apart. Rows padded by 16 bytes.
template <int TPB, int TN> struct F32Tile {
  static constexpr int RM = TPB / 16, RN = TN / 16;
  static constexpr int LDA = TPB + 4;           // A, [k][position]
  static constexpr int LDB = TN + 4;            // B, [k][channel]
  static constexpr int LDC = TN + 4;            // the staged fp32 tile
  static constexpr int A_BUF = BKF * LDA;       // floats, one of two buffers
  static constexpr int B_STAGE = BKF * LDB;     // floats, one ring stage
  static constexpr int RING = (2 * A_BUF + STAGES_F * B_STAGE) * 4;  // bytes
  static constexpr int CTILE = TPB * LDC * 4;                        // bytes
  static constexpr int SMEM = RING > CTILE ? RING : CTILE;
  static constexpr int KV = BKF / 4;            // A vectors along k a chunk
  static constexpr int AV = TPB * KV / NT;      // A vectors a thread
  static constexpr int AE = TPB * BKF / NT;     // A elements a thread
  static constexpr int BV = BKF * TN / 4 / NT;  // B vectors a thread
  static_assert(RM % 4 == 0 && RN % 4 == 0 && AV >= 1 && BV >= 1 &&
                    AE == 4 * AV,
                "whole groups of 4; every thread moves the same vectors");
};

// avec: x's 16-byte vectors hold 4 channels of one pixel (C/G % 4 == 0, x
// 16-byte aligned); bvec: w's hold 4 output channels of one group (Mg % 4
// == 0, w 16-byte aligned); ovec: out takes 16-byte stores (Mg % 4 == 0).
template <int TPB, int TN>
__global__ void __launch_bounds__(NT, 2)
conv_f32_kernel(const float* __restrict__ x, const float* __restrict__ w,
                const float* __restrict__ bias, float* __restrict__ out,
                Geo g, int avec, int bvec, int ovec) {
  using Tl = F32Tile<TPB, TN>;
  constexpr int RM = Tl::RM, RN = Tl::RN, KV = Tl::KV;
  constexpr int LDA = Tl::LDA, LDB = Tl::LDB, LDC = Tl::LDC;
  extern __shared__ __align__(16) unsigned char smem[];
  float* const As = reinterpret_cast<float*>(smem);     // 2 x [BKF][LDA]
  float* const Bs = As + 2 * Tl::A_BUF;                 // ring, [BKF][LDB]
  __shared__ int s_img[TPB], s_ih[TPB], s_iw[TPB], s_pix[TPB];

  const int tid = threadIdx.x;
  const int grp = blockIdx.y / g.m_tiles;
  const int m0 = (blockIdx.y % g.m_tiles) * TN;
  const int cbase = grp * g.Cg;                 // this group's input slab
  const int obase = grp * g.Mg + m0;            // first output channel
  int img, th, tw;
  decode_rows(g, TPB, tid, s_img, s_ih, s_iw, s_pix, img, th, tw);
  __syncthreads();

  // A, vector path: vector v = tid + NT*i is row v/KV, k offset (v%KV)*4
  // of the chunk; this thread's rows are fixed, its k moves BKF a chunk,
  // and its (kh, kw, c) follow k without a division.
  const int akv = tid % KV;
  int a_b[Tl::AV], a_ih[Tl::AV], a_iw[Tl::AV];
#pragma unroll
  for (int i = 0; i < Tl::AV; ++i) {
    const int p = tid / KV + NT / KV * i;
    a_b[i] = s_img[p];
    a_ih[i] = s_ih[p];
    a_iw[i] = s_iw[p];
  }
  int ak = akv * 4, ac = ak % g.Cg, akw = ak / g.Cg % g.KW,
      akh = ak / (g.Cg * g.KW);

  // The next A chunk, into registers (chunks are loaded in order, once).
  float areg[Tl::AE];
  auto load_a = [&](int k0) {
    if (avec) {
      const bool kin = ak < g.ktot;
#pragma unroll
      for (int i = 0; i < Tl::AV; ++i) {
        const int ih = a_ih[i] + akh, iw = a_iw[i] + akw;
        float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
        if (kin && a_b[i] >= 0 && ih >= 0 && ih < g.H && iw >= 0 && iw < g.W)
          v = __ldg(reinterpret_cast<const float4*>(
              x + ((size_t)(a_b[i] * g.H + ih) * g.W + iw) * g.C + cbase +
              ac));
        areg[4 * i] = v.x;
        areg[4 * i + 1] = v.y;
        areg[4 * i + 2] = v.z;
        areg[4 * i + 3] = v.w;
      }
      ak += BKF;
      ac += BKF;
      while (ac >= g.Cg) {
        ac -= g.Cg;
        if (++akw == g.KW) {
          akw = 0;
          ++akh;
        }
      }
    } else {
      // element by element (C/G = 3): thread column kk, rows tid/BKF + 16i
      const int kk = tid % BKF, k = k0 + kk;
      const bool kin = k < g.ktot;
      const int c = k % g.Cg, kw = k / g.Cg % g.KW, kh = k / (g.Cg * g.KW);
#pragma unroll
      for (int i = 0; i < Tl::AE; ++i) {
        const int p = tid / BKF + NT / BKF * i;
        const int b = s_img[p], ih = s_ih[p] + kh, iw = s_iw[p] + kw;
        areg[i] = kin && b >= 0 && ih >= 0 && ih < g.H && iw >= 0 && iw < g.W
                      ? __ldg(&x[((size_t)(b * g.H + ih) * g.W + iw) * g.C +
                                 cbase + c])
                      : 0.f;
      }
    }
  };
  // ... and from registers into buffer Ab, transposed to [k][position]
  auto store_a = [&](float* Ab) {
    if (avec) {
#pragma unroll
      for (int i = 0; i < Tl::AV; ++i)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          Ab[(akv * 4 + e) * LDA + tid / KV + NT / KV * i] = areg[4 * i + e];
    } else {
#pragma unroll
      for (int i = 0; i < Tl::AE; ++i)
        Ab[tid % BKF * LDA + tid / BKF + NT / BKF * i] = areg[i];
    }
  };
  // Fill ring stage `st` with the weight chunk at k0.
  auto load_b = [&](int st, int k0) {
    float* const Bb = Bs + st * Tl::B_STAGE;
    if (bvec) {
#pragma unroll
      for (int i = 0; i < Tl::BV; ++i) {
        const int v = tid + NT * i, kr = v / (TN / 4), n = v % (TN / 4) * 4;
        const bool ok = k0 + kr < g.ktot && m0 + n < g.Mg;
        const float* src = ok ? w + (size_t)(k0 + kr) * g.M + obase + n : w;
        cp_async16(smem_u32(Bb + kr * LDB + n), src, ok);
      }
    } else {
#pragma unroll
      for (int i = 0; i < BKF * TN / NT; ++i) {
        const int n = tid % TN, kr = tid / TN + NT / TN * i;
        Bb[kr * LDB + n] = k0 + kr < g.ktot && m0 + n < g.Mg
                               ? w[(size_t)(k0 + kr) * g.M + obase + n]
                               : 0.f;
      }
    }
  };

  float acc[RM][RN];
#pragma unroll
  for (int i = 0; i < RM; ++i)
#pragma unroll
    for (int j = 0; j < RN; ++j) acc[i][j] = 0.f;

  const int nk = (g.ktot + BKF - 1) / BKF;
#pragma unroll
  for (int s = 0; s < STAGES_F - 1; ++s) {
    if (s < nk) load_b(s, s * BKF);
    cp_async_commit();
  }
  load_a(0);
  store_a(As);
  const int tx = tid % 16, ty = tid / 16;       // channel and position group
  for (int kt = 0; kt < nk; ++kt) {
    if (kt + 1 < nk) load_a((kt + 1) * BKF);    // in flight during the FFMAs
    cp_async_wait<STAGES_F - 2>();  // weight chunk kt has landed (this
    __syncthreads();                // thread's), everyone's, and A chunk
                                    // kt; chunk kt-1's buffers are free
    const int nxt = kt + STAGES_F - 1;
    if (nxt < nk) load_b(nxt % STAGES_F, nxt * BKF);
    cp_async_commit();
    const float* Ab = As + kt % 2 * Tl::A_BUF;
    const float* Bb = Bs + kt % STAGES_F * Tl::B_STAGE;
#pragma unroll
    for (int kk = 0; kk < BKF; ++kk) {
      float a[RM], b[RN];
#pragma unroll
      for (int q = 0; q < RM / 4; ++q) {
        const float4 v =
            *reinterpret_cast<const float4*>(&Ab[kk * LDA + q * 64 + ty * 4]);
        a[4 * q] = v.x; a[4 * q + 1] = v.y; a[4 * q + 2] = v.z;
        a[4 * q + 3] = v.w;
      }
#pragma unroll
      for (int q = 0; q < RN / 4; ++q) {
        const float4 v =
            *reinterpret_cast<const float4*>(&Bb[kk * LDB + q * 64 + tx * 4]);
        b[4 * q] = v.x; b[4 * q + 1] = v.y; b[4 * q + 2] = v.z;
        b[4 * q + 3] = v.w;
      }
#pragma unroll
      for (int i = 0; i < RM; ++i)
#pragma unroll
        for (int j = 0; j < RN; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
    }
    if (kt + 1 < nk) store_a(As + (kt + 1) % 2 * Tl::A_BUF);
  }
  cp_async_wait<0>();
  __syncthreads();                  // the buffers are free for the tile

  // epilogue 1: + bias, ReLU, the conv tile to shared memory as fp32
  float* const Cs = reinterpret_cast<float*>(smem);
#pragma unroll
  for (int q = 0; q < RN / 4; ++q) {
    const int col = q * 64 + tx * 4;
    float bj[4];
#pragma unroll
    for (int e = 0; e < 4; ++e)
      bj[e] = m0 + col + e < g.Mg ? bias[obase + col + e] : 0.f;
#pragma unroll
    for (int i = 0; i < RM; ++i) {
      float v[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        v[e] = __fadd_rn(acc[i][4 * q + e], bj[e]);
        if (g.relu) v[e] = fmaxf(v[e], 0.f);
      }
      const int row = i / 4 * 64 + ty * 4 + i % 4;
      *reinterpret_cast<float4*>(&Cs[row * LDC + col]) =
          make_float4(v[0], v[1], v[2], v[3]);
    }
  }
  __syncthreads();

  // epilogue 2: pool windows out of the staged tile (or copy it out), 4
  // channels at a time
  const int nq = g.pool ? g.tph * g.tpw : TPB;
  const int mvalid = min(TN, g.Mg - m0);
  for (int idx = tid; idx < nq * (TN / 4); idx += NT) {
    const int m = idx % (TN / 4) * 4, q = idx / (TN / 4);
    if (m >= mvalid) continue;
    float4 v;
    size_t o;
    if (g.pool) {
      const int qh = q / g.tpw, qw = q % g.tpw;
      const int ph = th * g.tph + qh, pw = tw * g.tpw + qw;
      if (ph >= g.PH || pw >= g.PW) continue;
      const int r0 = qh * g.ps, c0 = qw * g.ps;
      v = *reinterpret_cast<const float4*>(&Cs[(r0 * g.cw + c0) * LDC + m]);
      for (int i = 0; i < g.pk; ++i)
        for (int j = 0; j < g.pk; ++j) {
          if (i == 0 && j == 0) continue;
          const float4 u = *reinterpret_cast<const float4*>(
              &Cs[((r0 + i) * g.cw + c0 + j) * LDC + m]);
          if (g.pool == 1) {
            v.x = fmaxf(v.x, u.x); v.y = fmaxf(v.y, u.y);
            v.z = fmaxf(v.z, u.z); v.w = fmaxf(v.w, u.w);
          } else {
            v.x = __fadd_rn(v.x, u.x); v.y = __fadd_rn(v.y, u.y);
            v.z = __fadd_rn(v.z, u.z); v.w = __fadd_rn(v.w, u.w);
          }
        }
      if (g.pool == 2) {
        const float n = (float)(g.pk * g.pk);
        v.x = __fdiv_rn(v.x, n); v.y = __fdiv_rn(v.y, n);
        v.z = __fdiv_rn(v.z, n); v.w = __fdiv_rn(v.w, n);
      }
      o = ((size_t)(img * g.PH + ph) * g.PW + pw) * g.M + obase + m;
    } else {
      const int pix = s_pix[q];
      if (pix < 0) continue;
      v = *reinterpret_cast<const float4*>(&Cs[q * LDC + m]);
      o = (size_t)pix * g.M + obase + m;
    }
    if (ovec && m + 4 <= mvalid) {
      *reinterpret_cast<float4*>(out + o) = v;
    } else {
      const float e[4] = {v.x, v.y, v.z, v.w};
      for (int j = 0; j < 4 && m + j < mvalid; ++j) out[o + j] = e[j];
    }
  }
}

// ---- int8 mode: implicit GEMM on the int8 tensor cores ------------------

// The geometry of one int8 tile: TPB positions x TN channels, 8 warps laid
// out as in the bf16 tile, BK k a chunk. A (the gather, [position][k]) runs
// through the STAGES-deep ring; B ([channel][k], transposed from the
// weights' [k][m]) through two buffers, a thread 4 k x CB channels of it.
template <int TPB, int TN, int BK> struct S8Tile {
  static constexpr int WARPS_M = TPB >= 2 * TN ? 4 : 2;
  static constexpr int WARPS_N = NT / 32 / WARPS_M;
  static constexpr int WTM = TPB / WARPS_M, WTN = TN / WARPS_N;
  static constexpr int MI = WTM / 16, NI = WTN / 8;
  static constexpr int LDC = TN + 8;            // staged fp32 tile stride
  static constexpr int LDS = BK + 16;           // A and B row stride in
                                                // bytes: the 8 rows of an
                                                // ldmatrix hit distinct banks
  static constexpr int A_STAGE = TPB * LDS;     // bytes
  static constexpr int B_BUF = TN * LDS;        // bytes
  static constexpr int RING = STAGES * A_STAGE + 2 * B_BUF;
  static constexpr int CTILE = TPB * LDC * 4;                // bytes
  static constexpr int SMEM = RING > CTILE ? RING : CTILE;
  static constexpr int KV = BK / 16;            // A vectors along k a chunk
  static constexpr int AV = TPB * KV / NT;      // A vectors a thread
  static constexpr int CB = TN * BK / 4 / NT;   // B channels a thread
  static_assert(MI >= 1 && NI % 2 == 0, "a warp takes whole x4 B loads");
  static_assert(AV >= 1 && TPB * KV % NT == 0 && TPB * BK % NT == 0,
                "every thread moves the same A vectors");
  static_assert(BK % 32 == 0 && BK / 4 * (TN / CB) == NT && CB % 4 == 0,
                "the threads cover B's 4-k x CB-channel pieces once");
};

// The int8 code of v, clip(rint(v / out_scale), -127, 127), with the
// quotient rounded as __fdiv_rn rounds it, but without the division where it
// cannot matter: t = v * inv (inv = 1 / out_scale, rounded) lies within 1.5
// * 2^-23 * |t| of the rounded quotient q, so where t is more than |t| *
// 2^-20 from the half-integer between its two nearest integers, t and q lie
// on the same side of it and rint(t) == rint(q); nearer (or |t| >= 2^21),
// the division decides.
__device__ __forceinline__ float quant_code(float v, float out_scale,
                                            float inv) {
  const float t = __fmul_rn(v, inv);
  const float h = floorf(t) + 0.5f;
  const float q =
      fabsf(t - h) > fabsf(t) * 0x1p-20f ? t : __fdiv_rn(v, out_scale);
  return fminf(fmaxf(rintf(q), -127.f), 127.f);
}

// avec: x's 16-byte vectors hold 16 channels of one pixel (C/G % 16 == 0, x
// 16-byte aligned); bvec: w's rows hold CB channels of one group in one
// aligned load (Mg % CB == 0, w CB-byte aligned); ovec: out takes 16-byte
// stores (Mg % 16 == 0 for int8 out, Mg % 4 == 0 for fp32 out).
template <int TPB, int TN, int BK, typename TO>
__global__ void __launch_bounds__(NT, 2)
conv_s8_mma_kernel(const int8_t* __restrict__ x, const int8_t* __restrict__ w,
                   const float* __restrict__ bias,
                   const float* __restrict__ scale, TO* __restrict__ out,
                   Geo g, int avec, int bvec, int ovec) {
  using Tl = S8Tile<TPB, TN, BK>;
  constexpr int LDC = Tl::LDC, KV = Tl::KV, AV = Tl::AV, CB = Tl::CB;
  constexpr int BK8 = BK, LDS8 = Tl::LDS;
  extern __shared__ __align__(16) unsigned char smem[];
  int8_t* const ring = reinterpret_cast<int8_t*>(smem);     // A stages
  int8_t* const bbuf = ring + STAGES * Tl::A_STAGE;         // 2 B buffers
  __shared__ int s_img[TPB], s_ih[TPB], s_iw[TPB], s_pix[TPB];

  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  const int grp = blockIdx.y / g.m_tiles;
  const int m0 = (blockIdx.y % g.m_tiles) * TN;
  const int cbase = grp * g.Cg;                 // this group's input slab
  const int obase = grp * g.Mg + m0;            // first output channel
  int img, th, tw;
  decode_rows(g, TPB, tid, s_img, s_ih, s_iw, s_pix, img, th, tw);
  __syncthreads();

  // A, vector path: vector v = tid + NT*i is row v/KV, k offset (v%KV)*16
  // of the chunk; this thread's rows are fixed, its k moves BK8 a chunk,
  // and its (kh, kw, c) follow k without a division.
  const int akv = tid % KV;
  int a_b[AV], a_ih[AV], a_iw[AV];
#pragma unroll
  for (int i = 0; i < AV; ++i) {
    const int p = tid / KV + NT / KV * i;
    a_b[i] = s_img[p];
    a_ih[i] = s_ih[p];
    a_iw[i] = s_iw[p];
  }
  int ak = akv * 16, ac = ak % g.Cg, akw = ak / g.Cg % g.KW,
      akh = ak / (g.Cg * g.KW);

  // Fill ring stage `st` with A's chunk k0 (chunks are loaded in order).
  auto load_a = [&](int st, int k0) {
    int8_t* const As = ring + st * Tl::A_STAGE;
    if (avec) {
      const bool kin = ak < g.ktot;
#pragma unroll
      for (int i = 0; i < AV; ++i) {
        const int ih = a_ih[i] + akh, iw = a_iw[i] + akw;
        const bool ok = kin && a_b[i] >= 0 && ih >= 0 && ih < g.H &&
                        iw >= 0 && iw < g.W;
        const int8_t* src =
            ok ? x + ((size_t)(a_b[i] * g.H + ih) * g.W + iw) * g.C + cbase +
                     ac
               : x;
        cp_async16(smem_u32(As + (tid / KV + NT / KV * i) * LDS8 + akv * 16),
                   src, ok);
      }
      ak += BK8;
      ac += BK8;
      while (ac >= g.Cg) {
        ac -= g.Cg;
        if (++akw == g.KW) {
          akw = 0;
          ++akh;
        }
      }
    } else {
      // element by element: thread column kk, rows tid/BK8 + i*NT/BK8
      const int kk = tid % BK8, k = k0 + kk;
      const bool kin = k < g.ktot;
      const int c = k % g.Cg, kw = k / g.Cg % g.KW, kh = k / (g.Cg * g.KW);
#pragma unroll
      for (int i = 0; i < TPB * BK8 / NT; ++i) {
        const int p = tid / BK8 + NT / BK8 * i;
        const int b = s_img[p], ih = s_ih[p] + kh, iw = s_iw[p] + kw;
        int8_t v = 0;
        if (kin && b >= 0 && ih >= 0 && ih < g.H && iw >= 0 && iw < g.W)
          v = x[((size_t)(b * g.H + ih) * g.W + iw) * g.C + cbase + c];
        As[p * LDS8 + kk] = v;
      }
    }
  };

  // B: this thread's 4 k rows (bkq*4 ..) x CB channels (bcg*CB ..) of a
  // chunk, loaded into registers (4 channels a word, byte j channel j) one
  // chunk ahead of its use, so the loads fly during a chunk's mma ...
  const int bkq = tid % (BK8 / 4), bcg = tid / (BK8 / 4);
  uint32_t r[4][CB / 4];
  auto load_b = [&](int k0) {
    const int n = bcg * CB;
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int k = k0 + bkq * 4 + e;
      const bool kin = k < g.ktot;
      const int8_t* row = w + (size_t)(kin ? k : 0) * g.M + obase + n;
      if (bvec) {
        const bool ok = kin && m0 + n < g.Mg;
        if constexpr (CB == 16) {
          const uint4 v = ok ? __ldg(reinterpret_cast<const uint4*>(row))
                             : make_uint4(0u, 0u, 0u, 0u);
          r[e][0] = v.x;
          r[e][1] = v.y;
          r[e][2] = v.z;
          r[e][3] = v.w;
        } else if constexpr (CB == 8) {
          const uint2 v = ok ? __ldg(reinterpret_cast<const uint2*>(row))
                             : make_uint2(0u, 0u);
          r[e][0] = v.x;
          r[e][1] = v.y;
        } else {
          r[e][0] = ok ? __ldg(reinterpret_cast<const unsigned int*>(row))
                       : 0u;
        }
      } else {
#pragma unroll
        for (int q = 0; q < CB / 4; ++q) {
          uint32_t v = 0;
#pragma unroll
          for (int j = 0; j < 4; ++j)
            if (kin && m0 + n + 4 * q + j < g.Mg)
              v |= (uint32_t)(uint8_t)row[4 * q + j] << (8 * j);
          r[e][q] = v;
        }
      }
    }
  };
  // ... and from there into buffer Bb as [channel][k]: each 4 k x 4
  // channels transposed by __byte_perm into one word of 4 k a channel
  auto store_b = [&](int8_t* Bb) {
#pragma unroll
    for (int q = 0; q < CB / 4; ++q) {
      const uint32_t t0 = __byte_perm(r[0][q], r[1][q], 0x5140);
      const uint32_t t1 = __byte_perm(r[0][q], r[1][q], 0x7362);
      const uint32_t t2 = __byte_perm(r[2][q], r[3][q], 0x5140);
      const uint32_t t3 = __byte_perm(r[2][q], r[3][q], 0x7362);
      const uint32_t c[4] = {__byte_perm(t0, t2, 0x5410),
                             __byte_perm(t0, t2, 0x7632),
                             __byte_perm(t1, t3, 0x5410),
                             __byte_perm(t1, t3, 0x7632)};
#pragma unroll
      for (int j = 0; j < 4; ++j)
        *reinterpret_cast<uint32_t*>(
            Bb + (bcg * CB + 4 * q + j) * LDS8 + bkq * 4) = c[j];
    }
  };

  int acc[Tl::MI][Tl::NI][4];
#pragma unroll
  for (int i = 0; i < Tl::MI; ++i)
#pragma unroll
    for (int j = 0; j < Tl::NI; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] = 0;

  // B's first chunk before A's, so its loads fly during A's first gathers
  const int nk = (g.ktot + BK8 - 1) / BK8;
  load_b(0);
#pragma unroll
  for (int s = 0; s < STAGES - 1; ++s) {
    if (s < nk) load_a(s, s * BK8);
    cp_async_commit();
  }
  store_b(bbuf);
  const int wm = warp / Tl::WARPS_N, wn = warp % Tl::WARPS_N;
  // this lane's ldmatrix rows: A rows lane%16 at k half lane/16; B channel
  // rows lane%8 (+8 for lanes 16-31) at k half lane/8%2
  const int a_off = (wm * Tl::WTM + lane % 16) * LDS8 + lane / 16 * 16;
  const int b_off =
      (wn * Tl::WTN + lane % 8 + lane / 16 * 8) * LDS8 + lane / 8 % 2 * 16;
  for (int kt = 0; kt < nk; ++kt) {
    if (kt + 1 < nk) load_b((kt + 1) * BK8);    // in flight during the mma
    cp_async_wait<STAGES - 2>();    // A chunk kt has landed (this thread's)
    __syncthreads();                // ... everyone's, and B chunk kt; chunk
                                    // kt-1's stage and buffer are free
    const int nxt = kt + STAGES - 1;
    if (nxt < nk) load_a(nxt % STAGES, nxt * BK8);
    cp_async_commit();
    const int8_t* As = ring + kt % STAGES * Tl::A_STAGE;
    const int8_t* Bb = bbuf + kt % 2 * Tl::B_BUF;
#pragma unroll
    for (int ks = 0; ks < BK8; ks += 32) {
      uint32_t a[Tl::MI][4], b[Tl::NI][2];
#pragma unroll
      for (int i = 0; i < Tl::MI; ++i)
        ldmatrix_x4(a[i], smem_u32(As + a_off + i * 16 * LDS8 + ks));
#pragma unroll
      for (int j = 0; j < Tl::NI; j += 2) {
        uint32_t f[4];
        ldmatrix_x4(f, smem_u32(Bb + b_off + j * 8 * LDS8 + ks));
        b[j][0] = f[0];
        b[j][1] = f[1];
        b[j + 1][0] = f[2];
        b[j + 1][1] = f[3];
      }
#pragma unroll
      for (int i = 0; i < Tl::MI; ++i)
#pragma unroll
        for (int j = 0; j < Tl::NI; ++j)
          mma_s8(acc[i][j], a[i], b[j][0], b[j][1]);
    }
    if (kt + 1 < nk) store_b(bbuf + (kt + 1) % 2 * Tl::B_BUF);
  }
  cp_async_wait<0>();
  __syncthreads();                  // the ring is free for the staged tile

  // epilogue 1: requantize, + bias (two roundings), ReLU on the fragments,
  // staged as fp32 (a lane holds rows lane/4 and +8, columns 2*(lane%4)
  // and +1 of each mma tile)
  float* const Cs = reinterpret_cast<float*>(smem);
#pragma unroll
  for (int j = 0; j < Tl::NI; ++j) {
    const int col = wn * Tl::WTN + j * 8 + lane % 4 * 2;
    const int m = m0 + col;
    const float b0 = m < g.Mg ? bias[grp * g.Mg + m] : 0.f;
    const float b1 = m + 1 < g.Mg ? bias[grp * g.Mg + m + 1] : 0.f;
    const float s0 = m < g.Mg ? scale[grp * g.Mg + m] : 0.f;
    const float s1 = m + 1 < g.Mg ? scale[grp * g.Mg + m + 1] : 0.f;
#pragma unroll
    for (int i = 0; i < Tl::MI; ++i)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        float v0 = __fadd_rn(__fmul_rn(__int2float_rn(acc[i][j][2 * h]), s0),
                             b0);
        float v1 = __fadd_rn(
            __fmul_rn(__int2float_rn(acc[i][j][2 * h + 1]), s1), b1);
        if (g.relu) {
          v0 = fmaxf(v0, 0.f);
          v1 = fmaxf(v1, 0.f);
        }
        const int row = wm * Tl::WTM + i * 16 + lane / 4 + 8 * h;
        *reinterpret_cast<float2*>(&Cs[row * LDC + col]) =
            make_float2(v0, v1);
      }
  }
  __syncthreads();

  // epilogue 2: pool windows out of the staged tile (or copy it out). A
  // lane takes 4 channels, consecutive lanes consecutive channels (16-byte
  // shared loads without bank conflicts); with int8 out the 4 lanes of 16
  // channels meet by shuffles in one 16-byte store, with fp32 out each
  // lane stores its 4. The loop runs whole warps for the shuffles.
  const int nq = g.pool ? g.tph * g.tpw : TPB;
  const int mvalid = min(TN, g.Mg - m0);
  const int n_items = (nq * (TN / 4) + 31) / 32 * 32;
  const float inv = __frcp_rn(g.out_scale);
  for (int idx = tid; idx < n_items; idx += NT) {
    const int m = idx % (TN / 4) * 4, q = idx / (TN / 4);
    bool ok = q < nq && m < mvalid;
    float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
    size_t o = 0;
    if (ok && g.pool) {
      const int qh = q / g.tpw, qw = q % g.tpw;
      const int ph = th * g.tph + qh, pw = tw * g.tpw + qw;
      ok = ph < g.PH && pw < g.PW;
      if (ok) {
        const int r0 = qh * g.ps, c0 = qw * g.ps;
        v = *reinterpret_cast<const float4*>(&Cs[(r0 * g.cw + c0) * LDC + m]);
        for (int i = 0; i < g.pk; ++i)
          for (int j = 0; j < g.pk; ++j) {
            if (i == 0 && j == 0) continue;
            const float4 u = *reinterpret_cast<const float4*>(
                &Cs[((r0 + i) * g.cw + c0 + j) * LDC + m]);
            if (g.pool == 1) {
              v.x = fmaxf(v.x, u.x); v.y = fmaxf(v.y, u.y);
              v.z = fmaxf(v.z, u.z); v.w = fmaxf(v.w, u.w);
            } else {
              v.x = __fadd_rn(v.x, u.x); v.y = __fadd_rn(v.y, u.y);
              v.z = __fadd_rn(v.z, u.z); v.w = __fadd_rn(v.w, u.w);
            }
          }
        if (g.pool == 2) {
          const float n = (float)(g.pk * g.pk);
          v.x = __fdiv_rn(v.x, n); v.y = __fdiv_rn(v.y, n);
          v.z = __fdiv_rn(v.z, n); v.w = __fdiv_rn(v.w, n);
        }
        o = ((size_t)(img * g.PH + ph) * g.PW + pw) * g.M + obase + m;
      }
    } else if (ok) {
      const int pix = s_pix[q];
      ok = pix >= 0;
      if (ok) {
        v = *reinterpret_cast<const float4*>(&Cs[q * LDC + m]);
        o = (size_t)pix * g.M + obase + m;
      }
    }
    const float e[4] = {v.x, v.y, v.z, v.w};
    if constexpr (sizeof(TO) == 1) {
      uint32_t word = 0;
#pragma unroll
      for (int j = 0; j < 4; ++j)
        word |= (uint32_t)(uint8_t)(int8_t)quant_code(e[j], g.out_scale, inv)
                << (8 * j);
      // the words of channels m+4, m+8, m+12 (lanes +1, +2, +3)
      const uint32_t w1 = __shfl_down_sync(0xffffffffu, word, 1);
      const uint32_t w2 = __shfl_down_sync(0xffffffffu, word, 2);
      const uint32_t w3 = __shfl_down_sync(0xffffffffu, word, 3);
      const int m16 = m - lane % 4 * 4;         // the piece's first channel
      if (!ok) continue;
      if (ovec && m16 + 16 <= mvalid) {
        if (lane % 4 == 0)
          *reinterpret_cast<uint4*>(out + o) = make_uint4(word, w1, w2, w3);
      } else {
        for (int j = 0; j < 4 && m + j < mvalid; ++j)
          out[o + j] = (int8_t)(word >> (8 * j));
      }
    } else {
      if (!ok) continue;
      if (ovec && m + 4 <= mvalid) {
        *reinterpret_cast<float4*>(out + o) = v;
      } else {
        for (int j = 0; j < 4 && m + j < mvalid; ++j) out[o + j] = e[j];
      }
    }
  }
}

Geo make_geo(int B, int H, int W, int C, int KH, int KW, int M, int groups,
             int stride, int pad, int relu, int pool, int pk, int ps,
             int tph, int tpw) {
  Geo g;
  g.B = B; g.H = H; g.W = W; g.C = C; g.KH = KH; g.KW = KW;
  g.Cg = C / groups; g.M = M; g.Mg = M / groups;
  g.stride = stride; g.pad = pad;
  g.OH = (H + 2 * pad - KH) / stride + 1;
  g.OW = (W + 2 * pad - KW) / stride + 1;
  g.relu = relu; g.pool = pool; g.pk = pk; g.ps = ps;
  g.PH = pool ? (g.OH - pk) / ps + 1 : g.OH;
  g.PW = pool ? (g.OW - pk) / ps + 1 : g.OW;
  g.tph = tph; g.tpw = tpw;
  g.cw = (tpw - 1) * ps + pk;
  g.tiles_h = (g.PH + tph - 1) / tph;
  g.tiles_w = (g.PW + tpw - 1) / tpw;
  g.ktot = KH * KW * g.Cg;
  g.m_tiles = 0;                    // set by tile_grid
  g.out_scale = 1.f;
  return g;
}

bool al16(const void* p) { return reinterpret_cast<uintptr_t>(p) % 16 == 0; }

// The grid of a tp x tn tile: its position tiles (pooled patches, or tp
// consecutive positions) x the groups' channel tiles (g.m_tiles, set here).
dim3 tile_grid(Geo& g, int tp, int tn, int groups) {
  g.m_tiles = (g.Mg + tn - 1) / tn;
  const long long n_tiles =
      g.pool ? (long long)g.B * g.tiles_h * g.tiles_w
             : ((long long)g.B * g.OH * g.OW + tp - 1) / tp;
  return dim3((unsigned)n_tiles, groups * g.m_tiles);
}

// One bf16 launch at tile TPB x TN. Dynamic shared memory above 48 KB is
// allowed once, at the tile's first launch; a refusal of either surfaces as
// the returned error.
template <int TPB, int TN>
int launch_bf16(const __nv_bfloat16* x, const __nv_bfloat16* w,
                const __nv_bfloat16* b, __nv_bfloat16* out, Geo g,
                int groups, void* stream) {
  constexpr int smem = BfTile<TPB, TN>::SMEM;
  static const cudaError_t attr = cudaFuncSetAttribute(
      conv_bf16_mma_kernel<TPB, TN>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (attr != cudaSuccess) return (int)attr;
  const dim3 grid = tile_grid(g, TPB, TN, groups);
  conv_bf16_mma_kernel<TPB, TN><<<grid, NT, smem, (cudaStream_t)stream>>>(
      x, w, b, out, g, g.Cg % 8 == 0 && al16(x), g.Mg % 8 == 0 && al16(w),
      g.Mg % 8 == 0 && al16(out));
  return (int)cudaGetLastError();
}

// One fp32 launch at tile TPB x TN, as launch_bf16.
template <int TPB, int TN>
int launch_f32(const float* x, const float* w, const float* b, float* out,
               Geo g, int groups, void* stream) {
  constexpr int smem = F32Tile<TPB, TN>::SMEM;
  static const cudaError_t attr = cudaFuncSetAttribute(
      conv_f32_kernel<TPB, TN>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      smem);
  if (attr != cudaSuccess) return (int)attr;
  const dim3 grid = tile_grid(g, TPB, TN, groups);
  conv_f32_kernel<TPB, TN><<<grid, NT, smem, (cudaStream_t)stream>>>(
      x, w, b, out, g, g.Cg % 4 == 0 && al16(x), g.Mg % 4 == 0 && al16(w),
      g.Mg % 4 == 0 && al16(out));
  return (int)cudaGetLastError();
}

// One int8 launch at tile TPB x TN and chunk BK, as launch_bf16.
template <int TPB, int TN, int BK, typename TO>
int launch_s8(const int8_t* x, const int8_t* w, const float* b,
              const float* scale, TO* out, Geo g, int groups, bool avec,
              void* stream) {
  using Tl = S8Tile<TPB, TN, BK>;
  constexpr int smem = Tl::SMEM;
  static const cudaError_t attr = cudaFuncSetAttribute(
      conv_s8_mma_kernel<TPB, TN, BK, TO>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (attr != cudaSuccess) return (int)attr;
  const dim3 grid = tile_grid(g, TPB, TN, groups);
  const int out_vec = sizeof(TO) == 1 ? 16 : 4;
  conv_s8_mma_kernel<TPB, TN, BK, TO>
      <<<grid, NT, smem, (cudaStream_t)stream>>>(
          x, w, b, scale, out, g, avec,
          g.Mg % Tl::CB == 0 && reinterpret_cast<uintptr_t>(w) % Tl::CB == 0,
          g.Mg % out_vec == 0 && al16(out));
  return (int)cudaGetLastError();
}

// The vector gather streams 128 k a chunk; the element gather (the first
// convs, C/G = 3: K 27 and 363) 64, which wastes less of the last chunk.
template <int TPB, int TN, typename TO>
int launch_s8_chunk(const int8_t* x, const int8_t* w, const float* b,
                    const float* scale, TO* out, const Geo& g, int groups,
                    void* stream) {
  const bool avec = g.Cg % 16 == 0 && al16(x);
  if (avec)
    return launch_s8<TPB, TN, 128>(x, w, b, scale, out, g, groups, true,
                                   stream);
  return launch_s8<TPB, TN, 64>(x, w, b, scale, out, g, groups, false,
                                stream);
}

template <typename TO>
int launch_s8_tile(const int8_t* x, const int8_t* w, const float* b,
                   const float* scale, TO* out, const Geo& g, int groups,
                   int tp, int tn, void* stream) {
  if (tp == 128 && tn == 128)
    return launch_s8_chunk<128, 128>(x, w, b, scale, out, g, groups, stream);
  if (tp == 128 && tn == 64)
    return launch_s8_chunk<128, 64>(x, w, b, scale, out, g, groups, stream);
  if (tp == 64 && tn == 128)
    return launch_s8_chunk<64, 128>(x, w, b, scale, out, g, groups, stream);
  if (tp == 64 && tn == 64)
    return launch_s8_chunk<64, 64>(x, w, b, scale, out, g, groups, stream);
  return (int)cudaErrorInvalidValue;
}

}  // namespace

// Plain C entry points. pool: 0 none, 1 max, 2 avg; (tph, tpw) the pooled
// outputs per tile, chosen by the Python wrapper so the conv patch
// ((tph-1)*ps+pk) x ((tpw-1)*ps+pk) fits the tile's rows. Each returns
// cudaGetLastError().

// fp32 x, w, b and out, FFMA on the CUDA cores. (tp, tn): the tile, 128 or
// 64 positions x 128 or 64 channels, (tph, tpw) fitting tp rows.
extern "C" int conv_pipe_f32(const float* x, const float* w, const float* b,
                             float* out, int B, int H, int W, int C, int KH,
                             int KW, int M, int groups, int stride, int pad,
                             int relu, int pool, int pk, int ps, int tph,
                             int tpw, int tp, int tn, void* stream) {
  const Geo g = make_geo(B, H, W, C, KH, KW, M, groups, stride, pad, relu,
                         pool, pk, ps, tph, tpw);
  if (tp == 128 && tn == 128)
    return launch_f32<128, 128>(x, w, b, out, g, groups, stream);
  if (tp == 128 && tn == 64)
    return launch_f32<128, 64>(x, w, b, out, g, groups, stream);
  if (tp == 64 && tn == 128)
    return launch_f32<64, 128>(x, w, b, out, g, groups, stream);
  if (tp == 64 && tn == 64)
    return launch_f32<64, 64>(x, w, b, out, g, groups, stream);
  return (int)cudaErrorInvalidValue;
}

// bf16 x, w, b and out, on the tensor cores; fp32 accumulation and
// epilogue, one rounding. (tp, tn) and (tph, tpw) as in conv_pipe_f32.
extern "C" int conv_pipe_bf16(const __nv_bfloat16* x, const __nv_bfloat16* w,
                              const __nv_bfloat16* b, __nv_bfloat16* out,
                              int B, int H, int W, int C, int KH, int KW,
                              int M, int groups, int stride, int pad,
                              int relu, int pool, int pk, int ps, int tph,
                              int tpw, int tp, int tn, void* stream) {
  const Geo g = make_geo(B, H, W, C, KH, KW, M, groups, stride, pad, relu,
                         pool, pk, ps, tph, tpw);
  if (tp == 128 && tn == 128)
    return launch_bf16<128, 128>(x, w, b, out, g, groups, stream);
  if (tp == 128 && tn == 64)
    return launch_bf16<128, 64>(x, w, b, out, g, groups, stream);
  if (tp == 64 && tn == 128)
    return launch_bf16<64, 128>(x, w, b, out, g, groups, stream);
  if (tp == 64 && tn == 64)
    return launch_bf16<64, 64>(x, w, b, out, g, groups, stream);
  return (int)cudaErrorInvalidValue;
}

// int8 x and w, fp32 b and scale (M,) = s_x * s_w[m], on the tensor cores.
// out_s8: the output is int8 quantized by out_scale, else fp32. (tp, tn) and
// (tph, tpw) as in conv_pipe_f32.
extern "C" int conv_pipe_s8(const int8_t* x, const int8_t* w, const float* b,
                            const float* scale, void* out, int out_s8,
                            float out_scale, int B, int H, int W, int C,
                            int KH, int KW, int M, int groups, int stride,
                            int pad, int relu, int pool, int pk, int ps,
                            int tph, int tpw, int tp, int tn, void* stream) {
  Geo g = make_geo(B, H, W, C, KH, KW, M, groups, stride, pad, relu, pool,
                   pk, ps, tph, tpw);
  g.out_scale = out_scale;
  if (out_s8)
    return launch_s8_tile(x, w, b, scale, (int8_t*)out, g, groups, tp, tn,
                          stream);
  return launch_s8_tile(x, w, b, scale, (float*)out, g, groups, tp, tn,
                        stream);
}

// The dynamic shared memory (bytes) one launch of a tile requests: mode 0
// fp32, 1 bf16, 2 int8 (bk its reduction chunk, 128 or 64); -1 where no
// kernel is instantiated. The Python wrapper's table (CONV_SMEM) is held
// equal to this.
extern "C" int conv_pipe_smem(int mode, int tp, int tn, int bk) {
#define CONV_SMEM(TP, TN)                                                \
  if (tp == TP && tn == TN) {                                            \
    if (mode == 0) return F32Tile<TP, TN>::SMEM;                         \
    if (mode == 1) return BfTile<TP, TN>::SMEM;                          \
    if (mode == 2 && bk == 128) return S8Tile<TP, TN, 128>::SMEM;        \
    if (mode == 2 && bk == 64) return S8Tile<TP, TN, 64>::SMEM;          \
    return -1;                                                           \
  }
  CONV_SMEM(128, 128)
  CONV_SMEM(128, 64)
  CONV_SMEM(64, 128)
  CONV_SMEM(64, 64)
#undef CONV_SMEM
  return -1;
}

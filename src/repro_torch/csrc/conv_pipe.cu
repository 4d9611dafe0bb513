// conv_pipe: fused conv + bias + ReLU (+ max/avg pool), grouped, fp32, in one
// launch per fusion group.
//
// Replaces the TPU kernel src/repro/kernels/conv_pipe.py:conv_pipe (body
// _conv_pipe_kernel), fp32 mode. Layouts as there: x NHWC, w HWIO
// (KH, KW, C/G, M), b (M,), out NHWC.
//
// Bound on an H100: fp32 operations. With FFMA on the CUDA cores (no TF32:
// the reference holds fp32 to 1e-4 at K in the thousands) AlexNet's convs do
// 10.65 GFLOP at batch 8 against tens of MB of traffic, far above the card's
// fp32 ridge point.
//
// Design: an implicit GEMM. A block owns a tile of TP conv output positions
// (GEMM rows) x TM output channels of one group (GEMM cols) and loops over the
// reduction K = KH*KW*C/G in chunks of TK inside the block: the TPU's
// sequential C-tile grid axis and its VMEM accumulator become this loop and
// registers (4x4 outputs a thread). The im2col gather bounds-checks every
// input read, so zero padding costs no copy. The group is picked by
// blockIdx.y, which selects the group's input-channel slab and weight
// columns: no per-group launch, no concatenate. The epilogue adds the bias,
// applies ReLU and stages the conv tile in shared memory, and the pool reads
// its windows from there: the unpooled activation never reaches device
// memory (the paper's Conv->Pool channel). With a pool the tile is a 2-D
// patch of conv rows/cols of one image that covers whole pool windows; conv
// outputs shared by windows of neighbouring tiles are recomputed. Without a
// pool the tile is TP consecutive positions of the flattened (B, OH, OW).
#include <cuda_runtime.h>

namespace {

constexpr int TP = 64;       // conv positions per tile (GEMM rows)
constexpr int TM = 64;       // output channels per tile (GEMM cols)
constexpr int TK = 16;       // reduction chunk
constexpr int NT = 256;      // threads per block
constexpr int LD = TP + 4;   // padded row stride of the staged tiles

struct Geo {
  int B, H, W, C, KH, KW, Cg, M, Mg, stride, pad, OH, OW;
  int relu, pool, pk, ps, PH, PW;   // pool: 0 none, 1 max, 2 avg
  int tph, tpw, cw, tiles_h, tiles_w, ktot, m_tiles;
};

__global__ void __launch_bounds__(NT)
conv_pipe_kernel(const float* __restrict__ x, const float* __restrict__ w,
                 const float* __restrict__ bias, float* __restrict__ out,
                 Geo g) {
  __shared__ __align__(16) float As[TK][LD];   // im2col chunk: [k][position]
  __shared__ __align__(16) float Bs[TK][LD];   // weight chunk: [k][channel]
  __shared__ __align__(16) float Cs[TP][LD];   // conv tile after bias+ReLU
  __shared__ int s_img[TP], s_ih[TP], s_iw[TP], s_pix[TP];

  const int tid = threadIdx.x;
  const int grp = blockIdx.y / g.m_tiles;
  const int m0 = (blockIdx.y % g.m_tiles) * TM;
  const int cbase = grp * g.Cg;                 // this group's input slab
  const int obase = grp * g.Mg + m0;            // first output channel

  // tile decode: which image/conv position each tile row p computes
  int img = 0, oh0 = 0, ow0 = 0, th = 0, tw = 0;
  if (g.pool) {
    const int per_img = g.tiles_h * g.tiles_w;
    img = blockIdx.x / per_img;
    th = (blockIdx.x % per_img) / g.tiles_w;
    tw = blockIdx.x % g.tiles_w;
    oh0 = th * g.tph * g.ps;
    ow0 = tw * g.tpw * g.ps;
  }
  if (tid < TP) {
    int b = -1, oh = 0, ow = 0;
    if (g.pool) {
      const int ch = (g.tph - 1) * g.ps + g.pk;
      const int r = tid / g.cw, c = tid % g.cw;
      oh = oh0 + r;
      ow = ow0 + c;
      if (r < ch && oh < g.OH && ow < g.OW) b = img;
    } else {
      const int q = blockIdx.x * TP + tid;
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
  __syncthreads();

  const int tx = tid % 16, ty = tid / 16;       // 4 channels x 4 positions
  float acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;

  const int a_k = tid % TK, a_p = tid / TK;     // A loader: 4 positions
  const int b_m = tid % TM, b_k = tid / TM;     // B loader: 4 k rows
  for (int k0 = 0; k0 < g.ktot; k0 += TK) {
    const int k = k0 + a_k;
    int kh = 0, kw = 0, c = 0;
    if (k < g.ktot) {
      c = k % g.Cg;
      kw = (k / g.Cg) % g.KW;
      kh = k / (g.Cg * g.KW);
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int p = a_p + 16 * i;
      const int b = s_img[p];
      const int ih = s_ih[p] + kh, iw = s_iw[p] + kw;
      float v = 0.f;
      if (k < g.ktot && b >= 0 && ih >= 0 && ih < g.H && iw >= 0 && iw < g.W)
        v = x[((size_t)(b * g.H + ih) * g.W + iw) * g.C + cbase + c];
      As[a_k][p] = v;
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int kk = b_k + 4 * i;
      float v = 0.f;
      if (k0 + kk < g.ktot && m0 + b_m < g.Mg)
        v = w[(size_t)(k0 + kk) * g.M + obase + b_m];
      Bs[kk][b_m] = v;
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < TK; ++kk) {
      const float4 a = *reinterpret_cast<const float4*>(&As[kk][ty * 4]);
      const float4 bv = *reinterpret_cast<const float4*>(&Bs[kk][tx * 4]);
      const float av[4] = {a.x, a.y, a.z, a.w};
      const float bw[4] = {bv.x, bv.y, bv.z, bv.w};
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(av[i], bw[j], acc[i][j]);
    }
    __syncthreads();
  }

  // epilogue 1: bias + ReLU, conv tile to shared memory
  float bj[4];
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const int m = m0 + tx * 4 + j;
    bj[j] = m < g.Mg ? bias[grp * g.Mg + m] : 0.f;
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    float v[4];
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      v[j] = acc[i][j] + bj[j];
      if (g.relu) v[j] = fmaxf(v[j], 0.f);
    }
    *reinterpret_cast<float4*>(&Cs[ty * 4 + i][tx * 4]) =
        make_float4(v[0], v[1], v[2], v[3]);
  }
  __syncthreads();

  // epilogue 2: pool windows out of the staged tile (or copy it out)
  const int nq = g.pool ? g.tph * g.tpw : TP;
  const int mvalid = min(TM, g.Mg - m0);
  for (int idx = tid; idx < nq * TM; idx += NT) {
    const int m = idx % TM, q = idx / TM;
    if (m >= mvalid) continue;
    size_t o;
    float v;
    if (g.pool) {
      const int qh = q / g.tpw, qw = q % g.tpw;
      const int ph = th * g.tph + qh, pw = tw * g.tpw + qw;
      if (ph >= g.PH || pw >= g.PW) continue;
      const int r0 = qh * g.ps, c0 = qw * g.ps;
      v = Cs[r0 * g.cw + c0][m];
      for (int i = 0; i < g.pk; ++i)
        for (int j = 0; j < g.pk; ++j) {
          if (i == 0 && j == 0) continue;
          const float u = Cs[(r0 + i) * g.cw + c0 + j][m];
          v = g.pool == 1 ? fmaxf(v, u) : v + u;
        }
      if (g.pool == 2) v = v / (float)(g.pk * g.pk);
      o = ((size_t)(img * g.PH + ph) * g.PW + pw) * g.M + obase + m;
    } else {
      const int pix = s_pix[q];
      if (pix < 0) continue;
      v = Cs[q][m];
      o = (size_t)pix * g.M + obase + m;
    }
    out[o] = v;
  }
}

}  // namespace

// Plain C entry point. pool: 0 none, 1 max, 2 avg; (tph, tpw) the pooled
// outputs per tile, chosen by the Python wrapper so the conv patch
// ((tph-1)*ps+pk) x ((tpw-1)*ps+pk) fits the TP rows. Returns cudaGetLastError().
extern "C" int conv_pipe_f32(const float* x, const float* w, const float* b,
                             float* out, int B, int H, int W, int C, int KH,
                             int KW, int M, int groups, int stride, int pad,
                             int relu, int pool, int pk, int ps, int tph,
                             int tpw, void* stream) {
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
  g.m_tiles = (g.Mg + TM - 1) / TM;
  const long long n_tiles = pool ? (long long)B * g.tiles_h * g.tiles_w
                                 : ((long long)B * g.OH * g.OW + TP - 1) / TP;
  dim3 grid((unsigned)n_tiles, groups * g.m_tiles);
  conv_pipe_kernel<<<grid, NT, 0, (cudaStream_t)stream>>>(x, w, b, out, g);
  return (int)cudaGetLastError();
}

// conv_pipe: fused conv + bias + ReLU (+ max/avg pool), grouped, in one
// launch per fusion group; fp32, int8 with an int32 accumulator, or bf16
// with an fp32 accumulator.
//
// Replaces the TPU kernel src/repro/kernels/conv_pipe.py:conv_pipe (body
// _conv_pipe_kernel), all three modes. Layouts as there: x NHWC, w HWIO
// (KH, KW, C/G, M), b (M,), out NHWC.
//
// Bound on an H100: operations. fp32 runs FFMA on the CUDA cores (no TF32:
// the reference holds fp32 to 1e-4 at K in the thousands); AlexNet's convs
// do 10.65 GFLOP at batch 8 against tens of MB of traffic, far above the
// card's fp32 ridge point. The int8 mode runs __dp4a (four int8 products and
// an int32 add per instruction) on the CUDA cores, not the tensor cores.
// The bf16 mode also runs FFMA on the CUDA cores (each bf16 value widened to
// fp32), so its bound on the bf16 tensor cores is far out of its reach.
//
// Design: an implicit GEMM. A block owns a tile of TP conv output positions
// (GEMM rows) x TM output channels of one group (GEMM cols) and loops over the
// reduction K = KH*KW*C/G in chunks of TK words inside the block: the TPU's
// sequential C-tile grid axis and its VMEM accumulator become this loop and
// registers (4x4 outputs a thread). A word is one fp32 value, four int8
// values of consecutive k packed for __dp4a, or two bf16 values of
// consecutive k, so the int8 and bf16 modes keep the fp32 tile geometry and
// shared-memory layout and reduce 64 or 32 k per chunk. k past the end of
// the reduction is zero in both operands, element by element, so a word may
// straddle the end (C/G = 3 at conv1 gives an odd K). The
// im2col gather bounds-checks every input read, so zero padding costs no
// copy (exact in int8: the scheme is symmetric, zero point 0). The group is
// picked by blockIdx.y, which selects the group's input-channel slab and
// weight columns: no per-group launch, no concatenate. The epilogue applies
// the requantize multiplier (int8 mode), the bias and ReLU and stages the
// conv tile in shared memory as fp32, and the pool reads its windows from
// there: the unpooled activation never reaches device memory (the paper's
// Conv->Pool channel). With a pool the tile is a 2-D patch of conv rows/cols
// of one image that covers whole pool windows; conv outputs shared by
// windows of neighbouring tiles are recomputed. Without a pool the tile is
// TP consecutive positions of the flattened (B, OH, OW).
//
// int8 epilogue, as the JAX kernel rounds it (conv_pipe.py:165-195): y =
// float(acc) * scale[m], then + b[m] (two roundings, never one FMA), ReLU,
// pool (avg: the window summed in row-major order, then divided), then
// clip(rint(y / out_scale), -127, 127) to int8, or y itself as fp32.
//
// bf16 epilogue, as the JAX kernel rounds it (conv_pipe.py:165-195, out in
// x's dtype): the fp32 accumulator + b (bf16, widened), ReLU and the pool in
// fp32, exactly as the fp32 mode, then one rounding to bf16 on store.
#include <cstdint>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int TP = 64;       // conv positions per tile (GEMM rows)
constexpr int TM = 64;       // output channels per tile (GEMM cols)
constexpr int TK = 16;       // reduction chunk, in words
constexpr int NT = 256;      // threads per block
constexpr int LD = TP + 4;   // padded row stride of the staged tiles

struct Geo {
  int B, H, W, C, KH, KW, Cg, M, Mg, stride, pad, OH, OW;
  int relu, pool, pk, ps, PH, PW;   // pool: 0 none, 1 max, 2 avg
  int tph, tpw, cw, tiles_h, tiles_w, ktot, m_tiles;
  int cvec;                         // the KP consecutive k of a word share
                                    // (kh, kw): one aligned word load
  float out_scale;                  // int8 output step (int8 out only)
};

// What differs between the modes: the element, the packed word of KP
// elements, the accumulator and its multiply-add, and the bias element.
template <typename T> struct Mode;
template <> struct Mode<float> {
  using Word = float;
  using Vec = float4;
  using Acc = float;
  using Bias = float;
  static constexpr int KP = 1;
  __device__ static float zero() { return 0.f; }
  __device__ static Word pack(const float (&v)[1]) { return v[0]; }
  __device__ static Acc mac(Word a, Word b, Acc c) { return fmaf(a, b, c); }
  __device__ static float requant(Acc acc, float) { return acc; }
};
template <> struct Mode<int8_t> {
  using Word = int;
  using Vec = int4;
  using Acc = int;
  using Bias = float;
  static constexpr int KP = 4;
  __device__ static int8_t zero() { return 0; }
  __device__ static Word pack(const int8_t (&v)[4]) {
    return (int)((uint32_t)(uint8_t)v[0] | (uint32_t)(uint8_t)v[1] << 8 |
                 (uint32_t)(uint8_t)v[2] << 16 | (uint32_t)(uint8_t)v[3] << 24);
  }
  __device__ static Acc mac(Word a, Word b, Acc c) { return __dp4a(a, b, c); }
  __device__ static float requant(Acc acc, float s) {
    return __fmul_rn(__int2float_rn(acc), s);
  }
};
// bf16: a word is the raw bits of two bf16 of consecutive k (k even in the
// low half, as they lie in memory); a bf16 widens to fp32 exactly by
// moving its bits to the top of the word.
template <> struct Mode<__nv_bfloat16> {
  using Word = uint32_t;
  using Vec = uint4;
  using Acc = float;
  using Bias = __nv_bfloat16;
  static constexpr int KP = 2;
  __device__ static __nv_bfloat16 zero() {
    return __ushort_as_bfloat16((unsigned short)0);
  }
  __device__ static Word pack(const __nv_bfloat16 (&v)[2]) {
    return (uint32_t)__bfloat16_as_ushort(v[0]) |
           (uint32_t)__bfloat16_as_ushort(v[1]) << 16;
  }
  __device__ static Acc mac(Word a, Word b, Acc c) {
    c = fmaf(__uint_as_float(a << 16), __uint_as_float(b << 16), c);
    return fmaf(__uint_as_float(a & 0xffff0000u),
                __uint_as_float(b & 0xffff0000u), c);
  }
  __device__ static float requant(Acc acc, float) { return acc; }
};

__device__ __forceinline__ float widen(float v) { return v; }
__device__ __forceinline__ float widen(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

__device__ __forceinline__ void store(float* out, size_t o, float v, float) {
  out[o] = v;
}
__device__ __forceinline__ void store(int8_t* out, size_t o, float v,
                                      float out_scale) {
  const float q = rintf(__fdiv_rn(v, out_scale));
  out[o] = (int8_t)fminf(fmaxf(q, -127.f), 127.f);
}
__device__ __forceinline__ void store(__nv_bfloat16* out, size_t o, float v,
                                      float) {
  out[o] = __float2bfloat16_rn(v);
}

template <typename T, typename TO>
__global__ void __launch_bounds__(NT)
conv_pipe_kernel(const T* __restrict__ x, const T* __restrict__ w,
                 const typename Mode<T>::Bias* __restrict__ bias,
                 const float* __restrict__ scale, TO* __restrict__ out,
                 Geo g) {
  using Md = Mode<T>;
  using Word = typename Md::Word;
  using Vec = typename Md::Vec;
  using Acc = typename Md::Acc;
  constexpr int KP = Md::KP;
  __shared__ __align__(16) Word As[TK][LD];    // im2col chunk: [k][position]
  __shared__ __align__(16) Word Bs[TK][LD];    // weight chunk: [k][channel]
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
  Acc acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0;

  const int a_k = tid % TK, a_p = tid / TK;     // A loader: 4 positions
  const int b_m = tid % TM, b_k = tid / TM;     // B loader: 4 k rows
  for (int k0 = 0; k0 < g.ktot; k0 += TK * KP) {
    // the KP consecutive k of this thread's A word
    int kh[KP], kw[KP], c[KP];
    bool kin[KP];
#pragma unroll
    for (int e = 0; e < KP; ++e) {
      const int k = k0 + a_k * KP + e;
      kin[e] = k < g.ktot;
      c[e] = k % g.Cg;
      kw[e] = (k / g.Cg) % g.KW;
      kh[e] = k / (g.Cg * g.KW);
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int p = a_p + 16 * i;
      const int b = s_img[p];
      Word v;
      if (KP > 1 && g.cvec && kin[KP - 1]) {
        // KP channels of one pixel: one aligned 4-byte word load
        const int ih = s_ih[p] + kh[0], iw = s_iw[p] + kw[0];
        v = Word(0);
        if (b >= 0 && ih >= 0 && ih < g.H && iw >= 0 && iw < g.W)
          v = *reinterpret_cast<const Word*>(
              &x[((size_t)(b * g.H + ih) * g.W + iw) * g.C + cbase + c[0]]);
      } else {
        T e_v[KP];
#pragma unroll
        for (int e = 0; e < KP; ++e) {
          const int ih = s_ih[p] + kh[e], iw = s_iw[p] + kw[e];
          e_v[e] = Md::zero();
          if (kin[e] && b >= 0 && ih >= 0 && ih < g.H && iw >= 0 && iw < g.W)
            e_v[e] = x[((size_t)(b * g.H + ih) * g.W + iw) * g.C + cbase +
                       c[e]];
        }
        v = Md::pack(e_v);
      }
      As[a_k][p] = v;
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int kk = b_k + 4 * i;
      T e_v[KP];
#pragma unroll
      for (int e = 0; e < KP; ++e) {
        const int k = k0 + kk * KP + e;
        e_v[e] = Md::zero();
        if (k < g.ktot && m0 + b_m < g.Mg)
          e_v[e] = w[(size_t)k * g.M + obase + b_m];
      }
      Bs[kk][b_m] = Md::pack(e_v);
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < TK; ++kk) {
      const Vec a = *reinterpret_cast<const Vec*>(&As[kk][ty * 4]);
      const Vec bv = *reinterpret_cast<const Vec*>(&Bs[kk][tx * 4]);
      const Word av[4] = {a.x, a.y, a.z, a.w};
      const Word bw[4] = {bv.x, bv.y, bv.z, bv.w};
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = Md::mac(av[i], bw[j], acc[i][j]);
    }
    __syncthreads();
  }

  // epilogue 1: requantize (int8), bias + ReLU, conv tile to shared memory
  float bj[4], sj[4];
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const int m = m0 + tx * 4 + j;
    bj[j] = m < g.Mg ? widen(bias[grp * g.Mg + m]) : 0.f;
    sj[j] = scale != nullptr && m < g.Mg ? scale[grp * g.Mg + m] : 0.f;
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    float v[4];
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      v[j] = __fadd_rn(Md::requant(acc[i][j], sj[j]), bj[j]);
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
          v = g.pool == 1 ? fmaxf(v, u) : __fadd_rn(v, u);
        }
      if (g.pool == 2) v = __fdiv_rn(v, (float)(g.pk * g.pk));
      o = ((size_t)(img * g.PH + ph) * g.PW + pw) * g.M + obase + m;
    } else {
      const int pix = s_pix[q];
      if (pix < 0) continue;
      v = Cs[q][m];
      o = (size_t)pix * g.M + obase + m;
    }
    store(out, o, v, g.out_scale);
  }
}

Geo make_geo(int B, int H, int W, int C, int KH, int KW, int M, int groups,
             int stride, int pad, int relu, int pool, int pk, int ps,
             int tph, int tpw, int kp) {
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
  g.cvec = kp > 1 && g.Cg % kp == 0 && C % kp == 0;
  g.out_scale = 1.f;
  return g;
}

template <typename T, typename TO>
int launch(const T* x, const T* w, const typename Mode<T>::Bias* b,
           const float* scale,
           TO* out, const Geo& g, int groups, void* stream) {
  const long long n_tiles =
      g.pool ? (long long)g.B * g.tiles_h * g.tiles_w
             : ((long long)g.B * g.OH * g.OW + TP - 1) / TP;
  dim3 grid((unsigned)n_tiles, groups * g.m_tiles);
  conv_pipe_kernel<T, TO><<<grid, NT, 0, (cudaStream_t)stream>>>(
      x, w, b, scale, out, g);
  return (int)cudaGetLastError();
}

}  // namespace

// Plain C entry points. pool: 0 none, 1 max, 2 avg; (tph, tpw) the pooled
// outputs per tile, chosen by the Python wrapper so the conv patch
// ((tph-1)*ps+pk) x ((tpw-1)*ps+pk) fits the TP rows. Each returns
// cudaGetLastError().
extern "C" int conv_pipe_f32(const float* x, const float* w, const float* b,
                             float* out, int B, int H, int W, int C, int KH,
                             int KW, int M, int groups, int stride, int pad,
                             int relu, int pool, int pk, int ps, int tph,
                             int tpw, void* stream) {
  const Geo g = make_geo(B, H, W, C, KH, KW, M, groups, stride, pad, relu,
                         pool, pk, ps, tph, tpw, 1);
  return launch<float, float>(x, w, b, nullptr, out, g, groups, stream);
}

// bf16 x, w, b and out; fp32 accumulation and epilogue, one rounding.
extern "C" int conv_pipe_bf16(const __nv_bfloat16* x, const __nv_bfloat16* w,
                              const __nv_bfloat16* b, __nv_bfloat16* out,
                              int B, int H, int W, int C, int KH, int KW,
                              int M, int groups, int stride, int pad,
                              int relu, int pool, int pk, int ps, int tph,
                              int tpw, void* stream) {
  const Geo g = make_geo(B, H, W, C, KH, KW, M, groups, stride, pad, relu,
                         pool, pk, ps, tph, tpw, 2);
  return launch<__nv_bfloat16, __nv_bfloat16>(x, w, b, nullptr, out, g,
                                              groups, stream);
}

// int8 x and w, fp32 b and scale (M,) = s_x * s_w[m]. out_s8: the output is
// int8 quantized by out_scale, else fp32.
extern "C" int conv_pipe_s8(const int8_t* x, const int8_t* w, const float* b,
                            const float* scale, void* out, int out_s8,
                            float out_scale, int B, int H, int W, int C,
                            int KH, int KW, int M, int groups, int stride,
                            int pad, int relu, int pool, int pk, int ps,
                            int tph, int tpw, void* stream) {
  Geo g = make_geo(B, H, W, C, KH, KW, M, groups, stride, pad, relu, pool,
                   pk, ps, tph, tpw, 4);
  g.out_scale = out_scale;
  if (out_s8)
    return launch<int8_t, int8_t>(x, w, b, scale, (int8_t*)out, g, groups,
                                  stream);
  return launch<int8_t, float>(x, w, b, scale, (float*)out, g, groups,
                               stream);
}

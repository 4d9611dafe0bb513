// flash_attention: causal attention with an online softmax, fp32 arithmetic,
// fp32 or bf16 elements, GQA read in place.
//
// Replaces the TPU kernel src/repro/kernels/flash_attention.py:flash_attention
// (body _flash_kernel), and the head repeat that src/repro/kernels/ops.py:
// attention puts in front of it. q (B, Hq, Sq, D), k and v (B, Hkv, Sk, D),
// o (B, Hq, Sq, D), all contiguous. Query head h reads KV head h / (Hq/Hkv),
// the order jnp.repeat(k, g, axis=1) gives.
//
// Bound on an H100: operations. The causal product takes 4*D operations for
// each of the Sq(Sq+1)/2 (query, key) pairs below the diagonal, against 2
// bytes (bf16) of q, k, v and o per element; at Qwen3-8B prefill (S 4096,
// D 128) that is 34 operations a byte in bf16. This kernel runs them as fp32
// FFMA on the CUDA cores, as the TPU kernel computes in fp32; tensor cores
// (mma/wgmma on bf16 tiles) are the lever left for later.
//
// Design. One block of 256 threads per (batch*head, 64-row query tile); the
// TPU's sequential KV-tile grid axis becomes a loop inside the block, and its
// VMEM scratch (running max m, normaliser l, accumulator acc) becomes
// registers. Per 64-key tile: K is staged in shared memory as fp32, each
// thread computes a 4x4 block of scores (rows ty+16i, keys tx+16j) with
// 16-byte shared loads, masks k_pos > q_pos with -1e30 as the TPU kernel
// does, and takes the row max and sum with shuffles across the 16 threads
// of a row. P goes to shared memory, V replaces K in the same buffer (85 KB
// at D 128, so two blocks fit an SM), and each thread adds P*V into its 4
// rows x D/16 columns. The loop stops at the causal edge: a tile entirely
// above the diagonal has every score at -1e30, so the TPU kernel's update
// with it is exact identity and skipping it gives the same output. Blocks of
// the last (longest) query tiles are scheduled first. Ragged Sq and Sk are
// masked (zero rows in shared memory, no stores). Epilogue: acc /
// max(l, 1e-30), rounded to bf16 with __float2bfloat16_rn where the output
// is bf16. expf, never __expf: the build uses no fast math.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int BQ = 64;           // query rows per block
constexpr int BK = 64;           // keys per tile
constexpr int NT = 256;          // threads: 16 x 16
constexpr float NEG_INF = -1e30f;

__device__ __forceinline__ void load8(const float* p, float (&f)[8]) {
  const float4 a = __ldg(reinterpret_cast<const float4*>(p));
  const float4 b = __ldg(reinterpret_cast<const float4*>(p) + 1);
  f[0] = a.x; f[1] = a.y; f[2] = a.z; f[3] = a.w;
  f[4] = b.x; f[5] = b.y; f[6] = b.z; f[7] = b.w;
}

__device__ __forceinline__ void load8(const __nv_bfloat16* p, float (&f)[8]) {
  const uint4 u = __ldg(reinterpret_cast<const uint4*>(p));
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&u);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 t = __bfloat1622float2(h[i]);
    f[2 * i] = t.x;
    f[2 * i + 1] = t.y;
  }
}

__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16_rn(v);
}

// rows [row0, row0 + 64) of a (rows, D) matrix into shared memory as fp32
// (row stride D + 4), times mul; rows past n_rows are zero
template <typename T, int D>
__device__ __forceinline__ void load_tile(const T* __restrict__ g, int row0,
                                          int n_rows, float mul, float* s) {
  constexpr int CH = D / 8;      // 8-element chunks a row
  for (int i = threadIdx.x; i < BQ * CH; i += NT) {
    const int r = i / CH, c = (i % CH) * 8;
    float f[8];
    if (row0 + r < n_rows) {
      load8(g + (size_t)(row0 + r) * D + c, f);
    } else {
#pragma unroll
      for (int e = 0; e < 8; ++e) f[e] = 0.f;
    }
    float4* dst = reinterpret_cast<float4*>(s + r * (D + 4) + c);
    dst[0] = make_float4(f[0] * mul, f[1] * mul, f[2] * mul, f[3] * mul);
    dst[1] = make_float4(f[4] * mul, f[5] * mul, f[6] * mul, f[7] * mul);
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

template <typename T, int D>
__global__ void __launch_bounds__(NT, 2)
flash_kernel(const T* __restrict__ q, const T* __restrict__ k,
             const T* __restrict__ v, T* __restrict__ o, int Hq, int Hkv,
             int Sq, int Sk, float scale) {
  constexpr int DS = D + 4;                  // shared row stride (floats)
  constexpr int PS = BK + 4;
  constexpr int VEC = D / 16 >= 4 ? 4 : D / 16;
  constexpr int NJ = D / (16 * VEC);         // column groups per thread
  extern __shared__ float4 smem4[];
  float* qs = reinterpret_cast<float*>(smem4);
  float* kv = qs + BQ * DS;
  float* ps = kv + BK * DS;

  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
  const int bh = blockIdx.x;
  const int b = bh / Hq, h = bh % Hq;
  const int kvh = b * Hkv + h / (Hq / Hkv);
  const int q0 = (gridDim.y - 1 - blockIdx.y) * BQ;
  const T* qg = q + (size_t)bh * Sq * D;
  const T* kg = k + (size_t)kvh * Sk * D;
  const T* vg = v + (size_t)kvh * Sk * D;

  load_tile<T, D>(qg, q0, Sq, scale, qs);

  float m[4], l[4], acc[4][NJ * VEC];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = NEG_INF;
    l[i] = 0.f;
#pragma unroll
    for (int n = 0; n < NJ * VEC; ++n) acc[i][n] = 0.f;
  }

  const int k_last = min(min(q0 + BQ, Sq), Sk) - 1;   // causal edge
  for (int k0 = 0; k0 <= k_last; k0 += BK) {
    load_tile<T, D>(kg, k0, Sk, 1.f, kv);
    __syncthreads();

    float s[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
#pragma unroll 4
    for (int d = 0; d < D; d += 4) {
      float4 qv[4], kk[4];
#pragma unroll
      for (int i = 0; i < 4; ++i)
        qv[i] = *reinterpret_cast<const float4*>(qs + (ty + 16 * i) * DS + d);
#pragma unroll
      for (int j = 0; j < 4; ++j)
        kk[j] = *reinterpret_cast<const float4*>(kv + (tx + 16 * j) * DS + d);
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          s[i][j] = fmaf(qv[i].x, kk[j].x, s[i][j]);
          s[i][j] = fmaf(qv[i].y, kk[j].y, s[i][j]);
          s[i][j] = fmaf(qv[i].z, kk[j].z, s[i][j]);
          s[i][j] = fmaf(qv[i].w, kk[j].w, s[i][j]);
        }
    }
    __syncthreads();                         // K read by every thread
    load_tile<T, D>(vg, k0, Sk, 1.f, kv);

#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int qp = q0 + ty + 16 * i;
      float mx = NEG_INF;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int kp = k0 + tx + 16 * j;
        if (kp > qp || kp >= Sk) s[i][j] = NEG_INF;
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
        ps[(ty + 16 * i) * PS + tx + 16 * j] = p;
        sum += p;
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        sum += __shfl_xor_sync(0xffffffffu, sum, off);
      const float coef = expf(m[i] - m_new);
      l[i] = l[i] * coef + sum;
      m[i] = m_new;
#pragma unroll
      for (int n = 0; n < NJ * VEC; ++n) acc[i][n] *= coef;
    }
    __syncthreads();                         // P and V in shared memory

#pragma unroll 2
    for (int c = 0; c < BK; c += 4) {
      float4 pv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i)
        pv[i] = *reinterpret_cast<const float4*>(ps + (ty + 16 * i) * PS + c);
#pragma unroll
      for (int cc = 0; cc < 4; ++cc) {
        const float* vrow = kv + (c + cc) * DS;
#pragma unroll
        for (int j = 0; j < NJ; ++j) {
          float vv[VEC];
          lds<VEC>(vrow + j * 16 * VEC + tx * VEC, vv);
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            const float p = cc == 0 ? pv[i].x : cc == 1 ? pv[i].y
                          : cc == 2 ? pv[i].z : pv[i].w;
#pragma unroll
            for (int e = 0; e < VEC; ++e)
              acc[i][j * VEC + e] = fmaf(p, vv[e], acc[i][j * VEC + e]);
          }
        }
      }
    }
    __syncthreads();                         // V and P read by every thread
  }

  T* og = o + (size_t)bh * Sq * D;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int qp = q0 + ty + 16 * i;
    if (qp >= Sq) continue;
    const float den = fmaxf(l[i], 1e-30f);
#pragma unroll
    for (int j = 0; j < NJ; ++j)
#pragma unroll
      for (int e = 0; e < VEC; ++e)
        store(og + (size_t)qp * D + j * 16 * VEC + tx * VEC + e,
              acc[i][j * VEC + e] / den);
  }
}

template <typename T, int D>
int launch(const void* q, const void* k, const void* v, void* o, int B,
           int Hq, int Hkv, int Sq, int Sk, float scale, cudaStream_t st) {
  const size_t smem = sizeof(float) * ((BQ + BK) * (D + 4) + BQ * (BK + 4));
  cudaError_t err = cudaFuncSetAttribute(
      flash_kernel<T, D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid(B * Hq, (Sq + BQ - 1) / BQ);
  flash_kernel<T, D><<<grid, NT, smem, st>>>(
      (const T*)q, (const T*)k, (const T*)v, (T*)o, Hq, Hkv, Sq, Sk, scale);
  return (int)cudaGetLastError();
}

template <typename T>
int dispatch(const void* q, const void* k, const void* v, void* o, int B,
             int Hq, int Hkv, int Sq, int Sk, int D, float scale,
             void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  switch (D) {
    case 16: return launch<T, 16>(q, k, v, o, B, Hq, Hkv, Sq, Sk, scale, st);
    case 32: return launch<T, 32>(q, k, v, o, B, Hq, Hkv, Sq, Sk, scale, st);
    case 64: return launch<T, 64>(q, k, v, o, B, Hq, Hkv, Sq, Sk, scale, st);
    case 128: return launch<T, 128>(q, k, v, o, B, Hq, Hkv, Sq, Sk, scale, st);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

// Plain C entry points; D in {16, 32, 64, 128}, Hq a multiple of Hkv, every
// pointer 16-byte aligned. scale = 1/sqrt(D) in fp32, multiplied into q as
// the TPU kernel does. Return cudaGetLastError() (or the attribute error).
extern "C" int flash_attention_f32(const void* q, const void* k,
                                   const void* v, void* o, int B, int Hq,
                                   int Hkv, int Sq, int Sk, int D,
                                   float scale, void* stream) {
  return dispatch<float>(q, k, v, o, B, Hq, Hkv, Sq, Sk, D, scale, stream);
}

extern "C" int flash_attention_bf16(const void* q, const void* k,
                                    const void* v, void* o, int B, int Hq,
                                    int Hkv, int Sq, int Sk, int D,
                                    float scale, void* stream) {
  return dispatch<__nv_bfloat16>(q, k, v, o, B, Hq, Hkv, Sq, Sk, D, scale,
                                 stream);
}

// decode_attention: one-token GQA attention over a KV cache, with the write
// of the new token's K and V into the cache at slot pos, in place.
//
// Replaces the TPU kernel
// src/repro/kernels/decode_attention.py:decode_attention (body
// _decode_kernel). q (B, HKV, G, D); k_cache, v_cache (B, S, HKV, D);
// new_k, new_v (B, HKV, D); o (B, HKV, G, D); pos one int32 for the batch,
// read on the device (a pointer) or passed from the host, so a position
// that lives on the card never costs the host a synchronising copy.
//
// Bound on an H100: device-memory bytes. Each cache slot 0..pos is read
// once and feeds 4*G*D operations for 2*D elements of K and V (G 4: 4
// operations a byte in bf16, 2 in fp32), far below the card's balance.
//
// Design. One block of 256 threads per (batch, KV head), as the TPU grid's
// (b, h) axes; the TPU's sequential slot axis becomes a loop over tiles of
// 64 slots, double-buffered: cp.async streams tile t+1's K and V rows into
// shared memory while tile t is computed, so 64 KB (fp32; 32 KB bf16) are
// in flight a block. Only slots 0..pos are loaded: stale slots past pos are
// never read, so they cannot reach the output (the TPU kernel masks them).
// The G query rows, times 1/sqrt(D) in fp32 as the TPU kernel scales them,
// stay in shared memory. Scores: four threads a slot, each over interleaved
// 16-byte chunks of D, reduced with two shuffles, all G rows at once. One
// warp per row keeps the running max and normaliser. P*V: a thread owns one
// d and every G row over a share of the slots, and the shares are summed
// after the loop. Slot pos is taken from new_k/new_v, never from the cache
// (as jnp.where(at_pos, ...) does): once its tile has landed, the row in
// shared memory is overwritten with new_k/new_v. The cache's slot pos is
// written at the end, by the only block that reads (b, :, h), with the
// bytes of new_k/new_v: one slot, not a copy of the cache. Epilogue acc /
// max(l, 1e-30), rounded to bf16 with __float2bfloat16_rn where the output
// is bf16. expf, never __expf: the build uses no fast math.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <cstdint>

namespace {

constexpr int NT = 256;
constexpr int TS = 64;           // cache slots per tile
constexpr int QS = NT / TS;      // threads per slot in the score phase
constexpr int GMAX = 8;          // query rows per KV head, at most
constexpr int PAD = 16 * QS;     // bytes after each shared row (no conflicts)
constexpr float NEG_INF = -1e30f;

template <typename T> struct Chunk;            // one 16-byte chunk as floats
template <> struct Chunk<float> {
  static constexpr int E = 4;
  __device__ static void get(const void* p, float (&f)[8]) {
    const float4 a = *reinterpret_cast<const float4*>(p);
    f[0] = a.x; f[1] = a.y; f[2] = a.z; f[3] = a.w;
  }
};
template <> struct Chunk<__nv_bfloat16> {
  static constexpr int E = 8;
  __device__ static void get(const void* p, float (&f)[8]) {
    const uint4 u = *reinterpret_cast<const uint4*>(p);
    const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&u);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float2 t = __bfloat1622float2(h[i]);
      f[2 * i] = t.x;
      f[2 * i + 1] = t.y;
    }
  }
};

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16_rn(v);
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s),
               "l"(src));
}
__device__ __forceinline__ void cp_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
template <int N>
__device__ __forceinline__ void cp_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

template <typename T>
__global__ void __launch_bounds__(NT)
decode_kernel(const T* __restrict__ q, T* kc, T* vc,
              const T* __restrict__ nk, const T* __restrict__ nv,
              const int* __restrict__ pos_dev, int pos_host,
              T* __restrict__ o, int S, int HKV, int G, int D, float scale) {
  extern __shared__ float4 smem4[];
  const int row_bytes = D * (int)sizeof(T);
  const int rstride = row_bytes + PAD;
  const int chunks = row_bytes / 16;
  unsigned char* stage = reinterpret_cast<unsigned char*>(smem4);
  // stage s, matrix m (0 K, 1 V): stage + (2 * s + m) * TS * rstride
  float* qs = reinterpret_cast<float*>(stage + 4 * TS * rstride);
  float* ps = qs + GMAX * D;                   // (TS, GMAX): p of slot s, row g
  float* m_s = ps + TS * GMAX;
  float* l_s = m_s + GMAX;
  float* coef_s = l_s + GMAX;

  const int b = blockIdx.x / HKV, h = blockIdx.x % HKV;
  const int pos = pos_dev ? *pos_dev : pos_host;
  const int n_valid = max(0, min(pos, S - 1) + 1);
  const size_t slot_stride = (size_t)HKV * D;  // elements between slots
  const T* kg = kc + ((size_t)b * S * HKV + h) * D;
  const T* vg = vc + ((size_t)b * S * HKV + h) * D;
  const size_t bh = (size_t)b * HKV + h;

  for (int i = threadIdx.x; i < G * D; i += NT)
    qs[i] = to_f(q[bh * G * D + i]) * scale;
  if (threadIdx.x < GMAX) {
    m_s[threadIdx.x] = NEG_INF;
    l_s[threadIdx.x] = 0.f;
  }

  auto issue = [&](int t) {
    const int t0 = t * TS, rows = min(TS, n_valid - t0);
    unsigned char* ks = stage + (2 * (t & 1)) * TS * rstride;
    unsigned char* vs = ks + TS * rstride;
    for (int i = threadIdx.x; i < rows * chunks; i += NT) {
      const int r = i / chunks, c = i % chunks;
      const size_t off = (size_t)(t0 + r) * slot_stride;
      cp_async16(ks + r * rstride + c * 16,
                 reinterpret_cast<const unsigned char*>(kg + off) + c * 16);
      cp_async16(vs + r * rstride + c * 16,
                 reinterpret_cast<const unsigned char*>(vg + off) + c * 16);
    }
    cp_commit();
  };

  const int NSPLIT = NT / D;                   // slot shares in P*V
  const int d = threadIdx.x % D, share = threadIdx.x / D;
  float acc[GMAX];
#pragma unroll
  for (int g = 0; g < GMAX; ++g) acc[g] = 0.f;

  const int n_tiles = (n_valid + TS - 1) / TS;
  if (n_tiles > 0) issue(0);
  for (int t = 0; t < n_tiles; ++t) {
    if (t + 1 < n_tiles) {
      issue(t + 1);
      cp_wait<1>();
    } else {
      cp_wait<0>();
    }
    const int t0 = t * TS, rows = min(TS, n_valid - t0);
    unsigned char* ks = stage + (2 * (t & 1)) * TS * rstride;
    unsigned char* vs = ks + TS * rstride;
    __syncthreads();                           // tile t landed for all
    if (pos >= t0 && pos < t0 + rows) {        // slot pos: new_k / new_v
      const int r = pos - t0;
      for (int i = threadIdx.x; i < D; i += NT) {
        reinterpret_cast<T*>(ks + r * rstride)[i] = nk[bh * D + i];
        reinterpret_cast<T*>(vs + r * rstride)[i] = nv[bh * D + i];
      }
      __syncthreads();
    }

    // scores of every row g for slot sl, four threads a slot
    {
      const int sl = threadIdx.x / QS, part = threadIdx.x % QS;
      float sc[GMAX];
#pragma unroll
      for (int g = 0; g < GMAX; ++g) sc[g] = 0.f;
      if (sl < rows) {
        for (int c = part; c < chunks; c += QS) {
          float kf[8];
          Chunk<T>::get(ks + sl * rstride + c * 16, kf);
          const int e0 = c * Chunk<T>::E;
#pragma unroll
          for (int g = 0; g < GMAX; ++g) {
            if (g < G) {
#pragma unroll
              for (int e = 0; e < Chunk<T>::E; e += 4) {
                const float4 qv =
                    *reinterpret_cast<const float4*>(qs + g * D + e0 + e);
                sc[g] = fmaf(qv.x, kf[e], sc[g]);
                sc[g] = fmaf(qv.y, kf[e + 1], sc[g]);
                sc[g] = fmaf(qv.z, kf[e + 2], sc[g]);
                sc[g] = fmaf(qv.w, kf[e + 3], sc[g]);
              }
            }
          }
        }
      }
#pragma unroll
      for (int g = 0; g < GMAX; ++g) {
        sc[g] += __shfl_xor_sync(0xffffffffu, sc[g], 1);
        sc[g] += __shfl_xor_sync(0xffffffffu, sc[g], 2);
      }
      if (part == 0 && sl < rows) {
#pragma unroll
        for (int g = 0; g < GMAX; ++g) ps[sl * GMAX + g] = sc[g];
      }
    }
    __syncthreads();

    // running max and normaliser: one warp a row
    {
      const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
      for (int g = warp; g < G; g += NT / 32) {
        float mx = NEG_INF;
        for (int s = lane; s < rows; s += 32) mx = fmaxf(mx, ps[s * GMAX + g]);
#pragma unroll
        for (int off = 16; off > 0; off >>= 1)
          mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
        const float m_old = m_s[g];
        const float m_new = fmaxf(m_old, mx);
        float sum = 0.f;
        for (int s = lane; s < rows; s += 32) {
          const float p = expf(ps[s * GMAX + g] - m_new);
          ps[s * GMAX + g] = p;
          sum += p;
        }
#pragma unroll
        for (int off = 16; off > 0; off >>= 1)
          sum += __shfl_xor_sync(0xffffffffu, sum, off);
        if (lane == 0) {
          const float coef = expf(m_old - m_new);
          coef_s[g] = coef;
          l_s[g] = l_s[g] * coef + sum;
          m_s[g] = m_new;
        }
      }
    }
    __syncthreads();

    // acc[g] = acc[g] * coef[g] + sum over this thread's slots of p * v
    {
      float part_sum[GMAX];
#pragma unroll
      for (int g = 0; g < GMAX; ++g) part_sum[g] = 0.f;
      for (int s = share; s < rows; s += NSPLIT) {
        const float vv = to_f(reinterpret_cast<const T*>(vs + s * rstride)[d]);
        const float4 p0 = *reinterpret_cast<const float4*>(ps + s * GMAX);
        const float4 p1 = *reinterpret_cast<const float4*>(ps + s * GMAX + 4);
        const float p[GMAX] = {p0.x, p0.y, p0.z, p0.w,
                               p1.x, p1.y, p1.z, p1.w};
#pragma unroll
        for (int g = 0; g < GMAX; ++g) part_sum[g] = fmaf(p[g], vv, part_sum[g]);
      }
#pragma unroll
      for (int g = 0; g < GMAX; ++g)
        if (g < G) acc[g] = acc[g] * coef_s[g] + part_sum[g];
    }
    __syncthreads();                           // stage t free for tile t+2
  }

  // sum the slot shares (in the stage buffers, idle now), normalise, store
  float* red = reinterpret_cast<float*>(stage);  // (NSPLIT, G, D)
#pragma unroll
  for (int g = 0; g < GMAX; ++g)
    if (g < G) red[(share * G + g) * D + d] = acc[g];
  __syncthreads();
  for (int i = threadIdx.x; i < G * D; i += NT) {
    float s = 0.f;
    for (int k = 0; k < NSPLIT; ++k) s += red[k * G * D + i];
    store(o + bh * G * D + i, s / fmaxf(l_s[i / D], 1e-30f));
  }

  if (pos >= 0 && pos < S) {                   // the in-place cache write
    const size_t off = (size_t)pos * slot_stride;
    for (int i = threadIdx.x; i < D; i += NT) {
      kc[((size_t)b * S * HKV + h) * D + off + i] = nk[bh * D + i];
      vc[((size_t)b * S * HKV + h) * D + off + i] = nv[bh * D + i];
    }
  }
}

template <typename T>
int launch(const void* q, void* kc, void* vc, const void* nk, const void* nv,
           const int* pos_dev, int pos_host, void* o, int B, int S, int HKV,
           int G, int D, float scale, void* stream) {
  if (G < 1 || G > GMAX || (D != 16 && D != 32 && D != 64 && D != 128))
    return (int)cudaErrorInvalidValue;
  const size_t rstride = D * sizeof(T) + PAD;
  const size_t smem = 4 * TS * rstride
                      + sizeof(float) * (GMAX * D + TS * GMAX + 3 * GMAX);
  cudaError_t err = cudaFuncSetAttribute(
      decode_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  decode_kernel<T><<<B * HKV, NT, smem, (cudaStream_t)stream>>>(
      (const T*)q, (T*)kc, (T*)vc, (const T*)nk, (const T*)nv, pos_dev,
      pos_host, (T*)o, S, HKV, G, D, scale);
  return (int)cudaGetLastError();
}

}  // namespace

// Plain C entry points. pos_dev: a device int32 holding pos, or null to use
// pos_host. G <= 8, D in {16, 32, 64, 128}, every pointer 16-byte aligned.
// scale = 1/sqrt(D) in fp32. Return cudaGetLastError() (or the attribute
// error).
extern "C" int decode_attention_f32(const void* q, void* kc, void* vc,
                                    const void* nk, const void* nv,
                                    const int* pos_dev, int pos_host,
                                    void* o, int B, int S, int HKV, int G,
                                    int D, float scale, void* stream) {
  return launch<float>(q, kc, vc, nk, nv, pos_dev, pos_host, o, B, S, HKV, G,
                       D, scale, stream);
}

extern "C" int decode_attention_bf16(const void* q, void* kc, void* vc,
                                     const void* nk, const void* nv,
                                     const int* pos_dev, int pos_host,
                                     void* o, int B, int S, int HKV, int G,
                                     int D, float scale, void* stream) {
  return launch<__nv_bfloat16>(q, kc, vc, nk, nv, pos_dev, pos_host, o, B, S,
                               HKV, G, D, scale, stream);
}

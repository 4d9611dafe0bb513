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
// operations a byte in bf16, 2 in fp32), far below the card's balance. So
// the design is about keeping enough bytes in flight on every SM.
//
// Design: a split over the slots ("flash-decoding"), then a merge in a
// fixed order. The TPU walks the slots of one (batch, KV head) in order on
// one core; here the P blocks of a (b, h) (grid (B*HKV, P); P from the
// wrapper's decode_split, never from pos, so a device pos and a CUDA graph
// replay keep working) each take a near-equal share of whole 64-slot tiles
// of 0..pos, worked out on the device from pos: block j takes tiles
// [j*T/P, (j+1)*T/P) of T. A block whose share is empty exits at once, so
// pos 0 costs one block's work. P fills one wave of 3 blocks an SM (the
// rings' 64 KB of shared memory a block), so every block streams at once.
//
// The walk inside a block. Each of the 4 warps streams its own steps of
// the share (steps w, w+4, ...) through a private ring of 4 cp.async
// stages (12 KB in flight a warp), and no barrier stands in the loop: a
// lane reads back only the 16-byte chunks it copied, so
// cp.async.wait_group orders it. A row of K or V is C = D*sizeof(T)/16
// lanes wide; a warp load covers 32/C rows, and each such row group keeps
// its own running max, normaliser and acc[g][its chunk of d] for all G
// rows. A step is U loads (16 (slot, row) pairs); the C lanes of a row
// group reduce-scatter their partial scores, so each lane holds one pair
// (or a few, for narrow rows), takes that row's new max over the step by
// two shuffles and computes the pair's exp and the row's rescale: two expf
// a lane instead of the 20 that every lane would repeat, and 16 shuffles
// to give every lane every p for P*V. Slot pos is copied from new_k/new_v
// instead of the cache (as jnp.where(at_pos, ...) does), so no block reads
// the slot that the block owning pos writes in place (one slot: no copy of
// the cache). Stale slots past pos are never loaded.
//
// The merge. At the end the row groups of a warp meet by shuffles, the
// warps in warp order in shared memory, and the block writes its partial
// (acc[G][D] and m, l a row, unnormalised, fp32) to the wrapper's
// workspace; a lone share (one tile, or P 1) writes o itself. A second
// kernel, one block an output row, merges the P partials in split order:
// m = max m_j, o = sum e^(m_j - m) acc_j / max(sum e^(m_j - m) l_j,
// 1e-30), rounded once to the output dtype (__float2bfloat16_rn for bf16).
// Both kernels are launched as programmatic dependents
// (griddepcontrol.wait before the first read), so each launch overlaps the
// kernel before it. Every sum meets in a fixed order: two calls give the
// same bits. No atomics, no counter that lives across calls. expf, never
// __expf: the build uses no fast math.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <cstdint>

#include "hopper.cuh"

namespace {

constexpr int TS = 64;           // slots a tile: the unit of a split's share
constexpr int NW = 4;            // warps a block, each its own slot stream
constexpr int NT = 32 * NW;
constexpr int NS = 4;            // cp.async ring stages a warp
constexpr int RESIDENT = 3;      // blocks an SM holds (G <= 4: the ring's
                                 // 64 KB; kernels/decode_attention.py)
constexpr int GMAX = 8;          // query rows per KV head, at most
constexpr int MT = 256;          // merge threads an output row
constexpr float NEG = -1e30f;

template <typename T> struct Chunk;            // one 16-byte chunk as floats
template <> struct Chunk<float> {
  static constexpr int E = 4;
  __device__ static void get(const void* p, float (&f)[E]) {
    const float4 a = *reinterpret_cast<const float4*>(p);
    f[0] = a.x; f[1] = a.y; f[2] = a.z; f[3] = a.w;
  }
};
template <> struct Chunk<__nv_bfloat16> {
  static constexpr int E = 8;
  __device__ static void get(const void* p, float (&f)[E]) {
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

__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16_rn(v);
}
__device__ __forceinline__ void store4(float* p, const float (&v)[4]) {
  *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
}
__device__ __forceinline__ void store4(__nv_bfloat16* p, const float (&v)[4]) {
  __nv_bfloat162 h[2] = {__floats2bfloat162_rn(v[0], v[1]),
                         __floats2bfloat162_rn(v[2], v[3])};
  *reinterpret_cast<uint2*>(p) = *reinterpret_cast<const uint2*>(h);
}

// The valid slots 0..pos (pos clamped to the cache) and pos itself.
__device__ __forceinline__ int valid_slots(const int* pos_dev, int pos_host,
                                           int S, int& pos) {
  pos = pos_dev ? *pos_dev : pos_host;
  return max(0, min(pos, S - 1) + 1);
}

// Split j's share of n slots: whole tiles, dealt out near-equally in order;
// the last tile cut at n. Empty (s0 >= s1) when P exceeds the tiles.
__device__ __forceinline__ void split_share(int n, int j, int P, int& s0,
                                            int& s1) {
  const long long tiles = (n + TS - 1) / TS;
  s0 = (int)(j * tiles / P) * TS;
  s1 = min((int)((j + 1) * tiles / P) * TS, n);
}

// The reduce-scatter of N partial sums over the lanes of a row group:
// at offset O a lane keeps the half of v that its lane bit O names and
// adds the partner's copy of that half, so after offsets C/2, ..., each
// lane holds the sums of N/C pairs, those of the lanes above it after them
// (v[0..N/C): pairs c*N/C + k), or of one pair when C >= N.
template <int O, int N>
__device__ __forceinline__ void scatter_sum(float* v, int c) {
  if constexpr (N > 1 && O > 0) {
    constexpr int H = N / 2;
    const bool hi = c & O;
#pragma unroll
    for (int k = 0; k < H; ++k) {
      const float send = hi ? v[k] : v[H + k];
      const float keep = hi ? v[H + k] : v[k];
      v[k] = keep + __shfl_xor_sync(0xffffffffu, send, O);
    }
    scatter_sum<O / 2, H>(v, c);
  }
}

// The geometry of one instantiation: T the element, D the head width, GM
// the query rows a KV head the registers hold (4, or 8 for G > 4).
template <typename T, int D, int GM> struct Geo {
  static constexpr int E = Chunk<T>::E;      // elements a 16-byte chunk
  static constexpr int C = D / E;            // lanes a row
  static constexpr int R = 32 / C;           // rows a warp load
  static constexpr int U = GM == 8 ? 2 : 4;  // loads a lane a matrix a step
  static constexpr int SW = U * R;           // slots a warp step
  static constexpr int STAGE = 2 * U * 32 * 16;    // bytes: K chunks, V chunks
  static constexpr int SMEM = NW * NS * STAGE;
  static_assert(C >= 1 && C <= 32 && 32 % C == 0, "a row in whole lanes");
  static_assert((NW * GM * (D + 2) + (NW + 2) * GM) * 4 <= SMEM,
                "the warps' partials and their weights fit");
};

template <typename T, int D, int GM>
__global__ void __launch_bounds__(NT, RESIDENT)
decode_split_kernel(const T* __restrict__ q, T* kc, T* vc,
                    const T* __restrict__ nk, const T* __restrict__ nv,
                    const int* __restrict__ pos_dev, int pos_host,
                    float* __restrict__ ws_acc, float* __restrict__ ws_ml,
                    T* __restrict__ o, int S, int HKV, int G, float scale) {
  using Gm = Geo<T, D, GM>;
  constexpr int E = Gm::E, C = Gm::C, R = Gm::R, U = Gm::U, SW = Gm::SW;
  constexpr int NP = U * GM;                   // (slot, row) pairs a step
  constexpr int REP = C > NP ? C / NP : 1;     // lanes holding each pair
  constexpr int NH = C < NP ? NP / C : 1;      // pairs a lane holds
  // the lowest lane offset between lanes holding one row's other slots
  constexpr int UO = REP * (GM > NH ? GM / NH : 1);
  extern __shared__ __align__(16) unsigned char smem[];

  const int bh = blockIdx.x, j = blockIdx.y, P = gridDim.y;
  const int b = bh / HKV, h = bh % HKV;
  // launched as a programmatic dependent of the stream's previous kernel:
  // nothing is read before that grid has finished (its launch overlaps)
  asm volatile("griddepcontrol.wait;\n" ::: "memory");
  int pos;
  const int n_valid = valid_slots(pos_dev, pos_host, S, pos);
  int s0, s1;
  split_share(n_valid, j, P, s0, s1);
  if (s0 >= s1) return;                        // an empty share

  const size_t head = ((size_t)b * S * HKV + h) * D;
  if (pos >= s0 && pos < s1) {                 // the in-place cache write,
    for (int i = threadIdx.x; i < D; i += NT) {  // by the share holding pos
      kc[head + (size_t)pos * HKV * D + i] = nk[(size_t)bh * D + i];
      vc[head + (size_t)pos * HKV * D + i] = nv[(size_t)bh * D + i];
    }
  }

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int r = lane / C, c = lane % C;        // row group, chunk of the row
  const int base = r * C;                      // the row group's first lane
  const size_t slot_stride = (size_t)HKV * D;  // elements between slots
  const T* kg = kc + head + c * E;             // this lane's chunk of slot 0
  const T* vg = vc + head + c * E;
  const T* nkg = nk + (size_t)bh * D + c * E;
  const T* nvg = nv + (size_t)bh * D + c * E;
  const uint32_t ring = smem_u32(smem) + warp * NS * Gm::STAGE + lane * 16;
  const unsigned char* ring_p = smem + warp * NS * Gm::STAGE + lane * 16;

  // this lane's chunk of the G query rows, times 1/sqrt(D) in fp32 as the
  // TPU kernel scales them
  float qr[GM][E];
#pragma unroll
  for (int g = 0; g < GM; ++g) {
    float f[E];
    if (g < G) {
      Chunk<T>::get(q + ((size_t)bh * G + g) * D + c * E, f);
    } else {
#pragma unroll
      for (int e = 0; e < E; ++e) f[e] = 0.f;
    }
#pragma unroll
    for (int e = 0; e < E; ++e) qr[g][e] = f[e] * scale;
  }

  // this warp's steps of SW slots: steps warp, warp + NW, ... of the share
  const int steps = (s1 - s0 + SW - 1) / SW;
  const int mine = steps > warp ? (steps - warp + NW - 1) / NW : 0;
  auto first_slot = [&](int k) { return s0 + (warp + k * NW) * SW + r; };
  auto issue = [&](int k) {
    if (k < mine) {
      const uint32_t st = ring + (k % NS) * Gm::STAGE;
#pragma unroll
      for (int u = 0; u < U; ++u) {
        const int slot = first_slot(k) + u * R;
        const bool ok = slot < s1, at = slot == pos;
        const size_t off = (size_t)slot * slot_stride;
        cp_async16(st + u * 512, !ok ? kg : at ? nkg : kg + off, ok);
        cp_async16(st + (U + u) * 512, !ok ? vg : at ? nvg : vg + off, ok);
      }
    }
    cp_async_commit();
  };

  float m[GM], l[GM], acc[GM][E];
#pragma unroll
  for (int g = 0; g < GM; ++g) {
    m[g] = NEG;
    l[g] = 0.f;
#pragma unroll
    for (int e = 0; e < E; ++e) acc[g][e] = 0.f;
  }

#pragma unroll
  for (int k = 0; k < NS - 1; ++k) issue(k);
  for (int k = 0; k < mine; ++k) {
    issue(k + NS - 1);                         // refills the stage read at k-1
    cp_async_wait<NS - 1>();                   // this lane's step k landed
    const unsigned char* st = ring_p + (k % NS) * Gm::STAGE;
    const int slot0 = first_slot(k);

    float s[NP];                   // score, then p, of pair u * GM + g
#pragma unroll
    for (int u = 0; u < U; ++u) {
      float kf[E];
      Chunk<T>::get(st + u * 512, kf);
#pragma unroll
      for (int g = 0; g < GM; ++g) {
        float a = 0.f;
#pragma unroll
        for (int e = 0; e < E; ++e) a = fmaf(qr[g][e], kf[e], a);
        s[u * GM + g] = a;
      }
    }
    // the row group's C lanes sum their partial scores, each lane keeping
    // NH of the NP (slot, row) pairs: pairs (c / REP) * NH + k
    scatter_sum<C / 2, NP>(s, c);
#pragma unroll
    for (int off = REP / 2; off > 0; off >>= 1)
      s[0] += __shfl_xor_sync(0xffffffffu, s[0], off);

    // each row's new running max over the step's valid slots, then the
    // exps of the pairs this lane holds: one or a few a lane, not NP
    float x[NH], mo[NH];
    bool ok[NH];
#pragma unroll
    for (int k = 0; k < NH; ++k) {
      const int pr = c / REP * NH + k, u = pr / GM, g = pr % GM;
      ok[k] = g < G && slot0 + u * R < s1;
      x[k] = ok[k] ? s[k] : NEG;
      mo[k] = m[0];
#pragma unroll
      for (int gg = 1; gg < GM; ++gg) mo[k] = g == gg ? m[gg] : mo[k];
    }
    if constexpr (NH > GM) {       // a lane holds several slots of a row
#pragma unroll
      for (int k = GM; k < NH; ++k) x[k % GM] = fmaxf(x[k % GM], x[k]);
    }
#pragma unroll
    for (int off = UO; off < C; off <<= 1)  // the lanes holding other slots
#pragma unroll
      for (int k = 0; k < (NH < GM ? NH : GM); ++k)
        x[k] = fmaxf(x[k], __shfl_xor_sync(0xffffffffu, x[k], off));
    float mn[NH], cf[NH];
#pragma unroll
    for (int k = 0; k < NH; ++k) {
      mn[k] = fmaxf(mo[k], x[k % GM]);
      cf[k] = expf(mo[k] - mn[k]);
      s[k] = ok[k] ? expf(s[k] - mn[k]) : 0.f;
    }
    // every lane of the row group gets every p, and each row's max and
    // rescale from the lane holding the row's first slot
    float p[NP];
#pragma unroll
    for (int pr = 0; pr < NP; ++pr)
      p[pr] = __shfl_sync(0xffffffffu, s[pr % NH], base + pr / NH * REP);
#pragma unroll
    for (int g = 0; g < GM; ++g) {
      if (g < G) {
        const int from = base + g / NH * REP;
        const float coef = __shfl_sync(0xffffffffu, cf[g % NH], from);
        m[g] = __shfl_sync(0xffffffffu, mn[g % NH], from);
        float sum = 0.f;
#pragma unroll
        for (int u = 0; u < U; ++u) sum += p[u * GM + g];
        l[g] = l[g] * coef + sum;
#pragma unroll
        for (int e = 0; e < E; ++e) acc[g][e] *= coef;
      }
    }
#pragma unroll
    for (int u = 0; u < U; ++u) {
      float vf[E];
      Chunk<T>::get(st + (U + u) * 512, vf);
#pragma unroll
      for (int g = 0; g < GM; ++g)
#pragma unroll
        for (int e = 0; e < E; ++e)
          acc[g][e] = fmaf(p[u * GM + g], vf[e], acc[g][e]);
    }
  }

  // the row groups of the warp meet (a fixed butterfly; row group 0 keeps
  // the warp's result)
#pragma unroll
  for (int off = C; off < 32; off <<= 1) {
#pragma unroll
    for (int g = 0; g < GM; ++g) {
      if (g < G) {
        const float mo = __shfl_xor_sync(0xffffffffu, m[g], off);
        const float lo = __shfl_xor_sync(0xffffffffu, l[g], off);
        const float mn = fmaxf(m[g], mo);
        const float a = expf(m[g] - mn), ao = expf(mo - mn);
        l[g] = l[g] * a + lo * ao;
        m[g] = mn;
#pragma unroll
        for (int e = 0; e < E; ++e)
          acc[g][e] = acc[g][e] * a
                      + __shfl_xor_sync(0xffffffffu, acc[g][e], off) * ao;
      }
    }
  }

  // the merge may start now; it waits for this grid before reading
  asm volatile("griddepcontrol.launch_dependents;\n" ::: "memory");

  // the warps meet in warp order (their rings are idle now), and the block
  // writes its partial: acc (G, D), then m and l a row; a lone share (one
  // tile, or P 1) writes o itself
  __syncthreads();
  float* red = reinterpret_cast<float*>(smem);  // (NW, GM, D + 2)
  if (r == 0) {
#pragma unroll
    for (int g = 0; g < GM; ++g) {
      if (g < G) {
        float* w = red + (warp * GM + g) * (D + 2);
#pragma unroll
        for (int e = 0; e < E; ++e) w[c * E + e] = acc[g][e];
        if (c == 0) {
          w[D] = m[g];
          w[D + 1] = l[g];
        }
      }
    }
  }
  __syncthreads();
  float* wgt = red + NW * GM * (D + 2);  // (NW + 2, GM): e^(m_w - m), m, l
  if (threadIdx.x < G) {
    const int g = threadIdx.x;
    float mb = NEG;
#pragma unroll
    for (int w = 0; w < NW; ++w)
      mb = fmaxf(mb, red[(w * GM + g) * (D + 2) + D]);
    float L = 0.f;
#pragma unroll
    for (int w = 0; w < NW; ++w) {
      const float a = expf(red[(w * GM + g) * (D + 2) + D] - mb);
      wgt[w * GM + g] = a;
      L += red[(w * GM + g) * (D + 2) + D + 1] * a;
    }
    wgt[NW * GM + g] = mb;
    wgt[(NW + 1) * GM + g] = L;
  }
  __syncthreads();
  const size_t part = (size_t)bh * P + j;
  const bool lone = P == 1 || n_valid <= TS;
  for (int i = threadIdx.x; i < G * D; i += NT) {
    const int g = i / D, d = i % D;
    const float mb = wgt[NW * GM + g], L = wgt[(NW + 1) * GM + g];
    float A = 0.f;
#pragma unroll
    for (int w = 0; w < NW; ++w)
      A += red[(w * GM + g) * (D + 2) + d] * wgt[w * GM + g];
    if (lone) {
      store(o + (size_t)bh * G * D + i, A / fmaxf(L, 1e-30f));
      continue;
    }
    ws_acc[part * G * D + i] = A;
    if (d == 0) {
      ws_ml[(part * G + g) * 2] = mb;
      ws_ml[(part * G + g) * 2 + 1] = L;
    }
  }
}

// The P partials of one (b, h, g) row merged in split order: each thread
// four outputs over the splits grp, grp + groups, ... (an online merge),
// then the groups in order. Launched as a programmatic dependent of the
// split kernel: it waits for that grid (griddepcontrol.wait) before
// reading the workspace. A lone non-empty share wrote o itself.
template <typename T>
__global__ void __launch_bounds__(MT)
decode_merge_kernel(const float* __restrict__ ws_acc,
                    const float* __restrict__ ws_ml,
                    const int* __restrict__ pos_dev, int pos_host,
                    T* __restrict__ o, int S, int G, int D, int P) {
  __shared__ float4 red_acc[MT];
  __shared__ float red_m[MT], red_l[MT];
  const int row = blockIdx.x, bh = row / G, g = row % G;   // o's row
  int pos;
  const int n_valid = valid_slots(pos_dev, pos_host, S, pos);
  const int tiles = (n_valid + TS - 1) / TS;
  asm volatile("griddepcontrol.wait;\n" ::: "memory");
  if (tiles == 1 || (P == 1 && tiles > 0)) return;   // written by its share

  const int nv4 = D / 4, groups = MT / nv4;
  const int v = threadIdx.x % nv4, grp = threadIdx.x / nv4;
  float m = NEG, L = 0.f;
  float4 A = make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll 4
  for (int jj = grp; jj < min(P, tiles); jj += groups) {
    // the jj-th full share: every share when P <= tiles; else each full
    // share holds one tile, and tile jj's is ceil((jj + 1) P / tiles) - 1
    const int j = P <= tiles
        ? jj : (int)(((long long)(jj + 1) * P + tiles - 1) / tiles) - 1;
    const size_t part = (size_t)bh * P + j;
    const float mj = ws_ml[(part * G + g) * 2];
    const float lj = ws_ml[(part * G + g) * 2 + 1];
    const float4 x = *reinterpret_cast<const float4*>(
        ws_acc + (part * G + g) * D + v * 4);
    const float mn = fmaxf(m, mj);
    const float a = expf(m - mn), b = expf(mj - mn);
    L = L * a + lj * b;
    A.x = A.x * a + x.x * b;
    A.y = A.y * a + x.y * b;
    A.z = A.z * a + x.z * b;
    A.w = A.w * a + x.w * b;
    m = mn;
  }
  red_acc[threadIdx.x] = A;
  red_m[threadIdx.x] = m;
  red_l[threadIdx.x] = L;
  __syncthreads();
  if (threadIdx.x < nv4) {
    for (int q = 1; q < groups; ++q) {
      const int t = q * nv4 + v;
      const float mn = fmaxf(m, red_m[t]);
      const float a = expf(m - mn), b = expf(red_m[t] - mn);
      const float4 x = red_acc[t];
      L = L * a + red_l[t] * b;
      A.x = A.x * a + x.x * b;
      A.y = A.y * a + x.y * b;
      A.z = A.z * a + x.z * b;
      A.w = A.w * a + x.w * b;
      m = mn;
    }
    const float den = fmaxf(L, 1e-30f);
    const float out[4] = {A.x / den, A.y / den, A.z / den, A.w / den};
    store4(o + (size_t)row * D + v * 4, out);
  }
}

// One call's arguments, as the C entries take them.
template <typename T> struct Args {
  const T* q; T* kc; T* vc; const T* nk; const T* nv;
  const int* pos_dev; int pos_host;
  T* o; float* ws_acc; float* ws_ml;
  int B, S, HKV, G, P; float scale; cudaStream_t st;
};

template <typename T, int D, int GM>
int launch_split(const Args<T>& a) {
  using Gm = Geo<T, D, GM>;
  static const cudaError_t attr = cudaFuncSetAttribute(
      decode_split_kernel<T, D, GM>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, Gm::SMEM);
  if (attr != cudaSuccess) return (int)attr;
  return launch_dependent(decode_split_kernel<T, D, GM>,
                          dim3(a.B * a.HKV, a.P), NT, Gm::SMEM, a.st, a.q,
                          a.kc, a.vc, a.nk, a.nv, a.pos_dev, a.pos_host,
                          a.ws_acc, a.ws_ml, a.o, a.S, a.HKV, a.G, a.scale);
}

template <typename T, int D>
int launch_d(const Args<T>& a) {
  return a.G <= 4 ? launch_split<T, D, 4>(a) : launch_split<T, D, 8>(a);
}

// The split kernel, then the merge as its programmatic dependent (its
// launch overlaps the split kernel's tail).
template <typename T>
int launch(const Args<T>& a, int D) {
  if (a.G < 1 || a.G > GMAX || a.P < 1 || a.P > 65535)  // gridDim.y
    return (int)cudaErrorInvalidValue;
  int err;
  switch (D) {
    case 16: err = launch_d<T, 16>(a); break;
    case 32: err = launch_d<T, 32>(a); break;
    case 64: err = launch_d<T, 64>(a); break;
    case 128: err = launch_d<T, 128>(a); break;
    default: return (int)cudaErrorInvalidValue;
  }
  if (err) return err;
  return launch_dependent(decode_merge_kernel<T>, dim3(a.B * a.HKV * a.G),
                          MT, 0, a.st, (const float*)a.ws_acc,
                          (const float*)a.ws_ml, a.pos_dev, a.pos_host, a.o,
                          a.S, a.G, D, a.P);
}

}  // namespace

// Plain C entry points. pos_dev: a device int32 holding pos, or null to use
// pos_host. G <= 8, D in {16, 32, 64, 128}, every pointer 16-byte aligned.
// P (1..65535) blocks a (batch, KV head) split the slots; ws an fp32
// workspace of B*HKV*P*G*(D+2) floats for their partials. scale =
// 1/sqrt(D) in fp32. Launches the split kernel, then the merge kernel, on
// the stream. Return the launch error, if any.
extern "C" int decode_attention_f32(const void* q, void* kc, void* vc,
                                    const void* nk, const void* nv,
                                    const int* pos_dev, int pos_host,
                                    void* o, float* ws, int B, int S, int HKV,
                                    int G, int D, int P, float scale,
                                    void* stream) {
  float* ws_ml = ws + (size_t)B * HKV * P * G * D;
  return launch<float>({(const float*)q, (float*)kc, (float*)vc,
                        (const float*)nk, (const float*)nv, pos_dev, pos_host,
                        (float*)o, ws, ws_ml, B, S, HKV, G, P, scale,
                        (cudaStream_t)stream}, D);
}

extern "C" int decode_attention_bf16(const void* q, void* kc, void* vc,
                                     const void* nk, const void* nv,
                                     const int* pos_dev, int pos_host,
                                     void* o, float* ws, int B, int S,
                                     int HKV, int G, int D, int P,
                                     float scale, void* stream) {
  using T = __nv_bfloat16;
  float* ws_ml = ws + (size_t)B * HKV * P * G * D;
  return launch<T>({(const T*)q, (T*)kc, (T*)vc, (const T*)nk, (const T*)nv,
                    pos_dev, pos_host, (T*)o, ws, ws_ml, B, S, HKV, G, P,
                    scale, (cudaStream_t)stream}, D);
}

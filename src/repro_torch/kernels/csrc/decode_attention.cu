// Single-token decode attention over a KV cache (flash-decoding, split-K):
//
//     out[b, h] = softmax_t(scale * q[b, h] . k[b, t, h / rep]) v[b, t, h / rep]
//     lse[b, h] = log sum_t exp(scale * q[b, h] . k[b, t, h / rep])
//     over the keys lengths[b] - window <= t < lengths[b] (no lower bound
//     without a window); q [B, Hq, D], k, v [B, T, Hkv, D], lengths [B] i32
//     -> out [B, Hq, D] in q's dtype, lse [B, Hq] f32
//
// Replaces the Pallas TPU kernel
// src/repro/kernels/decode_attention/kernel.py:decode_attention_pallas.
//
// Bound on Hopper: memory. Every valid key's k and v row is read once
// (2.2 MB a layer at the serve path's B=8, Hkv=2, D=64 bf16 and lengths
// about 528, 0.65 us at 3.35 TB/s) for 4 * rep * D flops a key: about
// 7 flops a byte at rep=7, far below the ~20 a byte at which the card's
// fp32 units, not HBM, would limit it.
//
// Design: the TPU kernel walks the cache along a sequential grid axis,
// one block per (b, KV head), with the online-softmax state in VMEM. On
// the card one block per (b, KV head) would be 16 blocks for 132 SMs at
// the serve shape, so the keys are split: the grid is (splits, Hkv, B),
// and each block takes the whole query group of one KV head (rep rows,
// as the TPU kernel does) over one range of keys, and writes its partial
// (acc, m, l) to scratch the wrapper allocates. A second kernel merges
// the splits into out and lse = m + log(max(l, 1e-30)). A split with no
// valid key writes m = -1e30, l = 0 and drops out of the merge (weight
// exp(-1e30 - M) = 0).
//
// Inside a block, a group of G = D / 4 lanes owns one key: each lane
// loads 4 consecutive elements of the key's k and v rows (8 bytes in
// bf16, 16 in f32) straight from the [B, T, Hkv, D] cache through its
// strides, with no copy, so a warp reads 32 / G whole rows, and the
// score is a log2(G)-step xor-shuffle sum. Each group keeps its own
// online-softmax state (m, l, acc) over the keys it visits, two keys a
// step so that two rows' loads are in flight; at the end the 128 / G
// groups of the block are merged through shared memory. Only valid keys
// are visited, so no masked score enters the sums. The update
// m_new = max(m, s), corr = exp(m - m_new), p = exp(s - m_new) is taken
// with one exp: exp(-|s - m|) is corr when s > m and p otherwise, the
// other being exp(0) = 1, bitwise the same as the two-exp form.
// The query group is a template bucket REP in {1, 2, 4, 8} (rows past
// rep compute with q = 0 and are not written); rep > 8 is refused.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;
constexpr int kVec = 4;          // elements of a row a lane holds
constexpr float kNegInf = -1e30f;

__device__ __forceinline__ void load4(const float* p, float (&x)[kVec]) {
  const float4 r = *reinterpret_cast<const float4*>(p);
  x[0] = r.x, x[1] = r.y, x[2] = r.z, x[3] = r.w;
}
__device__ __forceinline__ void load4(const __nv_bfloat16* p, float (&x)[kVec]) {
  const uint2 r = *reinterpret_cast<const uint2*>(p);
  const float2 a = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&r.x));
  const float2 c = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&r.y));
  x[0] = a.x, x[1] = a.y, x[2] = c.x, x[3] = c.y;
}
__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }
template <typename T>
__device__ __forceinline__ T from_f32(float x);
template <>
__device__ __forceinline__ float from_f32<float>(float x) { return x; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

struct Strides {  // element strides; D is unit-stride
  long long b, t, h;
};

template <typename T, int D, int REP>
__global__ void __launch_bounds__(kThreads)
decode_split_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                    const int* __restrict__ lengths, float* __restrict__ part_acc,
                    float* __restrict__ part_m, float* __restrict__ part_l, int T_len,
                    int Hkv, int rep, int chunk, Strides qs, Strides ks, Strides vs,
                    float scale, int window) {
  constexpr int G = D / kVec;                  // lanes a key
  constexpr int kGroups = kThreads / G;        // keys a block visits at once
  __shared__ float sm_m[kGroups][REP];
  __shared__ float sm_l[kGroups][REP];
  __shared__ float sm_acc[kGroups][REP][D];

  const int split = blockIdx.x, g = blockIdx.y, b = blockIdx.z;
  const int splits = gridDim.x;
  const int tid = threadIdx.x;
  const int grp = tid / G, lane_d = (tid % G) * kVec;

  const int len = min(lengths[b], T_len);
  const int lo = window > 0 ? max(len - window, 0) : 0;
  const int start = max(split * chunk, lo);
  const int end = min(split * chunk + chunk, len);

  float qr[REP][kVec];
#pragma unroll
  for (int r = 0; r < REP; ++r)
#pragma unroll
    for (int e = 0; e < kVec; ++e)
      qr[r][e] = r < rep ? to_f32(q[b * qs.b + (g * rep + r) * qs.h + lane_d + e]) : 0.0f;

  float m[REP], l[REP], acc[REP][kVec];
#pragma unroll
  for (int r = 0; r < REP; ++r) {
    m[r] = kNegInf;
    l[r] = 0.0f;
#pragma unroll
    for (int e = 0; e < kVec; ++e) acc[r][e] = 0.0f;
  }

  const T* kb = k + b * ks.b + g * ks.h + lane_d;
  const T* vb = v + b * vs.b + g * vs.h + lane_d;
  // every thread of the block runs the same number of steps, so the
  // shuffles always see the whole warp; a key past the range loads
  // nothing and updates nothing
  for (int base = start; base < end; base += 2 * kGroups) {
    const int t0 = base + 2 * grp;
    bool valid[2];
    float kx[2][kVec], vx[2][kVec];
#pragma unroll
    for (int u = 0; u < 2; ++u) {
      valid[u] = t0 + u < end;
      if (valid[u]) {
        load4(kb + (t0 + u) * ks.t, kx[u]);
        load4(vb + (t0 + u) * vs.t, vx[u]);
      } else {
#pragma unroll
        for (int e = 0; e < kVec; ++e) kx[u][e] = vx[u][e] = 0.0f;
      }
    }
#pragma unroll
    for (int u = 0; u < 2; ++u) {
#pragma unroll
      for (int r = 0; r < REP; ++r) {
        float s = 0.0f;
#pragma unroll
        for (int e = 0; e < kVec; ++e) s = fmaf(qr[r][e], kx[u][e], s);
#pragma unroll
        for (int off = G / 2; off > 0; off /= 2) s += __shfl_xor_sync(0xffffffffu, s, off);
        if (!valid[u]) continue;
        s *= scale;
        const float diff = s - m[r];
        const float x = expf(-fabsf(diff));
        const float corr = diff > 0.0f ? x : 1.0f;
        const float p = diff > 0.0f ? 1.0f : x;
        m[r] = fmaxf(m[r], s);
        l[r] = l[r] * corr + p;
#pragma unroll
        for (int e = 0; e < kVec; ++e) acc[r][e] = fmaf(p, vx[u][e], acc[r][e] * corr);
      }
    }
  }

  // merge the block's key groups through shared memory
  if (tid % G == 0) {
#pragma unroll
    for (int r = 0; r < REP; ++r) {
      sm_m[grp][r] = m[r];
      sm_l[grp][r] = l[r];
    }
  }
#pragma unroll
  for (int r = 0; r < REP; ++r)
#pragma unroll
    for (int e = 0; e < kVec; ++e) sm_acc[grp][r][lane_d + e] = acc[r][e];
  __syncthreads();

  const long long base = ((static_cast<long long>(b) * Hkv + g) * splits + split) * rep;
  for (int idx = tid; idx < rep * D; idx += kThreads) {
    const int r = idx / D, d = idx % D;
    float mx = kNegInf;
    for (int x = 0; x < kGroups; ++x) mx = fmaxf(mx, sm_m[x][r]);
    float ls = 0.0f, as = 0.0f;
    for (int x = 0; x < kGroups; ++x) {
      const float w = expf(sm_m[x][r] - mx);
      ls = fmaf(sm_l[x][r], w, ls);
      as = fmaf(sm_acc[x][r][d], w, as);
    }
    part_acc[(base + r) * D + d] = as;
    if (d == 0) {
      part_m[base + r] = mx;
      part_l[base + r] = ls;
    }
  }
}

// one block a (query head, b): merges the splits' partials
template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
decode_merge_kernel(const float* __restrict__ part_acc, const float* __restrict__ part_m,
                    const float* __restrict__ part_l, T* __restrict__ out,
                    float* __restrict__ lse, int Hq, int Hkv, int splits) {
  const int h = blockIdx.x, b = blockIdx.y;
  const int rep = Hq / Hkv;
  const int g = h / rep, r = h % rep;
  // partial s of (b, g, r) sits at ((b * Hkv + g) * splits + s) * rep + r
  const long long first = (static_cast<long long>(b) * Hkv + g) * splits * rep + r;
  float mx = kNegInf;
  for (int s = 0; s < splits; ++s) mx = fmaxf(mx, part_m[first + s * rep]);
  float ls = 0.0f;
  for (int s = 0; s < splits; ++s) {
    ls = fmaf(part_l[first + s * rep], expf(part_m[first + s * rep] - mx), ls);
  }
  const float denom = fmaxf(ls, 1e-30f);
  for (int d = threadIdx.x; d < D; d += kThreads) {
    float as = 0.0f;
    for (int s = 0; s < splits; ++s) {
      as = fmaf(part_acc[(first + s * rep) * D + d], expf(part_m[first + s * rep] - mx), as);
    }
    out[(static_cast<long long>(b) * Hq + h) * D + d] = from_f32<T>(as / denom);
  }
  if (threadIdx.x == 0) lse[static_cast<long long>(b) * Hq + h] = mx + logf(denom);
}

template <typename T, int D, int REP>
int launch(const void* q, const void* k, const void* v, const int* lengths, void* out,
           float* lse, float* part_acc, float* part_m, float* part_l, int B, int Hq, int T_len,
           int Hkv, int splits, const long long* st, float scale, int window,
           cudaStream_t stream) {
  const int rep = Hq / Hkv;
  const int chunk = (T_len + splits - 1) / splits;
  const Strides qs{st[0], 0, st[1]}, ks{st[2], st[3], st[4]}, vs{st[5], st[6], st[7]};
  decode_split_kernel<T, D, REP><<<dim3(splits, Hkv, B), kThreads, 0, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v), lengths,
      part_acc, part_m, part_l, T_len, Hkv, rep, chunk, qs, ks, vs, scale, window);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  decode_merge_kernel<T, D><<<dim3(Hq, B), kThreads, 0, stream>>>(
      part_acc, part_m, part_l, static_cast<T*>(out), lse, Hq, Hkv, splits);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, int D>
int by_rep(int rep, const void* q, const void* k, const void* v, const int* lengths,
           void* out, float* lse, float* pa, float* pm, float* pl, int B, int Hq, int T_len,
           int Hkv, int splits, const long long* st, float scale, int window,
           cudaStream_t stream) {
  if (rep <= 1)
    return launch<T, D, 1>(q, k, v, lengths, out, lse, pa, pm, pl, B, Hq, T_len, Hkv, splits,
                           st, scale, window, stream);
  if (rep <= 2)
    return launch<T, D, 2>(q, k, v, lengths, out, lse, pa, pm, pl, B, Hq, T_len, Hkv, splits,
                           st, scale, window, stream);
  if (rep <= 4)
    return launch<T, D, 4>(q, k, v, lengths, out, lse, pa, pm, pl, B, Hq, T_len, Hkv, splits,
                           st, scale, window, stream);
  if (rep <= 8)
    return launch<T, D, 8>(q, k, v, lengths, out, lse, pa, pm, pl, B, Hq, T_len, Hkv, splits,
                           st, scale, window, stream);
  return static_cast<int>(cudaErrorInvalidValue);
}

template <typename T>
int dispatch(int D, int rep, const void* q, const void* k, const void* v, const int* lengths,
             void* out, float* lse, float* pa, float* pm, float* pl, int B, int Hq, int T_len,
             int Hkv, int splits, const long long* st, float scale, int window,
             cudaStream_t stream) {
  switch (D) {
    case 32:
      return by_rep<T, 32>(rep, q, k, v, lengths, out, lse, pa, pm, pl, B, Hq, T_len, Hkv,
                           splits, st, scale, window, stream);
    case 64:
      return by_rep<T, 64>(rep, q, k, v, lengths, out, lse, pa, pm, pl, B, Hq, T_len, Hkv,
                           splits, st, scale, window, stream);
    case 128:
      return by_rep<T, 128>(rep, q, k, v, lengths, out, lse, pa, pm, pl, B, Hq, T_len, Hkv,
                            splits, st, scale, window, stream);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

bool valid_shape(int B, int Hq, int T_len, int Hkv, int splits) {
  return B > 0 && B <= 65535 && T_len > 0 && Hkv > 0 && Hkv <= 65535 && Hq <= 65535 &&
         Hq % Hkv == 0 && Hq / Hkv <= 8 && splits > 0;
}

}  // namespace

// Plain C entry points for ctypes: device pointers (lengths int32; the
// partials are f32 scratch of splits * B * Hq * (D + 2) floats laid out as
// acc [B, Hkv, splits, rep, D], m and l [B, Hkv, splits, rep]), 8 element
// strides (b, head of q; b, t, head of k and v), window <= 0 for none, the
// CUDA stream as a pointer. Launches the split kernel, then the merge
// kernel; the return value is cudaGetLastError() after them.
extern "C" int decode_attention_f32(const void* q, const void* k, const void* v,
                                    const void* lengths, void* out, void* lse, void* part_acc,
                                    void* part_m, void* part_l, int B, int Hq, int T_len,
                                    int Hkv, int D, int splits, const long long* strides,
                                    float scale, int window, void* stream) {
  if (!valid_shape(B, Hq, T_len, Hkv, splits)) return static_cast<int>(cudaErrorInvalidValue);
  return dispatch<float>(D, Hq / Hkv, q, k, v, static_cast<const int*>(lengths), out,
                         static_cast<float*>(lse), static_cast<float*>(part_acc),
                         static_cast<float*>(part_m), static_cast<float*>(part_l), B, Hq,
                         T_len, Hkv, splits, strides, scale, window,
                         static_cast<cudaStream_t>(stream));
}

extern "C" int decode_attention_bf16(const void* q, const void* k, const void* v,
                                     const void* lengths, void* out, void* lse, void* part_acc,
                                     void* part_m, void* part_l, int B, int Hq, int T_len,
                                     int Hkv, int D, int splits, const long long* strides,
                                     float scale, int window, void* stream) {
  if (!valid_shape(B, Hq, T_len, Hkv, splits)) return static_cast<int>(cudaErrorInvalidValue);
  return dispatch<__nv_bfloat16>(D, Hq / Hkv, q, k, v, static_cast<const int*>(lengths), out,
                                 static_cast<float*>(lse), static_cast<float*>(part_acc),
                                 static_cast<float*>(part_m), static_cast<float*>(part_l), B,
                                 Hq, T_len, Hkv, splits, strides, scale, window,
                                 static_cast<cudaStream_t>(stream));
}

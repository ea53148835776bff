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
// about 528, 0.65 us at 3.35 TB/s; 520 MB at B=32, T=32,768, 155 us) for
// 4 * rep * D flops a key: about 7 flops a byte at rep=7.
//
// Split-K, both routes: the TPU kernel walks the cache along a
// sequential grid axis, one block per (b, KV head), with the online-
// softmax state in VMEM. On the card one block per (b, KV head) would be
// 16 blocks for 132 SMs at the serve shape, so the keys are split: the
// grid is (splits, Hkv, B) (the wrapper's num_splits plans it), and each
// block takes the whole query group of one KV head (rep rows, as the TPU
// kernel does) over one range of keys, and writes its partial (acc, m,
// l) to scratch the wrapper allocates. A second kernel merges the splits
// into out and lse = m + log(max(l, 1e-30)). A split with no valid key
// writes m = -1e30, l = 0 and drops out of the merge (weight
// exp(-1e30 - M) = 0). Only valid keys enter the sums. The merge stays a
// kernel of its own: folding it into the split kernel (the last block of
// a (b, KV head) merges) needs a counter that survives between calls,
// and CUDA-graph capture does not zero one.
//
// bf16, the serve path: the HBM stream is fed by a ring and the products
// run on the tensor cores. A block of 4 warps streams its split's valid
// keys in 64-row tiles of K and V through a ring of kDecStages buffers in
// dynamic shared memory, filled by 16-byte cp.async copies (rows outside
// the split zero-filled), so each block keeps two tiles, 18 KB at D=64,
// in flight while it computes a third; three blocks fit an SM. Rows are
// padded by 16 bytes for conflict-free ldmatrix. The query group's rep
// rows (7 for qwen2-0.5b) fill rows 0..rep-1 of the M=16 side of
// mma.sync m16n8k16 (rows past rep are zero). Each warp takes 16 keys of
// a tile: S = Q K^T in two 8-key n-tiles, the online softmax on the
// accumulator fragments (log2 units, exp2; a row's max by two
// xor-shuffles), and P V with P kept in registers as a bf16 pair hi + lo
// (two products, see mma_bf16.cuh). Each warp keeps its own (m, l, acc);
// at the end the four are merged through shared memory into the block's
// partial.
//
// f32: the scalar kernel of the first port, kept because f32 on the
// tensor cores would be TF32 (about three digits), which the f32 check
// (rtol = atol = 1e-5) would not hold; no served model runs it. A group
// of G = D / 4 lanes owns one key: each lane loads 4 consecutive
// elements of the key's k and v rows straight from the cache, so a warp
// reads 32 / G whole rows, and the score is a log2(G)-step xor-shuffle
// sum. Each group keeps its own online-softmax state over the keys it
// visits, two keys a step; at the end the 128 / G groups of the block
// are merged through shared memory. The update m_new = max(m, s),
// corr = exp(m - m_new), p = exp(s - m_new) is taken with one exp:
// exp(-|s - m|) is corr when s > m and p otherwise, the other being
// exp(0) = 1, bitwise the same as the two-exp form. The query group is a
// template bucket REP in {1, 2, 4, 8} (rows past rep compute with q = 0
// and are not written). rep > 8 is refused on both routes.
//
// Times, bf16, split and merge kernels together, on one NVIDIA H100 80GB
// HBM3 at a 700.00 W power limit (chip_smoke.py, device time under
// CUDA-graph replay; PERF.md, PR 15): 0.0070 ms at the serve shape (SDPA
// with a length mask 0.0126, bound 0.00065: launch-bound) and 0.202 ms
// at B=32, T=32,768 (SDPA 0.212, bound 0.155: 77 % of HBM's rate),
// against PR 13's 0.0157 and 1.260 ms. What holds the last 23 % there
// is not measured (candidates: the ring's depth, the tail of 1,088
// blocks on 132 SMs).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "mma_bf16.cuh"

namespace {

constexpr int kThreads = 128;
constexpr int kVec = 4;          // f32: elements of a row a lane holds
constexpr float kNegInf = -1e30f;
constexpr float kLog2e = 1.4426950408889634f;
constexpr float kLn2 = 0.6931471805599453f;

__device__ __forceinline__ void load4(const float* p, float (&x)[kVec]) {
  const float4 r = *reinterpret_cast<const float4*>(p);
  x[0] = r.x, x[1] = r.y, x[2] = r.z, x[3] = r.w;
}
__device__ __forceinline__ float to_f32(float x) { return x; }
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


// ---- bf16: a cp.async ring and mma.sync -------------------------------

using bf16 = __nv_bfloat16;
constexpr int kTK = 64;        // keys a tile, 16 a warp
constexpr int kDecStages = 3;  // tiles in the ring
constexpr int kQRows = 16;     // the M side of m16n8k16; rows past rep are 0

template <int D>
constexpr int dec_smem_bytes() {
  return (kQRows + 2 * kDecStages * kTK) * (D + 8) * static_cast<int>(sizeof(bf16));
}

template <int D>
__global__ void __launch_bounds__(kThreads)
decode_split_mma_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                        const bf16* __restrict__ v, const int* __restrict__ lengths,
                        float* __restrict__ part_acc, float* __restrict__ part_m,
                        float* __restrict__ part_l, int T_len, int Hkv, int rep, int chunk,
                        Strides qs, Strides ks, Strides vs, float scale_log2, int window) {
  using namespace mma_bf16;
  constexpr int kLd = D + 8;      // a row in shared memory, padded by 16 bytes
  constexpr int kPieces = D / 8;  // 16-byte pieces a row
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* Qs = reinterpret_cast<bf16*>(smem_raw);  // [kQRows][kLd]
  bf16* Ks = Qs + kQRows * kLd;                  // [kDecStages][kTK][kLd]
  bf16* Vs = Ks + kDecStages * kTK * kLd;        // [kDecStages][kTK][kLd]

  const int split = blockIdx.x, g = blockIdx.y, b = blockIdx.z;
  const int splits = gridDim.x;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;

  const int len = min(lengths[b], T_len);
  const int lo = window > 0 ? max(len - window, 0) : 0;
  const int start = max(split * chunk, lo);
  const int end = min(split * chunk + chunk, len);
  const long long base = ((static_cast<long long>(b) * Hkv + g) * splits + split) * rep;
  if (start >= end) {  // no valid key: drops out of the merge
    for (int idx = tid; idx < rep * D; idx += kThreads) {
      part_acc[(base + idx / D) * D + idx % D] = 0.0f;
      if (idx % D == 0) {
        part_m[base + idx / D] = kNegInf;
        part_l[base + idx / D] = 0.0f;
      }
    }
    return;
  }

  // the query group, rows past rep zero-filled: group 0 with the first tile
  const bf16* qg = q + b * qs.b + static_cast<long long>(g) * rep * qs.h;
  for (int c = tid; c < kQRows * kPieces; c += kThreads) {
    const int r = c / kPieces, d = (c % kPieces) * 8;
    cp_async16(smem_addr(Qs + r * kLd + d), qg + (r < rep ? r : 0) * qs.h + d, r < rep);
  }

  const bf16* kb = k + b * ks.b + g * ks.h;
  const bf16* vb = v + b * vs.b + g * vs.h;
  const int n_tiles = (end - start + kTK - 1) / kTK;
  auto load_tile = [&](int tile) {
    const int t0 = start + tile * kTK;
    bf16* kd = Ks + (tile % kDecStages) * kTK * kLd;
    bf16* vd = Vs + (tile % kDecStages) * kTK * kLd;
    for (int c = tid; c < kTK * kPieces; c += kThreads) {
      const int r = c / kPieces, d = (c % kPieces) * 8;
      const bool in = t0 + r < end;
      const long long t = in ? t0 + r : start;
      cp_async16(smem_addr(kd + r * kLd + d), kb + t * ks.t + d, in);
      cp_async16(smem_addr(vd + r * kLd + d), vb + t * vs.t + d, in);
    }
  };
#pragma unroll
  for (int s = 0; s < kDecStages - 1; ++s) {
    if (s < n_tiles) load_tile(s);
    cp_async_commit();  // one group a stage, empty or not, to keep the count
  }

  // this lane's row of the group is lane / 4 (rows 8..15 are past rep)
  uint32_t qf[D / 16][4];
  float acc[D / 8][4];
#pragma unroll
  for (int n = 0; n < D / 8; ++n) acc[n][0] = acc[n][1] = acc[n][2] = acc[n][3] = 0.0f;
  float m = kNegInf, l = 0.0f;

  for (int i = 0; i < n_tiles; ++i) {
    cp_async_wait<kDecStages - 2>();  // tile i (and with it Q) has landed
    __syncthreads();                  // ... for every thread; tile i - 1 is done
    if (i + kDecStages - 1 < n_tiles) load_tile(i + kDecStages - 1);
    cp_async_commit();
    if (i == 0) {
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk)
        ldmatrix_x4(qf[kk], smem_addr(Qs + (lane % 16) * kLd + kk * 16 + (lane / 16) * 8));
    }
    // this warp's 16 keys of the tile
    const bf16* kt = Ks + ((i % kDecStages) * kTK + warp * 16) * kLd;
    const bf16* vt = Vs + ((i % kDecStages) * kTK + warp * 16) * kLd;

    float s[2][4] = {{0.0f, 0.0f, 0.0f, 0.0f}, {0.0f, 0.0f, 0.0f, 0.0f}};
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      uint32_t kf[4];
      ldmatrix_x4(kf, smem_addr(kt + (lane % 8 + (lane / 16) * 8) * kLd + kk * 16 +
                                ((lane / 8) % 2) * 8));
      mma(s[0], qf[kk], kf[0], kf[1]);
      mma(s[1], qf[kk], kf[2], kf[3]);
    }

    // row lane / 4 holds s[j][0..1], keys 8 j + 2 (lane % 4) + e
    const int t0 = start + i * kTK + warp * 16;
    float mx = kNegInf;
#pragma unroll
    for (int j = 0; j < 2; ++j) {
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const bool in = t0 + 8 * j + 2 * (lane % 4) + e < end;
        s[j][e] = in ? s[j][e] * scale_log2 : -INFINITY;
        mx = fmaxf(mx, s[j][e]);
      }
    }
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
    const float m_new = fmaxf(m, mx);
    const float corr = exp2f(m - m_new);
    m = m_new;
    l *= corr;
#pragma unroll
    for (int j = 0; j < 2; ++j) {
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        s[j][e] = exp2f(s[j][e] - m);
        l += s[j][e];
      }
    }
#pragma unroll
    for (int n = 0; n < D / 8; ++n) {
      acc[n][0] *= corr;
      acc[n][1] *= corr;
    }

    // O += P V over the warp's 16 keys; P's rows 8..15 are 0
    uint32_t ph[4] = {0u, 0u, 0u, 0u}, pl[4] = {0u, 0u, 0u, 0u};
    split_bf16(s[0][0], s[0][1], ph[0], pl[0]);
    split_bf16(s[1][0], s[1][1], ph[2], pl[2]);
#pragma unroll
    for (int dp = 0; dp < D / 16; ++dp) {
      uint32_t vf[4];
      ldmatrix_x4_trans(vf, smem_addr(vt + (lane % 8 + ((lane / 8) % 2) * 8) * kLd + dp * 16 +
                                      (lane / 16) * 8));
      mma(acc[2 * dp], ph, vf[0], vf[1]);
      mma(acc[2 * dp], pl, vf[0], vf[1]);
      mma(acc[2 * dp + 1], ph, vf[2], vf[3]);
      mma(acc[2 * dp + 1], pl, vf[2], vf[3]);
    }
  }
  cp_async_wait<0>();
  __syncthreads();  // every warp is done with the ring: it holds the merge now

  l += __shfl_xor_sync(0xffffffffu, l, 1);
  l += __shfl_xor_sync(0xffffffffu, l, 2);
  float* wm = reinterpret_cast<float*>(Ks);  // [4 warps][8 rows]
  float* wl = wm + 4 * 8;                    // [4][8]
  float* wacc = wl + 4 * 8;                  // [4][8][D]
  const int row = lane / 4;
  if (lane % 4 == 0) {
    wm[warp * 8 + row] = m;
    wl[warp * 8 + row] = l;
  }
#pragma unroll
  for (int n = 0; n < D / 8; ++n) {
    wacc[(warp * 8 + row) * D + 8 * n + 2 * (lane % 4)] = acc[n][0];
    wacc[(warp * 8 + row) * D + 8 * n + 2 * (lane % 4) + 1] = acc[n][1];
  }
  __syncthreads();

  for (int idx = tid; idx < rep * D; idx += kThreads) {
    const int r = idx / D, d = idx % D;
    float mx = kNegInf;
#pragma unroll
    for (int w = 0; w < 4; ++w) mx = fmaxf(mx, wm[w * 8 + r]);
    float ls = 0.0f, as = 0.0f;
#pragma unroll
    for (int w = 0; w < 4; ++w) {
      const float wt = exp2f(wm[w * 8 + r] - mx);
      ls = fmaf(wl[w * 8 + r], wt, ls);
      as = fmaf(wacc[(w * 8 + r) * D + d], wt, as);
    }
    part_acc[(base + r) * D + d] = as;
    if (d == 0) {
      part_m[base + r] = mx > kNegInf ? mx * kLn2 : kNegInf;  // natural log units
      part_l[base + r] = ls;
    }
  }
}

template <typename T, int D>
int launch_merge(const float* part_acc, const float* part_m, const float* part_l, void* out,
                 float* lse, int B, int Hq, int Hkv, int splits, cudaStream_t stream) {
  decode_merge_kernel<T, D><<<dim3(Hq, B), kThreads, 0, stream>>>(
      part_acc, part_m, part_l, static_cast<T*>(out), lse, Hq, Hkv, splits);
  return static_cast<int>(cudaGetLastError());
}

template <int D>
int launch_mma(const void* q, const void* k, const void* v, const int* lengths, void* out,
               float* lse, float* part_acc, float* part_m, float* part_l, int B, int Hq,
               int T_len, int Hkv, int splits, const long long* st, float scale, int window,
               cudaStream_t stream) {
  constexpr int smem = dec_smem_bytes<D>();
  static bool configured = false;  // above 48 KB only by opting in, once
  if (!configured) {
    const cudaError_t err = cudaFuncSetAttribute(
        decode_split_mma_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return static_cast<int>(err);
    configured = true;
  }
  const int chunk = (T_len + splits - 1) / splits;
  const Strides qs{st[0], 0, st[1]}, ks{st[2], st[3], st[4]}, vs{st[5], st[6], st[7]};
  decode_split_mma_kernel<D><<<dim3(splits, Hkv, B), kThreads, smem, stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k), static_cast<const bf16*>(v),
      lengths, part_acc, part_m, part_l, T_len, Hkv, Hq / Hkv, chunk, qs, ks, vs,
      scale * kLog2e, window);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  return launch_merge<bf16, D>(part_acc, part_m, part_l, out, lse, B, Hq, Hkv, splits, stream);
}

template <int D, int REP>
int launch_f32(const void* q, const void* k, const void* v, const int* lengths, void* out,
               float* lse, float* part_acc, float* part_m, float* part_l, int B, int Hq,
               int T_len, int Hkv, int splits, const long long* st, float scale, int window,
               cudaStream_t stream) {
  const int rep = Hq / Hkv;
  const int chunk = (T_len + splits - 1) / splits;
  const Strides qs{st[0], 0, st[1]}, ks{st[2], st[3], st[4]}, vs{st[5], st[6], st[7]};
  decode_split_kernel<float, D, REP><<<dim3(splits, Hkv, B), kThreads, 0, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k), static_cast<const float*>(v),
      lengths, part_acc, part_m, part_l, T_len, Hkv, rep, chunk, qs, ks, vs, scale, window);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  return launch_merge<float, D>(part_acc, part_m, part_l, out, lse, B, Hq, Hkv, splits, stream);
}

template <int D>
int by_rep_f32(int rep, const void* q, const void* k, const void* v, const int* lengths,
               void* out, float* lse, float* pa, float* pm, float* pl, int B, int Hq,
               int T_len, int Hkv, int splits, const long long* st, float scale, int window,
               cudaStream_t stream) {
  if (rep <= 1)
    return launch_f32<D, 1>(q, k, v, lengths, out, lse, pa, pm, pl, B, Hq, T_len, Hkv, splits,
                            st, scale, window, stream);
  if (rep <= 2)
    return launch_f32<D, 2>(q, k, v, lengths, out, lse, pa, pm, pl, B, Hq, T_len, Hkv, splits,
                            st, scale, window, stream);
  if (rep <= 4)
    return launch_f32<D, 4>(q, k, v, lengths, out, lse, pa, pm, pl, B, Hq, T_len, Hkv, splits,
                            st, scale, window, stream);
  if (rep <= 8)
    return launch_f32<D, 8>(q, k, v, lengths, out, lse, pa, pm, pl, B, Hq, T_len, Hkv, splits,
                            st, scale, window, stream);
  return static_cast<int>(cudaErrorInvalidValue);
}

// one entry a dtype: the f32 route by query-group bucket, bf16 by D alone
template <bool kBf16, int D>
int route(int rep, const void* q, const void* k, const void* v, const int* lengths, void* out,
          float* lse, float* pa, float* pm, float* pl, int B, int Hq, int T_len, int Hkv,
          int splits, const long long* st, float scale, int window, cudaStream_t stream) {
  if constexpr (kBf16)
    return launch_mma<D>(q, k, v, lengths, out, lse, pa, pm, pl, B, Hq, T_len, Hkv, splits, st,
                         scale, window, stream);
  else
    return by_rep_f32<D>(rep, q, k, v, lengths, out, lse, pa, pm, pl, B, Hq, T_len, Hkv,
                         splits, st, scale, window, stream);
}

template <bool kBf16>
int dispatch(int D, int rep, const void* q, const void* k, const void* v, const int* lengths,
             void* out, float* lse, float* pa, float* pm, float* pl, int B, int Hq, int T_len,
             int Hkv, int splits, const long long* st, float scale, int window,
             cudaStream_t stream) {
  switch (D) {
    case 32:
      return route<kBf16, 32>(rep, q, k, v, lengths, out, lse, pa, pm, pl, B, Hq, T_len, Hkv,
                              splits, st, scale, window, stream);
    case 64:
      return route<kBf16, 64>(rep, q, k, v, lengths, out, lse, pa, pm, pl, B, Hq, T_len, Hkv,
                              splits, st, scale, window, stream);
    case 128:
      return route<kBf16, 128>(rep, q, k, v, lengths, out, lse, pa, pm, pl, B, Hq, T_len, Hkv,
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
// kernel; the return value is cudaGetLastError() after them. The bf16
// route reads q, k and v with 16-byte copies: they start on 16-byte
// boundaries and their strides are multiples of 8 elements.
extern "C" int decode_attention_f32(const void* q, const void* k, const void* v,
                                    const void* lengths, void* out, void* lse, void* part_acc,
                                    void* part_m, void* part_l, int B, int Hq, int T_len,
                                    int Hkv, int D, int splits, const long long* strides,
                                    float scale, int window, void* stream) {
  if (!valid_shape(B, Hq, T_len, Hkv, splits)) return static_cast<int>(cudaErrorInvalidValue);
  return dispatch<false>(D, Hq / Hkv, q, k, v, static_cast<const int*>(lengths), out,
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
  return dispatch<true>(D, Hq / Hkv, q, k, v, static_cast<const int*>(lengths), out,
                        static_cast<float*>(lse), static_cast<float*>(part_acc),
                        static_cast<float*>(part_m), static_cast<float*>(part_l), B, Hq,
                        T_len, Hkv, splits, strides, scale, window,
                        static_cast<cudaStream_t>(stream));
}

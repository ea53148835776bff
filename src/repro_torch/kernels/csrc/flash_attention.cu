// Flash attention forward with grouped-query heads, causal and sliding-
// window masks, for prefill and training-shaped calls:
//
//     o[b, s, h] = softmax_t(scale * q[b, s, h] . k[b, t, h / rep]) v[b, t, h / rep]
//     q [B, S, Hq, D], k, v [B, T, Hkv, D] -> o [B, S, Hq, D] in q's dtype
//
// query s sits at position s + q_offset; it attends key t iff
// t <= s + q_offset (causal) and t > s + q_offset - window (window > 0).
//
// Replaces the Pallas TPU kernel
// src/repro/kernels/flash_attention/kernel.py:flash_attention_pallas.
//
// Bound on Hopper: at the serve path's prefill (B=8, S=T=512, Hq=14,
// Hkv=2, D=64, bf16, causal) the function reads 2.1 MB of k and v and
// 7.3 MB of q and writes 7.3 MB, 5.0 us at 3.35 TB/s, against 3.8 GFLOP
// of products, 3.8 us at the tensor cores' 989 TFLOP/s: bytes bound it by
// a little. At B=1, S=T=4096 the 30 GFLOP of products bound it, 30.4 us.
// (The kernel does 1.5x those products: P's hi and lo.)
//
// Two routes, chosen by dtype (not a fallback: each dtype has one):
//
// bf16, the serve path: FA2-style kernels on the tensor cores. A block of
// 4 warps (one warpgroup) owns one (b, query head, 64-row query tile);
// each warp owns 16 rows, whose Q fragments it loads with ldmatrix and
// keeps in registers. 64-key tiles of K and V, kept in bf16, pass
// through a ring of 2-3 buffers in dynamic shared memory, filled by
// 16-byte cp.async copies, so the next tiles' loads are in flight while
// the current tile's products run. The online softmax runs on the f32
// accumulator fragments of S (a row's 16 scores of a tile sit in 4
// lanes: two xor-shuffles for its max, the sum kept per lane until the
// end; scores in log2 units for exp2). P stays in registers and is the
// A operand of the P V product, as a bf16 pair hi + lo (two products):
// P rounded to bf16 alone breaks the bf16 check's 1e-3 + 8e-3 |out| near
// outputs of 0 (mma_bf16.cuh). m, l and the output sums stay f32. The
// mask is tested only on tiles that cross the diagonal, the window's edge
// or the end of the keys; the output sums are rescaled only when a row's
// max moved. Tiles run heaviest first (the last query tile, which attends
// the most keys). A block of 64 rows, not 128: at the serve shape (S=512)
// 128-row tiles would halve the blocks (448 on 132 SMs), and 32 rows a
// warp (128 a block of 4 warps) measured no faster on an H100 (their
// registers spill at D=64).
//   D = 64 (qwen2-0.5b, the served model): the products are Hopper's
// warpgroup products, wgmma m64n64k16, with K and V read by the tensor
// cores straight from shared memory (128-byte-swizzled tiles, one
// descriptor a k-step) and Q and P from registers.
//   D = 32, 128: mma.sync m16n8k16, K's and V's fragments loaded with
// ldmatrix (.trans for V) from rows padded by 16 bytes, so that each
// 8-row ldmatrix phase falls on 32 distinct banks.
// What holds them (H100, PERF.md): the products' issue, half again as
// many as a bf16-only P would need, and the SFU's exp2 for every score.
//
// f32: the scalar kernel of the first port. Its products are fp32 FMAs
// from shared memory (about 67 TFLOP/s at best): f32 on the tensor cores
// would be TF32, which keeps about three digits, and the f32 check
// (rtol = atol = 1e-5) would not hold it. No served model runs f32
// attention on the card. One block of 128 threads owns one (b, query
// head, 64-row query tile) and loops over 64-key tiles, so the online-
// softmax state stays in registers: thread (ty, tx) = (tid / 8, tid % 8)
// owns rows ty + 16 i (i < 4) and, for the scores, keys tx + 8 j
// (j < 8); for the output, columns tx + 8 j (j < D / 8). A row's scores
// live in the 8 lanes of one warp that share ty, so its max and sum are
// three xor-shuffles. Q, K, V tiles are staged in shared memory, rows
// padded by one float; P goes through shared memory to the PV product.
//
// Both: GQA is the KV head index h / (Hq / Hkv), any group size; q, k, v
// are read in place through their strides (no transpose to heads-major).
//
// Arithmetic, as the TPU kernel's: scores are (q . k) * scale in f32; a
// masked score is the finite -1e30, so a row that is fully masked inside a
// tile that runs adds exp(0) terms that the later
// corr = exp(m_prev - m_new) multiplies by 0; l is clamped at 1e-30.
// Tiles that are fully masked for the whole query tile are skipped (the
// TPU kernel's run condition, q_offset included). Unlike the TPU kernel,
// S and T need not be multiples of the tile: keys past T score -inf and
// add exactly 0, and rows past S are not written. A row with no key to
// attend at all (its running max is still -1e30 at the end) is written as
// 0, as the plain version gives.
//
// Times, bf16, on one NVIDIA H100 80GB HBM3 at a 700.00 W power limit
// (chip_smoke.py, device time under CUDA-graph replay; PERF.md, PR 15):
// 0.0298 ms at the serve shape (SDPA 0.0213, bound 0.0050) and 0.166 ms
// at B=1, S=T=4096 (SDPA 0.095, bound 0.030), against PR 13's scalar
// kernel's 0.2416 and 1.699 ms.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "mma_bf16.cuh"

namespace {

constexpr int kBQ = 64;        // query rows per block
constexpr int kBK = 64;        // keys per tile
constexpr int kThreads = 128;
constexpr int kRows = 4;       // f32: rows per thread, ty + 16 i
constexpr int kCols = 8;       // f32: score columns per thread, tx + 8 j
constexpr float kNegInf = -1e30f;
constexpr float kLog2e = 1.4426950408889634f;

__device__ __forceinline__ float to_f32(float x) { return x; }
template <typename T>
__device__ __forceinline__ T from_f32(float x);
template <>
__device__ __forceinline__ float from_f32<float>(float x) { return x; }

struct Strides {  // element strides of [B, seq, heads, D]; D is unit-stride
  long long b, s, h;
};

template <int D>
constexpr int smem_floats() {
  return kBQ * (D + 1) + kBK * (D + 1) + kBK * D + kBQ * (kBK + 1);
}

template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                 T* __restrict__ o, int S, int T_len, int Hq, int Hkv, Strides qs,
                 Strides ks, Strides vs, Strides os, float scale, int causal, int window,
                 int q_offset) {
  extern __shared__ float smem[];
  float* Qs = smem;                    // [kBQ][D + 1]
  float* Ks = Qs + kBQ * (D + 1);      // [kBK][D + 1]
  float* Vs = Ks + kBK * (D + 1);      // [kBK][D]
  float* Ps = Vs + kBK * D;            // [kBQ][kBK + 1]

  const int tid = threadIdx.x;
  const int ty = tid / 8, tx = tid % 8;
  const int q0 = blockIdx.x * kBQ;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int kvh = h / (Hq / Hkv);
  const int rows_here = min(kBQ, S - q0);

  const T* qb = q + b * qs.b + h * qs.h;
  const T* kb = k + b * ks.b + kvh * ks.h;
  const T* vb = v + b * vs.b + kvh * vs.h;

  for (int idx = tid; idx < kBQ * D; idx += kThreads) {
    const int r = idx / D, d = idx % D;
    Qs[r * (D + 1) + d] = r < rows_here ? to_f32(qb[(q0 + r) * qs.s + d]) : 0.0f;
  }

  // the key range any row of this tile attends: tiles outside it are
  // skipped as the TPU kernel's run condition skips them
  const int q_first = q0 + q_offset;
  const int q_last = q0 + rows_here - 1 + q_offset;
  int k_begin = 0;
  if (window > 0) k_begin = max(0, q_first - window + 1) / kBK * kBK;
  const int k_end = causal ? min(T_len, q_last + 1) : T_len;

  float m[kRows], l[kRows], acc[kRows][D / 8];
#pragma unroll
  for (int i = 0; i < kRows; ++i) {
    m[i] = kNegInf;
    l[i] = 0.0f;
#pragma unroll
    for (int j = 0; j < D / 8; ++j) acc[i][j] = 0.0f;
  }

  for (int k0 = k_begin; k0 < k_end; k0 += kBK) {
    __syncthreads();  // the previous tile's PV product is done with Vs, Ps
    for (int idx = tid; idx < kBK * D; idx += kThreads) {
      const int r = idx / D, d = idx % D;
      const int t = k0 + r;
      const bool in = t < T_len;
      Ks[r * (D + 1) + d] = in ? to_f32(kb[t * ks.s + d]) : 0.0f;
      Vs[r * D + d] = in ? to_f32(vb[t * vs.s + d]) : 0.0f;
    }
    __syncthreads();

    float s[kRows][kCols];
#pragma unroll
    for (int i = 0; i < kRows; ++i)
#pragma unroll
      for (int j = 0; j < kCols; ++j) s[i][j] = 0.0f;
#pragma unroll 4
    for (int d = 0; d < D; ++d) {
      float qv[kRows], kv[kCols];
#pragma unroll
      for (int i = 0; i < kRows; ++i) qv[i] = Qs[(ty + 16 * i) * (D + 1) + d];
#pragma unroll
      for (int j = 0; j < kCols; ++j) kv[j] = Ks[(tx + 8 * j) * (D + 1) + d];
#pragma unroll
      for (int i = 0; i < kRows; ++i)
#pragma unroll
        for (int j = 0; j < kCols; ++j) s[i][j] = fmaf(qv[i], kv[j], s[i][j]);
    }

#pragma unroll
    for (int i = 0; i < kRows; ++i) {
      const int r = ty + 16 * i;
      const int qpos = q_first + r;
      float row_max = kNegInf;
#pragma unroll
      for (int j = 0; j < kCols; ++j) {
        const int t = k0 + tx + 8 * j;
        float x = s[i][j] * scale;
        if (t >= T_len) {
          x = -INFINITY;  // past the end of the keys: adds exactly 0
        } else if ((causal && t > qpos) || (window > 0 && t <= qpos - window)) {
          x = kNegInf;
        }
        s[i][j] = x;
        row_max = fmaxf(row_max, x);
      }
      row_max = fmaxf(row_max, __shfl_xor_sync(0xffffffffu, row_max, 1));
      row_max = fmaxf(row_max, __shfl_xor_sync(0xffffffffu, row_max, 2));
      row_max = fmaxf(row_max, __shfl_xor_sync(0xffffffffu, row_max, 4));
      const float m_new = fmaxf(m[i], row_max);
      const float corr = expf(m[i] - m_new);
      float row_sum = 0.0f;
#pragma unroll
      for (int j = 0; j < kCols; ++j) {
        const float p = expf(s[i][j] - m_new);
        row_sum += p;
        Ps[r * (kBK + 1) + tx + 8 * j] = p;
      }
      row_sum += __shfl_xor_sync(0xffffffffu, row_sum, 1);
      row_sum += __shfl_xor_sync(0xffffffffu, row_sum, 2);
      row_sum += __shfl_xor_sync(0xffffffffu, row_sum, 4);
      l[i] = l[i] * corr + row_sum;
      m[i] = m_new;
#pragma unroll
      for (int j = 0; j < D / 8; ++j) acc[i][j] *= corr;
    }
    __syncthreads();

#pragma unroll 4
    for (int kk = 0; kk < kBK; ++kk) {
      float pv[kRows], vv[D / 8];
#pragma unroll
      for (int i = 0; i < kRows; ++i) pv[i] = Ps[(ty + 16 * i) * (kBK + 1) + kk];
#pragma unroll
      for (int j = 0; j < D / 8; ++j) vv[j] = Vs[kk * D + tx + 8 * j];
#pragma unroll
      for (int i = 0; i < kRows; ++i)
#pragma unroll
        for (int j = 0; j < D / 8; ++j) acc[i][j] = fmaf(pv[i], vv[j], acc[i][j]);
    }
  }

  T* ob = o + b * os.b + h * os.h;
#pragma unroll
  for (int i = 0; i < kRows; ++i) {
    const int r = ty + 16 * i;
    if (r >= rows_here) continue;
    const bool attended = m[i] > kNegInf;
    const float denom = fmaxf(l[i], 1e-30f);
#pragma unroll
    for (int j = 0; j < D / 8; ++j) {
      ob[(q0 + r) * os.s + tx + 8 * j] = from_f32<T>(attended ? acc[i][j] / denom : 0.0f);
    }
  }
}

template <typename T, int D>
int launch(const void* q, const void* k, const void* v, void* o, int B, int S, int T_len,
           int Hq, int Hkv, const long long* st, float scale, int causal, int window,
           int q_offset, cudaStream_t stream) {
  constexpr int smem = smem_floats<D>() * static_cast<int>(sizeof(float));
  static bool configured = false;  // above 48 KB only by opting in, once
  if (!configured) {
    const cudaError_t err = cudaFuncSetAttribute(
        flash_fwd_kernel<T, D>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return static_cast<int>(err);
    configured = true;
  }
  const Strides qs{st[0], st[1], st[2]}, ks{st[3], st[4], st[5]}, vs{st[6], st[7], st[8]},
      os{st[9], st[10], st[11]};
  const dim3 grid((S + kBQ - 1) / kBQ, Hq, B);
  flash_fwd_kernel<T, D><<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<T*>(o), S, T_len, Hq, Hkv, qs, ks, vs, os, scale, causal, window, q_offset);
  return static_cast<int>(cudaGetLastError());
}

// ---- bf16: the pieces both tensor-core kernels share -------------------

using bf16 = __nv_bfloat16;

// The online-softmax update of one tile's scores s in a lane's two rows
// (e = 0, 1 and e = 2, 3; a row's scores sit in the 4 lanes sharing
// lane / 4, so its max is two xor-shuffles): the running max m and sum l
// (this lane's part of it) move on, s becomes p = 2^(x - m), and corr is
// the factor the output sums take (exactly 1 where m stayed). kRaw: s
// holds raw q . k and x = s * scale_log2 (> 0) is folded into one FMA;
// else s holds x already.
template <bool kRaw, int N>
__device__ __forceinline__ void softmax_tile(float (&s)[N][4], float (&m)[2], float (&l)[2],
                                             float (&corr)[2], float scale_log2) {
  float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
  for (int j = 0; j < N; ++j) {
    mx[0] = fmaxf(mx[0], fmaxf(s[j][0], s[j][1]));
    mx[1] = fmaxf(mx[1], fmaxf(s[j][2], s[j][3]));
  }
#pragma unroll
  for (int u = 0; u < 2; ++u) {
    mx[u] = fmaxf(mx[u], __shfl_xor_sync(0xffffffffu, mx[u], 1));
    mx[u] = fmaxf(mx[u], __shfl_xor_sync(0xffffffffu, mx[u], 2));
    const float m_new = fmaxf(m[u], kRaw ? mx[u] * scale_log2 : mx[u]);
    corr[u] = m_new == m[u] ? 1.0f : mma_bf16::exp2_ftz(m[u] - m_new);
    m[u] = m_new;
    l[u] *= corr[u];
  }
#pragma unroll
  for (int j = 0; j < N; ++j) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      s[j][e] = mma_bf16::exp2_ftz(kRaw ? fmaf(s[j][e], scale_log2, -m[e / 2])
                                        : s[j][e] - m[e / 2]);
      l[e / 2] += s[j][e];
    }
  }
}

// Everything between a tile's two products: the tiles that cross an
// edge (the diagonal, the window's lower edge, the end of the keys) have
// their scores scaled into log2 units and masked (-inf past T, the
// finite -1e30 outside the causal or window range); elsewhere (with a
// positive scale) the scale folds into the exponent's FMA. Then the
// online-softmax update, and the output sums rescaled unless every row
// of the warp kept its max. qpos0 is the position of this lane's first
// row, q_first and q_last the block's.
template <int N, int ND>
__device__ __forceinline__ void softmax_step(float (&s)[N][4], float (&acc)[ND][4],
                                             float (&m)[2], float (&l)[2], int k0, int qpos0,
                                             int lane, int T_len, int causal, int window,
                                             int q_first, int q_last, float scale_log2) {
  const bool edge = k0 + 8 * N > T_len || (causal && k0 + 8 * N - 1 > q_first) ||
                    (window > 0 && k0 <= q_last - window);
  float corr[2];
  if (edge || !(scale_log2 > 0.0f)) {
#pragma unroll
    for (int j = 0; j < N; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float x = s[j][e] * scale_log2;
        const int t = k0 + 8 * j + 2 * (lane % 4) + (e % 2);
        const int qpos = qpos0 + 8 * (e / 2);
        if (t >= T_len) {
          x = -INFINITY;  // past the end of the keys: adds exactly 0
        } else if ((causal && t > qpos) || (window > 0 && t <= qpos - window)) {
          x = kNegInf;
        }
        s[j][e] = x;
      }
    }
    softmax_tile<false>(s, m, l, corr, scale_log2);
  } else {
    softmax_tile<true>(s, m, l, corr, scale_log2);
  }
  if (__any_sync(0xffffffffu, corr[0] != 1.0f || corr[1] != 1.0f)) {
#pragma unroll
    for (int n = 0; n < ND; ++n) {
      acc[n][0] *= corr[0];
      acc[n][1] *= corr[0];
      acc[n][2] *= corr[1];
      acc[n][3] *= corr[1];
    }
  }
}

// The output rows of this lane, o = acc / l (0 for a row with no key),
// as bf16 pairs: ob points at the lane's first row r0, rows_left rows
// from it are inside S (rows r0 and r0 + 8 are written where inside).
template <int ND>
__device__ __forceinline__ void store_rows(const float (&acc)[ND][4], const float (&m)[2],
                                           float (&l)[2], bf16* ob, long long row_stride,
                                           int rows_left, int lane) {
#pragma unroll
  for (int u = 0; u < 2; ++u) {
    l[u] += __shfl_xor_sync(0xffffffffu, l[u], 1);
    l[u] += __shfl_xor_sync(0xffffffffu, l[u], 2);
    if (8 * u >= rows_left) continue;
    const bool attended = m[u] > kNegInf;
    const float denom = fmaxf(l[u], 1e-30f);
#pragma unroll
    for (int n = 0; n < ND; ++n) {
      const float x = attended ? acc[n][2 * u] / denom : 0.0f;
      const float y = attended ? acc[n][2 * u + 1] / denom : 0.0f;
      *reinterpret_cast<__nv_bfloat162*>(ob + 8 * u * row_stride + 8 * n + 2 * (lane % 4)) =
          __floats2bfloat162_rn(x, y);
    }
  }
}

// ---- bf16, D = 32, 128: mma.sync ---------------------------------------

template <int D>
struct FlashTiles {
  static constexpr int kStages = D >= 128 ? 2 : 3;  // D=128: two blocks an SM
  static constexpr int kLd = D + 8;                 // a row in shared memory, padded
  static constexpr int kVGroup = D / 16 < 4 ? D / 16 : 4;  // V fragments held at once
  static constexpr int kSmemBytes =
      (kBQ + 2 * kStages * kBK) * kLd * static_cast<int>(sizeof(bf16));
};

template <int D>
__global__ void __launch_bounds__(kThreads)
flash_fwd_mma_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                     const bf16* __restrict__ v, bf16* __restrict__ o, int S, int T_len,
                     int Hq, int Hkv, Strides qs, Strides ks, Strides vs, Strides os,
                     float scale_log2, int causal, int window, int q_offset) {
  using namespace mma_bf16;
  constexpr int kStages = FlashTiles<D>::kStages;
  constexpr int kLd = FlashTiles<D>::kLd;
  constexpr int kVGroup = FlashTiles<D>::kVGroup;
  constexpr int kRowBytes = kLd * static_cast<int>(sizeof(bf16));
  constexpr int kTileBytes = kBK * kRowBytes;
  constexpr int kPieces = D / 8;                 // 16-byte pieces a row
  constexpr int kRowStep = kThreads / kPieces;   // rows one pass of copies covers
  extern __shared__ __align__(16) unsigned char smem_raw[];
  // Q [kBQ][kLd], then K and V [kStages][kBK][kLd] each
  const uint32_t q_smem = smem_addr(smem_raw);
  const uint32_t k_smem = q_smem + kBQ * kRowBytes;
  const uint32_t v_smem = k_smem + kStages * kTileBytes;

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int q0 = (gridDim.x - 1 - blockIdx.x) * kBQ;  // heaviest tiles first
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int kvh = h / (Hq / Hkv);
  const int rows_here = min(kBQ, S - q0);

  // this thread copies piece `piece` of rows `row` + kRowStep j
  const int row = tid / kPieces, piece = (tid % kPieces) * 8;
  const uint32_t dst = (row * kLd + piece) * static_cast<int>(sizeof(bf16));
  const bf16* qb = q + b * qs.b + h * qs.h + piece;
  const bf16* kb = k + b * ks.b + kvh * ks.h + piece;
  const bf16* vb = v + b * vs.b + kvh * vs.h + piece;

  // the query tile, rows past S zero-filled: group 0 with the first tile
#pragma unroll
  for (int j = 0; j < kBQ / kRowStep; ++j) {
    const int r = row + j * kRowStep;
    const bool in = r < rows_here;
    cp_async16(q_smem + dst + j * kRowStep * kRowBytes, qb + (in ? q0 + r : q0) * qs.s, in);
  }

  // the key range any row of this tile attends: tiles outside it are
  // skipped as the TPU kernel's run condition skips them
  const int q_first = q0 + q_offset;
  const int q_last = q0 + rows_here - 1 + q_offset;
  int k_begin = 0;
  if (window > 0) k_begin = max(0, q_first - window + 1) / kBK * kBK;
  const int k_end = causal ? min(T_len, q_last + 1) : T_len;
  const int n_tiles = k_end > k_begin ? (k_end - k_begin + kBK - 1) / kBK : 0;

  // keys past T are zero-filled (their scores are set to -inf below)
  auto load_tile = [&](int tile) {
    const uint32_t stage = (tile % kStages) * kTileBytes + dst;
#pragma unroll
    for (int j = 0; j < kBK / kRowStep; ++j) {
      const int t = k_begin + tile * kBK + row + j * kRowStep;
      const bool in = t < T_len;
      const long long tr = in ? t : 0;
      cp_async16(k_smem + stage + j * kRowStep * kRowBytes, kb + tr * ks.s, in);
      cp_async16(v_smem + stage + j * kRowStep * kRowBytes, vb + tr * vs.s, in);
    }
  };
#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) {
    if (s < n_tiles) load_tile(s);
    cp_async_commit();  // one group a stage, empty or not, to keep the count
  }

  // ldmatrix row addresses of this lane: Q's A fragments (rows of the
  // warp's 16), K's B fragments (two 8-key n-tiles at once) and V's,
  // transposed (two 8-column n-tiles at once)
  const uint32_t q_frag = q_smem + (warp * 16 + lane % 16) * kRowBytes + (lane / 16) * 16;
  const uint32_t k_frag = (lane % 8 + (lane / 16) * 8) * kRowBytes + ((lane / 8) % 2) * 16;
  const uint32_t v_frag = (lane % 8 + ((lane / 8) % 2) * 8) * kRowBytes + (lane / 16) * 16;

  // this lane's rows of the warp's 16: r0 and r0 + 8
  const int r0 = warp * 16 + lane / 4;
  uint32_t qf[D / 16][4];
  float acc[D / 8][4];
#pragma unroll
  for (int n = 0; n < D / 8; ++n) acc[n][0] = acc[n][1] = acc[n][2] = acc[n][3] = 0.0f;
  float m[2] = {kNegInf, kNegInf}, l[2] = {0.0f, 0.0f};

  for (int i = 0; i < n_tiles; ++i) {
    cp_async_wait<kStages - 2>();  // tile i (and with it Q) has landed
    __syncthreads();               // ... for every thread; tile i - 1 is done
    if (i + kStages - 1 < n_tiles) load_tile(i + kStages - 1);
    cp_async_commit();
    if (i == 0) {
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk) ldmatrix_x4(qf[kk], q_frag + kk * 32);
    }
    const uint32_t kt = k_smem + (i % kStages) * kTileBytes + k_frag;
    const uint32_t vt = v_smem + (i % kStages) * kTileBytes + v_frag;

    // S = Q K^T: 8 n-tiles of 8 keys
    float s[kBK / 8][4];
#pragma unroll
    for (int j = 0; j < kBK / 8; ++j) s[j][0] = s[j][1] = s[j][2] = s[j][3] = 0.0f;
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
#pragma unroll
      for (int np = 0; np < kBK / 16; ++np) {
        uint32_t kf[4];
        ldmatrix_x4(kf, kt + np * 16 * kRowBytes + kk * 32);
        mma(s[2 * np], qf[kk], kf[0], kf[1]);
        mma(s[2 * np + 1], qf[kk], kf[2], kf[3]);
      }
    }

    const int k0 = k_begin + i * kBK;
    softmax_step(s, acc, m, l, k0, q_first + r0, lane, T_len, causal, window, q_first, q_last,
                 scale_log2);

    // O += P V: P's accumulator fragments are the A operand as they lie;
    // the hi products of kVGroup V fragments go before their lo products,
    // so that a lo product does not wait on the hi one just issued into
    // the same accumulator
#pragma unroll
    for (int kk = 0; kk < kBK / 16; ++kk) {
      uint32_t ph[4], pl[4];
      split_bf16(s[2 * kk][0], s[2 * kk][1], ph[0], pl[0]);
      split_bf16(s[2 * kk][2], s[2 * kk][3], ph[1], pl[1]);
      split_bf16(s[2 * kk + 1][0], s[2 * kk + 1][1], ph[2], pl[2]);
      split_bf16(s[2 * kk + 1][2], s[2 * kk + 1][3], ph[3], pl[3]);
#pragma unroll
      for (int d0 = 0; d0 < D / 16; d0 += kVGroup) {
        uint32_t vf[kVGroup][4];
#pragma unroll
        for (int g = 0; g < kVGroup; ++g) {
          ldmatrix_x4_trans(vf[g], vt + kk * 16 * kRowBytes + (d0 + g) * 32);
          mma(acc[2 * (d0 + g)], ph, vf[g][0], vf[g][1]);
          mma(acc[2 * (d0 + g) + 1], ph, vf[g][2], vf[g][3]);
        }
#pragma unroll
        for (int g = 0; g < kVGroup; ++g) {
          mma(acc[2 * (d0 + g)], pl, vf[g][0], vf[g][1]);
          mma(acc[2 * (d0 + g) + 1], pl, vf[g][2], vf[g][3]);
        }
      }
    }
  }
  cp_async_wait<0>();  // nothing in flight when the block ends

  store_rows(acc, m, l, o + b * os.b + h * os.h + (q0 + r0) * os.s, os.s, rows_here - r0, lane);
}

// ---- bf16, D = 64: wgmma (Hopper's warpgroup products) -----------------
//
// The same algorithm with the four warps issuing S = Q K^T and P V as
// warpgroup products (m64n64k16) on K and V tiles that the tensor cores
// read from shared memory themselves (128-byte-swizzled, a K row of 64
// bf16 being one 128-byte row), so no ldmatrix feeds B and each product
// instruction covers the block's 64 rows. Q and P stay in registers as A.

constexpr int kWgStages = 3;
constexpr int kWgTileBytes = kBK * 128;  // 64 rows of 64 bf16
constexpr int kWgQLd = 64 + 8;           // Q rows padded for ldmatrix
constexpr int kWgSmemBytes =
    1024 + 2 * kWgStages * kWgTileBytes + kBQ * kWgQLd * static_cast<int>(sizeof(bf16));

__global__ void __launch_bounds__(kThreads)
flash_fwd_wgmma_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                       const bf16* __restrict__ v, bf16* __restrict__ o, int S, int T_len,
                       int Hq, int Hkv, Strides qs, Strides ks, Strides vs, Strides os,
                       float scale_log2, int causal, int window, int q_offset) {
  using namespace mma_bf16;
  constexpr int D = 64;
  constexpr int kRowBytes = kWgQLd * static_cast<int>(sizeof(bf16));
  extern __shared__ __align__(16) unsigned char smem_raw[];
  // K then V [kWgStages][64 rows][128 bytes], swizzled, from a 1024-byte
  // boundary; then Q [kBQ][kWgQLd]
  const uint32_t k_smem = (smem_addr(smem_raw) + 1023u) & ~1023u;
  const uint32_t v_smem = k_smem + kWgStages * kWgTileBytes;
  const uint32_t q_smem = v_smem + kWgStages * kWgTileBytes;

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int q0 = (gridDim.x - 1 - blockIdx.x) * kBQ;  // heaviest tiles first
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int kvh = h / (Hq / Hkv);
  const int rows_here = min(kBQ, S - q0);

  // this thread copies chunk `piece` of rows `row` + 16 j
  const int row = tid / 8, piece = tid % 8;
  const uint32_t q_dst = (row * kWgQLd + piece * 8) * static_cast<int>(sizeof(bf16));
  const uint32_t kv_dst = wgmma::swizzle128(row, piece);  // row + 16 j keeps row % 8
  const bf16* qb = q + b * qs.b + h * qs.h + piece * 8;
  const bf16* kb = k + b * ks.b + kvh * ks.h + piece * 8;
  const bf16* vb = v + b * vs.b + kvh * vs.h + piece * 8;

#pragma unroll
  for (int j = 0; j < kBQ / 16; ++j) {
    const int r = row + 16 * j;
    const bool in = r < rows_here;
    cp_async16(q_smem + q_dst + 16 * j * kRowBytes, qb + (in ? q0 + r : q0) * qs.s, in);
  }

  const int q_first = q0 + q_offset;
  const int q_last = q0 + rows_here - 1 + q_offset;
  int k_begin = 0;
  if (window > 0) k_begin = max(0, q_first - window + 1) / kBK * kBK;
  const int k_end = causal ? min(T_len, q_last + 1) : T_len;
  const int n_tiles = k_end > k_begin ? (k_end - k_begin + kBK - 1) / kBK : 0;

  auto load_tile = [&](int tile) {
    const uint32_t stage = (tile % kWgStages) * kWgTileBytes + kv_dst;
#pragma unroll
    for (int j = 0; j < kBK / 16; ++j) {
      const int t = k_begin + tile * kBK + row + 16 * j;
      const bool in = t < T_len;
      const long long tr = in ? t : 0;
      cp_async16(k_smem + stage + 16 * j * 128, kb + tr * ks.s, in);
      cp_async16(v_smem + stage + 16 * j * 128, vb + tr * vs.s, in);
    }
  };
#pragma unroll
  for (int st = 0; st < kWgStages - 1; ++st) {
    if (st < n_tiles) load_tile(st);
    cp_async_commit();
  }

  const uint32_t q_frag = q_smem + (warp * 16 + lane % 16) * kRowBytes + (lane / 16) * 16;
  const int r0 = warp * 16 + lane / 4;
  float acc[D / 8][4];
#pragma unroll
  for (int n = 0; n < D / 8; ++n) acc[n][0] = acc[n][1] = acc[n][2] = acc[n][3] = 0.0f;
  float m[2] = {kNegInf, kNegInf}, l[2] = {0.0f, 0.0f};

  for (int i = 0; i < n_tiles; ++i) {
    cp_async_wait<kWgStages - 2>();
    wgmma::fence_smem();  // the tile's bytes, written by cp.async, for wgmma's reads
    __syncthreads();
    if (i + kWgStages - 1 < n_tiles) load_tile(i + kWgStages - 1);
    cp_async_commit();
    // Q's fragments are loaded anew for every tile: held across the
    // loop, their registers were reused by the compiler while the
    // warpgroup products still needed them (wrong scores from the
    // second tile on)
    uint32_t qf[D / 16][4];
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) ldmatrix_x4(qf[kk], q_frag + kk * 32);
    const uint32_t kt = k_smem + (i % kWgStages) * kWgTileBytes;
    const uint32_t vt = v_smem + (i % kWgStages) * kWgTileBytes;

    // S = Q K^T: K is n-rows-major (d contiguous); a k-step of 16 d is
    // 32 bytes along the swizzled row
    float s[kBK / 8][4];
    wgmma::fence();
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk)
      wgmma::m64n64k16<0>(s, qf[kk], wgmma::desc128(kt + kk * 32), kk > 0);
    wgmma::commit();
    wgmma::wait<0>();
    wgmma::pin(s);

    const int k0 = k_begin + i * kBK;
    softmax_step(s, acc, m, l, k0, q_first + r0, lane, T_len, causal, window, q_first, q_last,
                 scale_log2);

    // O += P V, P as hi + lo: V is k-rows-major (d contiguous); a k-step
    // of 16 keys is 16 rows, 2048 bytes
    uint32_t ph[kBK / 16][4], pl[kBK / 16][4];
#pragma unroll
    for (int kk = 0; kk < kBK / 16; ++kk) {
      split_bf16(s[2 * kk][0], s[2 * kk][1], ph[kk][0], pl[kk][0]);
      split_bf16(s[2 * kk][2], s[2 * kk][3], ph[kk][1], pl[kk][1]);
      split_bf16(s[2 * kk + 1][0], s[2 * kk + 1][1], ph[kk][2], pl[kk][2]);
      split_bf16(s[2 * kk + 1][2], s[2 * kk + 1][3], ph[kk][3], pl[kk][3]);
    }
    wgmma::pin(acc);
    wgmma::fence();
#pragma unroll
    for (int kk = 0; kk < kBK / 16; ++kk) {
      wgmma::m64n64k16<1>(acc, ph[kk], wgmma::desc128(vt + kk * 2048), 1);
      wgmma::m64n64k16<1>(acc, pl[kk], wgmma::desc128(vt + kk * 2048), 1);
    }
    wgmma::commit();
    wgmma::wait<0>();
    wgmma::pin(acc);
  }
  cp_async_wait<0>();

  store_rows(acc, m, l, o + b * os.b + h * os.h + (q0 + r0) * os.s, os.s, rows_here - r0, lane);
}

int launch_wgmma(const void* q, const void* k, const void* v, void* o, int B, int S, int T_len,
                 int Hq, int Hkv, const long long* st, float scale, int causal, int window,
                 int q_offset, cudaStream_t stream) {
  static bool configured = false;  // above 48 KB only by opting in, once
  if (!configured) {
    const cudaError_t err = cudaFuncSetAttribute(
        flash_fwd_wgmma_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kWgSmemBytes);
    if (err != cudaSuccess) return static_cast<int>(err);
    configured = true;
  }
  const Strides qs{st[0], st[1], st[2]}, ks{st[3], st[4], st[5]}, vs{st[6], st[7], st[8]},
      os{st[9], st[10], st[11]};
  const dim3 grid((S + kBQ - 1) / kBQ, Hq, B);
  flash_fwd_wgmma_kernel<<<grid, kThreads, kWgSmemBytes, stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k), static_cast<const bf16*>(v),
      static_cast<bf16*>(o), S, T_len, Hq, Hkv, qs, ks, vs, os, scale * kLog2e, causal, window,
      q_offset);
  return static_cast<int>(cudaGetLastError());
}

template <int D>
int launch_mma(const void* q, const void* k, const void* v, void* o, int B, int S, int T_len,
               int Hq, int Hkv, const long long* st, float scale, int causal, int window,
               int q_offset, cudaStream_t stream) {
  constexpr int smem = FlashTiles<D>::kSmemBytes;
  static bool configured = false;  // above 48 KB only by opting in, once
  if (!configured) {
    const cudaError_t err = cudaFuncSetAttribute(
        flash_fwd_mma_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return static_cast<int>(err);
    configured = true;
  }
  const Strides qs{st[0], st[1], st[2]}, ks{st[3], st[4], st[5]}, vs{st[6], st[7], st[8]},
      os{st[9], st[10], st[11]};
  const dim3 grid((S + kBQ - 1) / kBQ, Hq, B);
  flash_fwd_mma_kernel<D><<<grid, kThreads, smem, stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k), static_cast<const bf16*>(v),
      static_cast<bf16*>(o), S, T_len, Hq, Hkv, qs, ks, vs, os, scale * kLog2e, causal, window,
      q_offset);
  return static_cast<int>(cudaGetLastError());
}

int dispatch_f32(int D, const void* q, const void* k, const void* v, void* o, int B, int S,
                 int T_len, int Hq, int Hkv, const long long* st, float scale, int causal,
                 int window, int q_offset, cudaStream_t stream) {
  switch (D) {
    case 32:
      return launch<float, 32>(q, k, v, o, B, S, T_len, Hq, Hkv, st, scale, causal, window,
                               q_offset, stream);
    case 64:
      return launch<float, 64>(q, k, v, o, B, S, T_len, Hq, Hkv, st, scale, causal, window,
                               q_offset, stream);
    case 128:
      return launch<float, 128>(q, k, v, o, B, S, T_len, Hq, Hkv, st, scale, causal, window,
                                q_offset, stream);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

int dispatch_bf16(int D, const void* q, const void* k, const void* v, void* o, int B, int S,
                  int T_len, int Hq, int Hkv, const long long* st, float scale, int causal,
                  int window, int q_offset, cudaStream_t stream) {
  switch (D) {
    case 32:
      return launch_mma<32>(q, k, v, o, B, S, T_len, Hq, Hkv, st, scale, causal, window,
                            q_offset, stream);
    case 64:
      return launch_wgmma(q, k, v, o, B, S, T_len, Hq, Hkv, st, scale, causal, window,
                          q_offset, stream);
    case 128:
      return launch_mma<128>(q, k, v, o, B, S, T_len, Hq, Hkv, st, scale, causal, window,
                             q_offset, stream);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

bool valid_shape(int B, int S, int T_len, int Hq, int Hkv) {
  return B > 0 && S > 0 && T_len > 0 && Hkv > 0 && Hq % Hkv == 0 && Hq <= 65535 &&
         B <= 65535;
}

}  // namespace

// Plain C entry points for ctypes: device pointers, 12 element strides
// (b, seq, head of q, k, v, o), window <= 0 for none, the CUDA stream as
// a pointer; the return value is cudaGetLastError() after the launch.
// The bf16 route reads rows with 16-byte copies: q, k, v and o start on
// 16-byte boundaries and their strides are multiples of 8 elements.
extern "C" int flash_attention_f32(const void* q, const void* k, const void* v, void* o,
                                   int B, int S, int T_len, int Hq, int Hkv, int D,
                                   const long long* strides, float scale, int causal,
                                   int window, int q_offset, void* stream) {
  if (!valid_shape(B, S, T_len, Hq, Hkv)) return static_cast<int>(cudaErrorInvalidValue);
  return dispatch_f32(D, q, k, v, o, B, S, T_len, Hq, Hkv, strides, scale, causal, window,
                      q_offset, static_cast<cudaStream_t>(stream));
}

extern "C" int flash_attention_bf16(const void* q, const void* k, const void* v, void* o,
                                    int B, int S, int T_len, int Hq, int Hkv, int D,
                                    const long long* strides, float scale, int causal,
                                    int window, int q_offset, void* stream) {
  if (!valid_shape(B, S, T_len, Hq, Hkv)) return static_cast<int>(cudaErrorInvalidValue);
  return dispatch_bf16(D, q, k, v, o, B, S, T_len, Hq, Hkv, strides, scale, causal, window,
                       q_offset, static_cast<cudaStream_t>(stream));
}

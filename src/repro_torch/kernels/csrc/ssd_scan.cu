// Mamba2 SSD chunked scan (state-space duality), the prefill of the ssm
// family:
//
//     h_t = exp(dt_t A_h) h_{t-1} + dt_t x_t B_t^T      h in R^{P x N}, h_0 = 0
//     y_t = h_t C_t + D_h x_t
//     x [Bt, S, H, P], dt [Bt, S, H], B, C [Bt, S, G, N], A, D [H]
//     -> y [Bt, S, H, P] in x's dtype, the final state [Bt, H, P, N] in f32
//
// head h reads state group h / (H / G).
//
// Replaces the Pallas TPU kernel
// src/repro/kernels/ssd_scan/kernel.py:ssd_scan_pallas (_ssd_kernel), and
// computes what it computes, chunk by chunk of Q rows: with
// cum = the inclusive prefix sum of dt A inside the chunk and h0 the state
// at its start,
//
//     y  = ((C B^T) o L) x + exp(cum) o (C h0^T) + D x,
//          L_ij = exp(cum_i - cum_j) dt_j for i >= j, else 0
//     h <- exp(cum_last) h0 + sum_j exp(cum_last - cum_j) dt_j x_j B_j^T
//
// Bound on Hopper: at the serve path's prefill (Bt=8, S=512, H=80, P=64,
// G=1, N=128, Q=256, bf16) the function moves about 108 MB (x and y, B, C,
// dt, the state), 32 us at 3.35 TB/s, against the four products with the
// intra-chunk pair counted only where the causal decay keeps it (i >= j),
// Q (Q + 1) (N + P) + 4 Q P N = 21.0 MFLOP per (b, h, chunk), 27 GFLOP in
// all, 27 us at the tensor cores' 989 TFLOP/s: bytes bound it there (0.0323
// ms), and operations, barely, at Bt=1, S=8192 (0.0544 ms against 0.053 ms
// of bytes).
//
// Measured (chip_smoke.py, CUDA-graph replay, one NVIDIA H100 80GB HBM3 at
// a 700 W power limit): the bf16 kernel below takes 0.295 ms at the serve
// shape (9.1x its bound; the scalar kernel it replaced took 1.957) and
// 1.129 ms at Bt=1, S=8192 (21x; from 6.283). What holds it now: four
// warps a block and two blocks an SM leave the tensor cores waiting on
// each warp's chain of ldmatrix, mma.sync, the decay's exp and the hi/lo
// split, about a third of the products are the lo halves, and at Bt=1
// the 80 blocks leave 52 SMs idle while each walks 32 chunks in turn.
//
// Two routes, chosen by dtype, not as a fallback:
//
// bf16 (the serve path): ssd_scan_mma_kernel, the products on the tensor
// cores (mma.sync m16n8k16, bf16 in, f32 accumulate). The TPU kernel
// carries h in VMEM across a sequential grid axis over chunks; blocks on
// Hopper run in no order, so one block of 4 warps walks a (b, h)'s chunks
// itself. Rows p of the state and columns p of y are independent, so a
// head's P columns could be split over two blocks, each recomputing the
// chunk's C B^T, for 160 blocks at Bt=1 instead of 80 on 132 SMs; built
// that way and timed on an H100, the split was slower at both the serve
// shape and Bt=1, S=8192 (the recomputed C B^T costs more than the idle
// SMs), so one block owns a head's P columns. A chunk is cut into 64-row
// sub-tiles, as the TPU kernel's [Q, Q] tile would not fit (256 KB at
// Q=256): for each query sub-tile I the block walks key sub-tiles J <= I,
// warp w owning query rows 16w..16w+15. The tiles of C_I, B_J and x_J stay bf16 in
// shared memory, rows padded by 16 bytes so that each 8-row ldmatrix phase
// hits 32 distinct banks, filled by 16-byte cp.async: B_J and x_J in a
// 2-stage ring (step (I, J + 1)'s tiles load while step (I, J) computes),
// C_I in one buffer that C_{I+1} refills once the diagonal step (I, I) has
// read it, so that two blocks fit an SM, or, where the grid leaves each
// block an SM of its own, in two, C_{I+1} loading a step ahead
// (c_buffers below). The four products of a step:
//   S = C_I B_J^T           exact: bf16 x bf16 products summed in f32; the
//                           decay L_ij = exp(cum_i - cum_j) dt_j is applied
//                           on the accumulator fragments, only where i >= j
//                           (masked before exp); above-diagonal key tiles
//                           of the diagonal sub-tile are skipped;
//   y_I += (S o L) x_J      S o L converted in registers into the A operand;
//   y_I = exp(cum) C_I h0^T at J = 0: h0's bf16 copy made once a chunk;
//   h += (w o x_J)^T B_J    at J = I, w_j = exp(cum_last - cum_j) dt_j;
//                           the state, f32, stays in the accumulator
//                           registers across chunks (h <- exp(cum_last) h
//                           at the chunk's start, then the products).
// Every f32 operand rounded to bf16 carries 2^-9 relative error, which
// breaks the checks (y at rtol = atol = 1e-2, the state at 1e-3 against
// the sequential recurrence): S o L, h0 and w o x are each carried as bf16
// hi + lo, two products (tests/test_torch_ssd_scan.py emulates the
// arithmetic on the CPU: dropping the lo part of any one of the three
// fails it). cum and dt stay f32 in shared memory; exp is the SFU's exp2.
//
// f32: ssd_scan_kernel, the scalar route: TF32 products would not hold the
// f32 check (rtol = atol = 1e-3), so the products stay fp32 FMAs fed from
// f32 shared memory, one block of 256 threads a (b, h) with h (P x N f32)
// in shared memory. Thread (ty, tx) = (tid / 16, tid % 16) owns rows
// ty + 16 a of a 64-row sub-tile and, for the scores, keys tx + 16 k; for
// y, columns tx + 16 j; for the state, rows p = ty + 16 a and columns
// n = tx + 16 j, whose chunk input sum_j w_j x_j B_j^T it keeps in
// registers until every sub-tile has read h0. Rows of shared-memory tiles
// that a loop walks across threads are padded by one float.
//
// Both routes: the decay is masked before exp (exp is taken only for
// i >= j, where cum_i - cum_j <= 0), so the above-diagonal exp(+big) never
// appears. Unlike the TPU kernel, S need not be a multiple of Q: the last
// chunk is ragged, its rows past S are loaded as zeros, add nothing and
// are not written, and cum_last is the cum of row S - 1, so the state out
// is the state after row S - 1. x, B, C, dt and y are read and written in
// place through their strides (the TPU wrapper transposes all four to
// heads-major first), so the model's x, B and C, slices of one conv
// output, need no copy (the bf16 route needs their rows on 16-byte
// boundaries; ops.py refuses others). Everything is accumulated in fp32.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "mma_bf16.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kTile = 64;        // rows of a query or key sub-tile
constexpr int kMaxChunk = 1024;  // cum and dt of a chunk live in shared memory

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

struct Strides {  // element strides of [Bt, S, heads or groups, ...]
  long long b, s, h;
};

template <int P, int N>
constexpr int smem_floats_fixed() {
  // h [P][N+1], C and B tiles [kTile][N+1], x tile [kTile][P],
  // masked scores [kTile][kTile+1]
  return P * (N + 1) + 2 * kTile * (N + 1) + kTile * P + kTile * (kTile + 1);
}

template <typename T, int P, int N>
__global__ void __launch_bounds__(kThreads)
ssd_scan_kernel(const T* __restrict__ x, const float* __restrict__ dt,
                const float* __restrict__ A, const T* __restrict__ Bm,
                const T* __restrict__ Cm, const float* __restrict__ Dv, T* __restrict__ y,
                float* __restrict__ state_out, int S, int H, int G, int chunk, Strides xs,
                Strides dts, Strides bs, Strides cs, Strides ys) {
  constexpr int kPC = P / 16;  // y columns (and state rows) a thread owns
  constexpr int kNC = N / 16;  // state columns a thread owns
  extern __shared__ float smem[];
  float* hs = smem;                     // [P][N + 1]
  float* Cs = hs + P * (N + 1);         // [kTile][N + 1]
  float* Bs = Cs + kTile * (N + 1);     // [kTile][N + 1]
  float* Xs = Bs + kTile * (N + 1);     // [kTile][P]
  float* Ss = Xs + kTile * P;           // [kTile][kTile + 1]
  float* cum = Ss + kTile * (kTile + 1);  // [chunk]
  float* dtc = cum + chunk;             // [chunk]

  const int tid = threadIdx.x;
  const int ty = tid / 16, tx = tid % 16;
  const int h = blockIdx.x;
  const int b = blockIdx.y;
  const int g = h / (H / G);
  const float a = A[h];
  const float d = Dv[h];

  const T* xb = x + b * xs.b + h * xs.h;
  const float* dtb = dt + b * dts.b + h * dts.h;
  const T* bb = Bm + b * bs.b + g * bs.h;
  const T* cb = Cm + b * cs.b + g * cs.h;
  T* yb = y + b * ys.b + h * ys.h;

  for (int i = tid; i < P * (N + 1); i += kThreads) hs[i] = 0.0f;

  for (int c0 = 0; c0 < S; c0 += chunk) {
    const int q_len = min(chunk, S - c0);
    __syncthreads();  // the previous chunk's state update and cum reads are done

    // dt and the inclusive prefix sum of dt A over the chunk: warp 0 scans
    // 32 rows at a time with shuffles and carries the running sum
    if (tid < 32) {
      float carry = 0.0f;
      for (int r0 = 0; r0 < q_len; r0 += 32) {
        const int r = r0 + tid;
        const float dtv = r < q_len ? dtb[(long long)(c0 + r) * dts.s] : 0.0f;
        float v = dtv * a;
#pragma unroll
        for (int off = 1; off < 32; off <<= 1) {
          const float up = __shfl_up_sync(0xffffffffu, v, off);
          if (tid >= off) v += up;
        }
        v += carry;
        if (r < q_len) {
          cum[r] = v;
          dtc[r] = dtv;
        }
        carry = __shfl_sync(0xffffffffu, v, 31);
      }
    }
    __syncthreads();
    const float cum_last = cum[q_len - 1];

    float hacc[kPC][kNC];  // sum_j exp(cum_last - cum_j) dt_j x_j B_j^T
#pragma unroll
    for (int i = 0; i < kPC; ++i)
#pragma unroll
      for (int j = 0; j < kNC; ++j) hacc[i][j] = 0.0f;

    const int n_tiles = (q_len + kTile - 1) / kTile;
    for (int I = 0; I < n_tiles; ++I) {
      const int i0 = I * kTile;
      __syncthreads();  // the previous sub-tile is done with Cs
      for (int idx = tid; idx < kTile * N; idx += kThreads) {
        const int r = idx / N, n = idx % N;
        const int row = i0 + r;
        Cs[r * (N + 1) + n] =
            row < q_len ? to_f32(cb[(long long)(c0 + row) * cs.s + n]) : 0.0f;
      }
      __syncthreads();

      // the carried state's share: exp(cum_i) (C h0^T)[i, p]
      float acc[4][kPC];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < kPC; ++j) acc[i][j] = 0.0f;
#pragma unroll 4
      for (int n = 0; n < N; ++n) {
        float cv[4], hv[kPC];
#pragma unroll
        for (int i = 0; i < 4; ++i) cv[i] = Cs[(ty + 16 * i) * (N + 1) + n];
#pragma unroll
        for (int j = 0; j < kPC; ++j) hv[j] = hs[(tx + 16 * j) * (N + 1) + n];
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < kPC; ++j) acc[i][j] = fmaf(cv[i], hv[j], acc[i][j]);
      }
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int row = i0 + ty + 16 * i;
        const float e = row < q_len ? expf(cum[row]) : 0.0f;
#pragma unroll
        for (int j = 0; j < kPC; ++j) acc[i][j] *= e;
      }

      for (int J = 0; J <= I; ++J) {
        const int j0 = J * kTile;
        __syncthreads();  // the previous key sub-tile is done with Bs, Xs, Ss
        for (int idx = tid; idx < kTile * N; idx += kThreads) {
          const int r = idx / N, n = idx % N;
          const int row = j0 + r;
          Bs[r * (N + 1) + n] =
              row < q_len ? to_f32(bb[(long long)(c0 + row) * bs.s + n]) : 0.0f;
        }
        for (int idx = tid; idx < kTile * P; idx += kThreads) {
          const int r = idx / P, p = idx % P;
          const int row = j0 + r;
          Xs[r * P + p] = row < q_len ? to_f32(xb[(long long)(c0 + row) * xs.s + p]) : 0.0f;
        }
        __syncthreads();

        // scores (C B^T)[i, k] for rows ty + 16 i, keys tx + 16 k
        float s[4][4];
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int k = 0; k < 4; ++k) s[i][k] = 0.0f;
#pragma unroll 4
        for (int n = 0; n < N; ++n) {
          float cv[4], bv[4];
#pragma unroll
          for (int i = 0; i < 4; ++i) cv[i] = Cs[(ty + 16 * i) * (N + 1) + n];
#pragma unroll
          for (int k = 0; k < 4; ++k) bv[k] = Bs[(tx + 16 * k) * (N + 1) + n];
#pragma unroll
          for (int i = 0; i < 4; ++i)
#pragma unroll
            for (int k = 0; k < 4; ++k) s[i][k] = fmaf(cv[i], bv[k], s[i][k]);
        }
        // the decay mask, applied before any exp: only i >= j inside the
        // chunk's rows takes exp(cum_i - cum_j) dt_j, the rest is 0
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int ri = i0 + ty + 16 * i;
#pragma unroll
          for (int k = 0; k < 4; ++k) {
            const int rk = j0 + tx + 16 * k;
            const float l =
                (ri >= rk && ri < q_len) ? expf(cum[ri] - cum[rk]) * dtc[rk] : 0.0f;
            Ss[(ty + 16 * i) * (kTile + 1) + tx + 16 * k] = s[i][k] * l;
          }
        }
        __syncthreads();

#pragma unroll 4
        for (int kk = 0; kk < kTile; ++kk) {
          float sv[4], xv[kPC];
#pragma unroll
          for (int i = 0; i < 4; ++i) sv[i] = Ss[(ty + 16 * i) * (kTile + 1) + kk];
#pragma unroll
          for (int j = 0; j < kPC; ++j) xv[j] = Xs[kk * P + tx + 16 * j];
#pragma unroll
          for (int i = 0; i < 4; ++i)
#pragma unroll
            for (int j = 0; j < kPC; ++j) acc[i][j] = fmaf(sv[i], xv[j], acc[i][j]);
        }

        if (J == I) {
          // the diagonal is the last key sub-tile of this query sub-tile and
          // the only visit of key sub-tile J with I == J: add its rows'
          // share of the state update, then the skip term, and write y
          const int k_end = min(kTile, q_len - j0);
          for (int kk = 0; kk < k_end; ++kk) {
            const float w = expf(cum_last - cum[j0 + kk]) * dtc[j0 + kk];
            float xv[kPC], bv[kNC];
#pragma unroll
            for (int i = 0; i < kPC; ++i) xv[i] = Xs[kk * P + ty + 16 * i] * w;
#pragma unroll
            for (int j = 0; j < kNC; ++j) bv[j] = Bs[kk * (N + 1) + tx + 16 * j];
#pragma unroll
            for (int i = 0; i < kPC; ++i)
#pragma unroll
              for (int j = 0; j < kNC; ++j) hacc[i][j] = fmaf(xv[i], bv[j], hacc[i][j]);
          }
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            const int r = ty + 16 * i;
            const int row = i0 + r;
            if (row >= q_len) continue;
#pragma unroll
            for (int j = 0; j < kPC; ++j) {
              const int p = tx + 16 * j;
              yb[(long long)(c0 + row) * ys.s + p] = from_f32<T>(acc[i][j] + d * Xs[r * P + p]);
            }
          }
        }
      }
    }

    __syncthreads();  // every sub-tile has read h0
    const float decay = expf(cum_last);
#pragma unroll
    for (int i = 0; i < kPC; ++i)
#pragma unroll
      for (int j = 0; j < kNC; ++j) {
        float* hp = hs + (ty + 16 * i) * (N + 1) + tx + 16 * j;
        *hp = decay * *hp + hacc[i][j];
      }
  }

  __syncthreads();
  float* sb = state_out + ((long long)b * H + h) * P * N;
  for (int idx = tid; idx < P * N; idx += kThreads) sb[idx] = hs[(idx / N) * (N + 1) + idx % N];
}

template <typename T, int P, int N>
int launch(const void* x, const void* dt, const void* A, const void* B, const void* C,
           const void* D, void* y, void* state, int Bt, int S, int H, int G, int chunk,
           const long long* st, cudaStream_t stream) {
  const int smem = (smem_floats_fixed<P, N>() + 2 * chunk) * static_cast<int>(sizeof(float));
  static int configured = 0;  // above 48 KB only by opting in; raised as needed
  if (smem > configured) {
    const cudaError_t err = cudaFuncSetAttribute(
        ssd_scan_kernel<T, P, N>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return static_cast<int>(err);
    configured = smem;
  }
  const Strides xs{st[0], st[1], st[2]}, dts{st[3], st[4], st[5]}, bs{st[6], st[7], st[8]},
      cs{st[9], st[10], st[11]}, ys{st[12], st[13], st[14]};
  const dim3 grid(H, Bt);
  ssd_scan_kernel<T, P, N><<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(x), static_cast<const float*>(dt), static_cast<const float*>(A),
      static_cast<const T*>(B), static_cast<const T*>(C), static_cast<const float*>(D),
      static_cast<T*>(y), static_cast<float*>(state), S, H, G, chunk, xs, dts, bs, cs, ys);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, int P>
int dispatch_n(int N, const void* x, const void* dt, const void* A, const void* B,
               const void* C, const void* D, void* y, void* state, int Bt, int S, int H, int G,
               int chunk, const long long* st, cudaStream_t stream) {
  switch (N) {
    case 16:   // the smoke config's state
      return launch<T, P, 16>(x, dt, A, B, C, D, y, state, Bt, S, H, G, chunk, st, stream);
    case 128:  // mamba2-2.7b's
      return launch<T, P, 128>(x, dt, A, B, C, D, y, state, Bt, S, H, G, chunk, st, stream);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

template <typename T>
int dispatch(int P, int N, const void* x, const void* dt, const void* A, const void* B,
             const void* C, const void* D, void* y, void* state, int Bt, int S, int H, int G,
             int chunk, const long long* st, cudaStream_t stream) {
  switch (P) {
    case 32:
      return dispatch_n<T, 32>(N, x, dt, A, B, C, D, y, state, Bt, S, H, G, chunk, st, stream);
    case 64:
      return dispatch_n<T, 64>(N, x, dt, A, B, C, D, y, state, Bt, S, H, G, chunk, st, stream);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

// ---- bf16: the products on the tensor cores -----------------------------

using bf16 = __nv_bfloat16;
constexpr int kMmaThreads = 128;  // 4 warps, 16 query rows each of a sub-tile
constexpr float kLog2e = 1.4426950408889634f;

template <int P, int N, int kCBufs>
struct MmaTiles {
  static constexpr int kLdN = N + 8;         // a row of C, B and h0, padded (bf16)
  static constexpr int kLdP = P + 8;        // a row of x, padded
  static constexpr int kRowN = kLdN * 2;     // ... in bytes
  static constexpr int kRowP = kLdP * 2;
  // C [kCBufs][64][kLdN], B [2][64][kLdN], x [2][64][kLdP], h0 hi and lo
  // [P][kLdN] (bf16); then cum, dt and w, f32, a chunk rounded up to
  // whole sub-tiles each: with one C buffer 106 KB at P=64, N=128, chunk
  // 256, two blocks an SM
  static constexpr int kCBytes = kTile * kRowN;
  static constexpr int kFixedBytes =
      kCBufs * kCBytes + 2 * kTile * kRowN + 2 * kTile * kRowP + 2 * P * kRowN;
  static int smem_bytes(int chunk) {
    return kFixedBytes + 3 * ((chunk + kTile - 1) / kTile * kTile) * 4;
  }
};

// x's bf16 pair (keys c, c + 1 in the low and high halves) times w, as
// bf16 hi + lo pairs
__device__ __forceinline__ void scale_split(uint32_t pair, float w_lo, float w_hi,
                                            uint32_t& hi, uint32_t& lo) {
  mma_bf16::split_bf16(__uint_as_float(pair << 16) * w_lo,
                       __uint_as_float(pair & 0xffff0000u) * w_hi, hi, lo);
}

template <int P, int N, int kCBufs>
__global__ void __launch_bounds__(kMmaThreads)
ssd_scan_mma_kernel(const bf16* __restrict__ x, const float* __restrict__ dt,
                    const float* __restrict__ A, const bf16* __restrict__ Bm,
                    const bf16* __restrict__ Cm, const float* __restrict__ Dv,
                    bf16* __restrict__ y, float* __restrict__ state_out, int S, int H, int G,
                    int chunk, Strides xs, Strides dts, Strides bs, Strides cs, Strides ys) {
  using namespace mma_bf16;
  using Tiles = MmaTiles<P, N, kCBufs>;
  constexpr int kLdN = Tiles::kLdN, kLdP = Tiles::kLdP;
  constexpr int kRowN = Tiles::kRowN, kRowP = Tiles::kRowP;
  constexpr int kKN = N / 16;              // k-steps over the state width
  constexpr int kPT = P / 8;               // n-tiles of y's columns
  constexpr int kMT = P / 16;              // m-tiles of the state's rows
  constexpr int kSN = (N / 8) * kMT / 4;   // state n-tiles a warp owns
  constexpr int kPiecesN = N / 8;          // 16-byte pieces of a C or B row
  constexpr int kPiecesP = P / 8;          // ... of an x row
  static_assert(kMT == 2 || kMT == 4, "P is 32 or 64");
  static_assert(kSN == 1 || kSN % 2 == 0, "state n-tiles go in pairs");

  extern __shared__ __align__(16) unsigned char smem_raw[];
  const uint32_t c_smem = smem_addr(smem_raw);
  constexpr int c_bytes = kCBufs * Tiles::kCBytes;
  const uint32_t b_smem = c_smem + c_bytes;
  const uint32_t x_smem = b_smem + 2 * kTile * kRowN;
  const uint32_t hh_smem = x_smem + 2 * kTile * kRowP;
  const uint32_t hl_smem = hh_smem + P * kRowN;
  unsigned char* const x_raw = smem_raw + c_bytes + 2 * kTile * kRowN;
  const bf16* const x_tiles = reinterpret_cast<const bf16*>(x_raw);
  bf16* const hh = reinterpret_cast<bf16*>(x_raw + 2 * kTile * kRowP);
  bf16* const hl = hh + P * kLdN;
  const int chunk_pad = (chunk + kTile - 1) / kTile * kTile;
  float* const cum = reinterpret_cast<float*>(smem_raw + Tiles::kFixedBytes);
  float* const dtc = cum + chunk_pad;
  float* const wk = dtc + chunk_pad;

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int h = blockIdx.x;
  const int b = blockIdx.y;
  const int grp = h / (H / G);
  const float a = A[h];
  const float d = Dv[h];

  const bf16* xb = x + b * xs.b + h * xs.h;
  const float* dtb = dt + b * dts.b + h * dts.h;
  const bf16* bb = Bm + b * bs.b + grp * bs.h;
  const bf16* cb = Cm + b * cs.b + grp * cs.h;
  bf16* yb = y + b * ys.b + h * ys.h;

  // ldmatrix row addresses of this lane, in bytes within a tile: C's A
  // fragments (the warp's 16 rows); B and h0 as a B operand stored
  // n-rows-major (two 8-row n-tiles at once); x and B as a B operand
  // stored k-rows-major, transposed (two n-tiles at once); x^T as an A
  // operand, transposed (16 state rows p by 16 keys)
  const uint32_t a_frag = (warp * 16 + lane % 16) * kRowN + (lane / 16) * 16;
  const uint32_t nk_frag = (lane % 8 + (lane / 16) * 8) * kRowN + ((lane / 8) % 2) * 16;
  const uint32_t kn_frag_p = (lane % 8 + ((lane / 8) % 2) * 8) * kRowP + (lane / 16) * 16;
  const uint32_t kn_frag_n = (lane % 8 + ((lane / 8) % 2) * 8) * kRowN + (lane / 16) * 16;
  const uint32_t xt_frag = (lane % 8 + (lane / 16) * 8) * kRowP + ((lane / 8) % 2) * 16;
  const int g8 = lane / 4, c2 = 2 * (lane % 4);
  const int sm = warp % kMT;           // the warp's m-tile of state rows
  const int sn0 = (warp / kMT) * kSN;  // its first state n-tile

  // the state rows sm * 16 + g8 (+ 8), columns (sn0 + j) * 8 + c2 (+ 1),
  // carried across chunks in the product's accumulator layout
  float hst[kSN][4];
#pragma unroll
  for (int j = 0; j < kSN; ++j) hst[j][0] = hst[j][1] = hst[j][2] = hst[j][3] = 0.0f;

  for (int c0 = 0; c0 < S; c0 += chunk) {
    const int q_len = min(chunk, S - c0);
    const int n_sub = (q_len + kTile - 1) / kTile;
    // rows past the chunk are zero-filled
    auto load_rows = [&](uint32_t dst, int ld_bytes, const bf16* src, long long s_stride,
                         int r0, int pieces, int rows_pieces) {
      for (int idx = tid; idx < rows_pieces; idx += kMmaThreads) {
        const int r = idx / pieces, piece = idx % pieces;
        const int row = r0 + r;
        const bool in = row < q_len;
        cp_async16(dst + r * ld_bytes + piece * 16,
                   src + static_cast<long long>(c0 + (in ? row : 0)) * s_stride + piece * 8, in);
      }
    };
    auto load_c = [&](int I) {
      load_rows(c_smem + (I % kCBufs) * Tiles::kCBytes, kRowN, cb, cs.s, I * kTile, kPiecesN,
                kTile * kPiecesN);
    };
    auto load_bx = [&](int J, int stage) {
      load_rows(b_smem + stage * kTile * kRowN, kRowN, bb, bs.s, J * kTile, kPiecesN,
                kTile * kPiecesN);
      load_rows(x_smem + stage * kTile * kRowP, kRowP, xb, xs.s, J * kTile, kPiecesP,
                kTile * kPiecesP);
    };

    __syncthreads();  // the previous chunk is done with the tiles, h0 and cum
    load_c(0);
    load_bx(0, 0);
    cp_async_commit();

    for (int r = tid; r < q_len; r += kMmaThreads) dtc[r] = dtb[(long long)(c0 + r) * dts.s];
    if (c0 > 0) {
      // h0's bf16 hi and lo parts, the B operand of C h0^T
#pragma unroll
      for (int j = 0; j < kSN; ++j) {
        const int n = (sn0 + j) * 8 + c2;
#pragma unroll
        for (int u = 0; u < 2; ++u) {
          const int p = sm * 16 + g8 + 8 * u;
          uint32_t hi, lo;
          split_bf16(hst[j][2 * u], hst[j][2 * u + 1], hi, lo);
          *reinterpret_cast<uint32_t*>(hh + p * kLdN + n) = hi;
          *reinterpret_cast<uint32_t*>(hl + p * kLdN + n) = lo;
        }
      }
    }
    __syncthreads();
    // cum, the inclusive prefix sum of dt A: lane l of warp 0 sums its run
    // of consecutive rows, a warp scan adds the runs before it
    if (warp == 0) {
      const int per = (q_len + 31) / 32;
      const int rb = lane * per;
      float run = 0.0f;
      for (int k = 0; k < per; ++k)
        if (rb + k < q_len) run += dtc[rb + k] * a;
      float incl = run;
#pragma unroll
      for (int off = 1; off < 32; off <<= 1) {
        const float up = __shfl_up_sync(0xffffffffu, incl, off);
        if (lane >= off) incl += up;
      }
      float acc = __shfl_up_sync(0xffffffffu, incl, 1);
      if (lane == 0) acc = 0.0f;
      for (int k = 0; k < per; ++k) {
        if (rb + k < q_len) {
          acc += dtc[rb + k] * a;
          cum[rb + k] = acc;
        }
      }
    }
    __syncthreads();
    const float cum_last = cum[q_len - 1];
    for (int r = tid; r < chunk_pad; r += kMmaThreads)
      wk[r] = r < q_len ? exp2_ftz((cum_last - cum[r]) * kLog2e) * dtc[r] : 0.0f;
    const float decay = exp2_ftz(cum_last * kLog2e);
#pragma unroll
    for (int j = 0; j < kSN; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) hst[j][e] *= decay;

    float yacc[kPT][4];
    int I = 0, J = 0;
    for (int step = 0;; ++step) {
      cp_async_wait<0>();
      __syncthreads();  // this step's tiles have landed everywhere; the last step is done
      int nI = I, nJ = J + 1;
      if (nJ > I) {
        nI = I + 1;
        nJ = 0;
      }
      if (nI < n_sub) {
        if (kCBufs == 2 && nJ == 0) load_c(nI);
        load_bx(nJ, (step + 1) & 1);
        cp_async_commit();
      }

      const int i0 = I * kTile, j0 = J * kTile;
      const bool diag = I == J;
      const uint32_t ct = c_smem + (I % kCBufs) * Tiles::kCBytes;
      const uint32_t bt = b_smem + (step & 1) * kTile * kRowN;
      const uint32_t xt = x_smem + (step & 1) * kTile * kRowP;
      const int r0 = i0 + warp * 16 + g8;  // this lane's chunk rows r0 and r0 + 8

      if (J == 0) {
#pragma unroll
        for (int j = 0; j < kPT; ++j) yacc[j][0] = yacc[j][1] = yacc[j][2] = yacc[j][3] = 0.0f;
        if (c0 > 0) {
          // the carried state's share, exp(cum_i) (C h0^T)[i, p], h0 as hi + lo
#pragma unroll
          for (int kk = 0; kk < kKN; ++kk) {
            uint32_t af[4];
            ldmatrix_x4(af, ct + a_frag + kk * 32);
#pragma unroll
            for (int np = 0; np < kPT / 2; ++np) {
              uint32_t hf[4];
              ldmatrix_x4(hf, hh_smem + nk_frag + np * 16 * kRowN + kk * 32);
              mma(yacc[2 * np], af, hf[0], hf[1]);
              mma(yacc[2 * np + 1], af, hf[2], hf[3]);
            }
#pragma unroll
            for (int np = 0; np < kPT / 2; ++np) {
              uint32_t hf[4];
              ldmatrix_x4(hf, hl_smem + nk_frag + np * 16 * kRowN + kk * 32);
              mma(yacc[2 * np], af, hf[0], hf[1]);
              mma(yacc[2 * np + 1], af, hf[2], hf[3]);
            }
          }
          const float e0 = r0 < q_len ? exp2_ftz(cum[r0] * kLog2e) : 0.0f;
          const float e1 = r0 + 8 < q_len ? exp2_ftz(cum[r0 + 8] * kLog2e) : 0.0f;
#pragma unroll
          for (int j = 0; j < kPT; ++j) {
            yacc[j][0] *= e0;
            yacc[j][1] *= e0;
            yacc[j][2] *= e1;
            yacc[j][3] *= e1;
          }
        }
      }

      // S = C_I B_J^T: 8 n-tiles of 8 keys; on the diagonal, warp w's rows
      // see only keys below 16 (w + 1)
      const int nt_end = diag ? 2 * (warp + 1) : kTile / 8;
      float sc[kTile / 8][4];
#pragma unroll
      for (int j = 0; j < kTile / 8; ++j) sc[j][0] = sc[j][1] = sc[j][2] = sc[j][3] = 0.0f;
#pragma unroll
      for (int kk = 0; kk < kKN; ++kk) {
        uint32_t af[4];
        ldmatrix_x4(af, ct + a_frag + kk * 32);
#pragma unroll
        for (int np = 0; np < kTile / 16; ++np) {
          if (2 * np < nt_end) {
            uint32_t bf[4];
            ldmatrix_x4(bf, bt + nk_frag + np * 16 * kRowN + kk * 32);
            mma(sc[2 * np], af, bf[0], bf[1]);
            mma(sc[2 * np + 1], af, bf[2], bf[3]);
          }
        }
      }
      if (kCBufs == 1 && diag && nI < n_sub) {
        // C_I is read for the last time above: C_{I+1} loads into the one
        // buffer while the rest of this step computes
        __syncthreads();
        load_c(nI);
        cp_async_commit();
      }

      // the decay mask, applied before any exp: only i >= j inside the
      // chunk's rows takes exp(cum_i - cum_j) dt_j, the rest is 0
      const float cr0 = r0 < q_len ? cum[r0] : 0.0f;
      const float cr1 = r0 + 8 < q_len ? cum[r0 + 8] : 0.0f;
#pragma unroll
      for (int j = 0; j < kTile / 8; ++j) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int ri = r0 + (e / 2) * 8;
          const int rk = j0 + 8 * j + c2 + (e % 2);
          const float cr = e < 2 ? cr0 : cr1;
          sc[j][e] = (ri >= rk && ri < q_len)
                         ? sc[j][e] * (exp2_ftz((cr - cum[rk]) * kLog2e) * dtc[rk])
                         : 0.0f;
        }
      }

      // y_I += (S o L) x_J: S o L's accumulator fragments are the A operand
      // as they lie, as hi + lo; hi products before lo
      const int kk_end = diag ? warp + 1 : kTile / 16;
#pragma unroll
      for (int kk = 0; kk < kTile / 16; ++kk) {
        if (kk < kk_end) {
          uint32_t ph[4], pl[4];
          split_bf16(sc[2 * kk][0], sc[2 * kk][1], ph[0], pl[0]);
          split_bf16(sc[2 * kk][2], sc[2 * kk][3], ph[1], pl[1]);
          split_bf16(sc[2 * kk + 1][0], sc[2 * kk + 1][1], ph[2], pl[2]);
          split_bf16(sc[2 * kk + 1][2], sc[2 * kk + 1][3], ph[3], pl[3]);
          uint32_t vf[kPT / 2][4];
#pragma unroll
          for (int np = 0; np < kPT / 2; ++np) {
            ldmatrix_x4_trans(vf[np], xt + kn_frag_p + kk * 16 * kRowP + np * 32);
            mma(yacc[2 * np], ph, vf[np][0], vf[np][1]);
            mma(yacc[2 * np + 1], ph, vf[np][2], vf[np][3]);
          }
#pragma unroll
          for (int np = 0; np < kPT / 2; ++np) {
            mma(yacc[2 * np], pl, vf[np][0], vf[np][1]);
            mma(yacc[2 * np + 1], pl, vf[np][2], vf[np][3]);
          }
        }
      }

      if (diag) {
        // the diagonal is the last key sub-tile of query sub-tile I and the
        // only visit of key sub-tile J with I == J: its rows' share of the
        // state update, h += (w o x_J)^T B_J with w o x as hi + lo ...
#pragma unroll
        for (int kk = 0; kk < kTile / 16; ++kk) {
          const int k0 = j0 + kk * 16 + c2;
          const float w0 = wk[k0], w1 = wk[k0 + 1], w8 = wk[k0 + 8], w9 = wk[k0 + 9];
          uint32_t xa[4], ah[4], al[4];
          ldmatrix_x4_trans(xa, xt + xt_frag + kk * 16 * kRowP + sm * 32);
          scale_split(xa[0], w0, w1, ah[0], al[0]);
          scale_split(xa[1], w0, w1, ah[1], al[1]);
          scale_split(xa[2], w8, w9, ah[2], al[2]);
          scale_split(xa[3], w8, w9, ah[3], al[3]);
          if constexpr (kSN == 1) {
            uint32_t bf[2];
            ldmatrix_x2_trans(bf, bt + kn_frag_n + kk * 16 * kRowN + sn0 * 16);
            mma(hst[0], ah, bf[0], bf[1]);
            mma(hst[0], al, bf[0], bf[1]);
          } else {
#pragma unroll
            for (int jp = 0; jp < kSN / 2; ++jp) {
              uint32_t bf[4];
              ldmatrix_x4_trans(bf, bt + kn_frag_n + kk * 16 * kRowN + (sn0 + 2 * jp) * 16);
              mma(hst[2 * jp], ah, bf[0], bf[1]);
              mma(hst[2 * jp + 1], ah, bf[2], bf[3]);
              mma(hst[2 * jp], al, bf[0], bf[1]);
              mma(hst[2 * jp + 1], al, bf[2], bf[3]);
            }
          }
        }
        // ... then the skip term, and y's rows of sub-tile I
        const bf16* xr = x_tiles + (step & 1) * kTile * kLdP;
#pragma unroll
        for (int j = 0; j < kPT; ++j) {
          const int col = 8 * j + c2;
#pragma unroll
          for (int u = 0; u < 2; ++u) {
            const int r = warp * 16 + g8 + 8 * u;
            if (i0 + r < q_len) {
              const float2 xv =
                  __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(xr + r * kLdP + col));
              *reinterpret_cast<__nv_bfloat162*>(yb + (long long)(c0 + i0 + r) * ys.s + col) =
                  __floats2bfloat162_rn(yacc[j][2 * u] + d * xv.x, yacc[j][2 * u + 1] + d * xv.y);
            }
          }
        }
      }

      if (nI >= n_sub) break;
      I = nI;
      J = nJ;
    }
  }

  float* sb = state_out + (static_cast<long long>(b) * H + h) * P * N;
#pragma unroll
  for (int j = 0; j < kSN; ++j) {
    const int n = (sn0 + j) * 8 + c2;
    const int p = sm * 16 + g8;
    *reinterpret_cast<float2*>(sb + p * N + n) = make_float2(hst[j][0], hst[j][1]);
    *reinterpret_cast<float2*>(sb + (p + 8) * N + n) = make_float2(hst[j][2], hst[j][3]);
  }
}

// Two C buffers (C_{I+1} loads a whole step ahead) where every block has an
// SM to itself anyway, Bt * H <= the SM count; else one, so that two
// blocks share an SM, at the price of a barrier inside each diagonal step
// (the count is a template parameter: the two-buffer kernel has no such
// barrier). Built with the choice fixed each way and timed on an H100
// (CUDA-graph replay, H=80, P=64, N=128, chunk 256, bf16): at Bt=8, S=512
// (640 blocks) one buffer took 0.292 ms and two 0.346; at Bt=1, S=8192 (80
// blocks) one took 1.27-1.30 ms and two 1.10-1.11. Only those two grid
// sizes were measured: where between 80 and 640 blocks two buffers stop
// paying is not known, and the SM count is the rule's guess at it.
int c_buffers(int Bt, int H) {
  static int sms = 0;
  if (sms == 0) {
    int dev = 0;
    if (cudaGetDevice(&dev) != cudaSuccess ||
        cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev) != cudaSuccess)
      sms = 132;
  }
  return static_cast<long long>(Bt) * H <= sms ? 2 : 1;
}

template <int P, int N, int kCBufs>
int launch_mma(const void* x, const void* dt, const void* A, const void* B, const void* C,
               const void* D, void* y, void* state, int Bt, int S, int H, int G, int chunk,
               const long long* st, cudaStream_t stream) {
  const int smem = MmaTiles<P, N, kCBufs>::smem_bytes(chunk);
  static int configured = 0;  // above 48 KB only by opting in; raised as needed
  if (smem > configured) {
    const cudaError_t err = cudaFuncSetAttribute(ssd_scan_mma_kernel<P, N, kCBufs>,
                                                 cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return static_cast<int>(err);
    configured = smem;
  }
  const Strides xs{st[0], st[1], st[2]}, dts{st[3], st[4], st[5]}, bs{st[6], st[7], st[8]},
      cs{st[9], st[10], st[11]}, ys{st[12], st[13], st[14]};
  const dim3 grid(H, Bt);
  ssd_scan_mma_kernel<P, N, kCBufs><<<grid, kMmaThreads, smem, stream>>>(
      static_cast<const bf16*>(x), static_cast<const float*>(dt), static_cast<const float*>(A),
      static_cast<const bf16*>(B), static_cast<const bf16*>(C), static_cast<const float*>(D),
      static_cast<bf16*>(y), static_cast<float*>(state), S, H, G, chunk, xs, dts, bs, cs, ys);
  return static_cast<int>(cudaGetLastError());
}

template <int P, int N>
int launch_mma_c(const void* x, const void* dt, const void* A, const void* B, const void* C,
                 const void* D, void* y, void* state, int Bt, int S, int H, int G, int chunk,
                 const long long* st, cudaStream_t stream) {
  if (c_buffers(Bt, H) == 2)
    return launch_mma<P, N, 2>(x, dt, A, B, C, D, y, state, Bt, S, H, G, chunk, st, stream);
  return launch_mma<P, N, 1>(x, dt, A, B, C, D, y, state, Bt, S, H, G, chunk, st, stream);
}

template <int P>
int dispatch_mma_n(int N, const void* x, const void* dt, const void* A, const void* B,
                   const void* C, const void* D, void* y, void* state, int Bt, int S, int H,
                   int G, int chunk, const long long* st, cudaStream_t stream) {
  switch (N) {
    case 16:
      return launch_mma_c<P, 16>(x, dt, A, B, C, D, y, state, Bt, S, H, G, chunk, st, stream);
    case 128:
      return launch_mma_c<P, 128>(x, dt, A, B, C, D, y, state, Bt, S, H, G, chunk, st, stream);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

int dispatch_mma(int P, int N, const void* x, const void* dt, const void* A, const void* B,
                 const void* C, const void* D, void* y, void* state, int Bt, int S, int H,
                 int G, int chunk, const long long* st, cudaStream_t stream) {
  switch (P) {
    case 32:
      return dispatch_mma_n<32>(N, x, dt, A, B, C, D, y, state, Bt, S, H, G, chunk, st, stream);
    case 64:
      return dispatch_mma_n<64>(N, x, dt, A, B, C, D, y, state, Bt, S, H, G, chunk, st, stream);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

bool valid_shape(int Bt, int S, int H, int G, int chunk) {
  return Bt > 0 && Bt <= 65535 && S > 0 && H > 0 && G > 0 && H % G == 0 && chunk > 0 &&
         chunk <= kMaxChunk;
}

}  // namespace

// Plain C entry points for ctypes: device pointers; 15 element strides
// (b, s, head or group of x, dt, B, C, y; the last dimension of x, B, C
// and y is unit-stride); the CUDA stream as a pointer. The state out is
// contiguous [Bt, H, P, N] f32. The return value is cudaGetLastError()
// after the launch.
extern "C" int ssd_scan_f32(const void* x, const void* dt, const void* A, const void* B,
                            const void* C, const void* D, void* y, void* state, int Bt, int S,
                            int H, int G, int P, int N, int chunk, const long long* strides,
                            void* stream) {
  if (!valid_shape(Bt, S, H, G, chunk)) return static_cast<int>(cudaErrorInvalidValue);
  return dispatch<float>(P, N, x, dt, A, B, C, D, y, state, Bt, S, H, G, chunk, strides,
                         static_cast<cudaStream_t>(stream));
}

extern "C" int ssd_scan_bf16(const void* x, const void* dt, const void* A, const void* B,
                             const void* C, const void* D, void* y, void* state, int Bt, int S,
                             int H, int G, int P, int N, int chunk, const long long* strides,
                             void* stream) {
  if (!valid_shape(Bt, S, H, G, chunk)) return static_cast<int>(cudaErrorInvalidValue);
  return dispatch_mma(P, N, x, dt, A, B, C, D, y, state, Bt, S, H, G, chunk, strides,
                      static_cast<cudaStream_t>(stream));
}

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
// all, 27 us at the tensor cores' 989 TFLOP/s: bytes bound it there, and
// operations, barely, at Bt=1, S=8192 (54 us against 53 us of bytes).
// This kernel does not reach that: it runs the products as
// scalar fp32 FMAs fed from shared memory (at most 67 TFLOP/s on the card,
// in practice a fraction of it), so those FMAs and the shared-memory loads
// feeding them bound it. Tensor cores (mma.sync, then wgmma with TMA), one
// C B^T per state group shared by its H / G heads, and more blocks than
// Bt * H at small Bt are later work.
//
// Design. The TPU kernel carries h in VMEM across a sequential grid axis
// over chunks; blocks on Hopper run in no order, so one block of 256
// threads owns one (b, h) and walks its chunks itself, with h (P x N f32,
// 32 KB at 64 x 128) in shared memory. The TPU kernel's [Q, Q] f32 C B^T
// tile would be 256 KB at Q = 256, over the 227 KB a block may have, so a
// chunk is cut into sub-tiles of 64 rows: for each query sub-tile I the
// block loops over key sub-tiles J <= I (those above the diagonal are
// skipped), as the flash kernel loops over its KV tiles, with the decay
// mask in place of a softmax. Thread (ty, tx) = (tid / 16, tid % 16) owns
// rows ty + 16 a of a sub-tile and, for the scores, keys tx + 16 k; for y,
// columns tx + 16 j; for the state, rows p = ty + 16 a and columns
// n = tx + 16 j, whose chunk input sum_j w_j x_j B_j^T it keeps in
// registers until every sub-tile has read h0. Rows of shared-memory tiles
// that a loop walks across threads are padded by one float, so that those
// reads fall in distinct banks.
//
// The decay is masked before exp (exp is taken only for i >= j, where
// cum_i - cum_j <= 0), so the above-diagonal exp(+big) never appears.
// Unlike the TPU kernel, S need not be a multiple of Q: the last chunk is
// ragged, its rows past S are loaded as zeros, add nothing and are not
// written, and cum_last is the cum of row S - 1, so the state out is the
// state after row S - 1. x, B, C, dt and y are read and written in place
// through their strides (the TPU wrapper transposes all four to heads-major
// first), so the model's x, B and C, slices of one conv output, need no
// copy. Everything is accumulated in fp32.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

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
  return dispatch<__nv_bfloat16>(P, N, x, dt, A, B, C, D, y, state, Bt, S, H, G, chunk,
                                 strides, static_cast<cudaStream_t>(stream));
}

// Per-coordinate robust combine of C stacked client updates (the
// coordinate-wise trimmed mean and median defences, Aggregator.combine):
//
//     out[m] = sum_i w_row[i] * sorted_i(x'[0, m], ..., x'[C-1, m])
//     x'[c, m] = mask[c] > 0 ? x[c, m] : 3.0e38          x [C, M] f32
//
// w_row [C] weighs the ascending-sorted positions (row_select_weights in
// robust_combine/ops.py picks the trimmed mean or the median), and masked
// clients sort past every finite value, into the positions w_row leaves at 0.
//
// Replaces the Pallas TPU kernel
// src/repro/kernels/robust_combine/kernel.py:robust_combine_pallas.
//
// Bound on Hopper: memory. The kernel must read every x element once and
// write every output once, (C + 1) * M * 4 bytes. Per column it does
// 2 * P min/max (P compare-exchanges: 103 at C=20, 543 at C=64) and C
// multiply-adds, so at C=20 about 250 operations for 84 bytes, 3 a byte,
// below the ~20 operations a byte at which an H100's fp32 units, not HBM,
// would limit it; at C=64 about 5 a byte.
//
// Design: the TPU kernel sorts [C, block_m] VMEM tiles row against row.
// Here one thread owns one column (or 4 neighbouring columns with 16-byte
// loads, where M % 4 == 0, the base is 16-byte aligned and C <= 32), holds
// its column's C values in registers and runs Batcher's odd-even mergesort
// network over them. The network is the static list of oddeven_merge_pairs
// (robust_combine/ref.py), built here at compile time for each C and
// unrolled through a parameter pack, so every register index is a
// constant: nothing is indexed at run time and nothing goes to local memory
// (nvcc's -Xptxas -v report shows the spills). The kernel is instantiated
// for C = 1..64.
//
// Above 64 clients a column no longer fits a thread's registers, and the
// reference's network (unrolled at trace time for any C) has no such
// limit. For 64 < C <= kMaxSmemC a second kernel stages its block's 32
// columns in shared memory, C rows of 32 floats: thread t owns column t,
// value c of it at c * 32 + t, so the 32 threads of the warp always touch
// one row at a time in 32 distinct banks (no padding is needed). Each
// thread walks the same network, the loops of oddeven_merge_pairs evaluated
// at run time (shifts for the divisions by 2p; merge_pairs_by_loops in
// robust_combine/ref.py mirrors them), so the warp never diverges and the
// result, NaN placement included, is the plain network's. kMaxSmemC is the
// largest C whose 32 columns fit the 227 KB (232,448 bytes) of shared
// memory a block may have: 1,816. The wrapper refuses more. Speed is not
// this kernel's goal: at C = 1,024 a block fills 128 KB, one block (one
// warp) an SM, and each compare-exchange waits on its shared-memory loads.
// Measured (chip_smoke.py, CUDA-graph replay, one NVIDIA H100 80GB HBM3 at
// a 700 W power limit): [100, 188,810] 0.32 ms, 4x faster than torch.sort
// + torch.mv; [1,024, 2^16] 22 ms, 5.7x slower than them. The pairs of one
// (p, k) stage are disjoint, so several warps could share a block's
// columns, a stage at a time: the step to take if a path reaches C > 64.
//
// Numerics: min and max propagate NaN, as torch.minimum and jnp.minimum do
// (CUDA's fminf and fmaxf drop it), through PTX's min.NaN / max.NaN. The
// masked sentinel stays the finite 3.0e38, so 0 * sentinel is 0, never NaN.
// The final dot is taken in the plain version's order, rounding each
// product and each sum (no fused multiply-add), as the plain version's
// separate multiply and add do.

#include <cuda_runtime.h>
#include <stdint.h>

#include <utility>

namespace {

constexpr int kThreads = 256;
constexpr int kMaxC = 64;
constexpr int kMaxPairs = 543;  // compare-exchanges at C = 64
constexpr int kVecMaxC = 32;    // above it, 4 columns of C values spill
constexpr float kSentinel = 3.0e38f;

struct Network {
  int n;
  int lo[kMaxPairs];
  int hi[kMaxPairs];
};

// The loops of oddeven_merge_pairs, evaluated by the compiler.
__host__ __device__ constexpr Network make_network(int c) {
  Network net{};
  for (int p = 1; p < c; p *= 2) {
    for (int k = p; k >= 1; k /= 2) {
      for (int j = k % p; j < c - k; j += 2 * k) {
        const int span = k < c - j - k ? k : c - j - k;
        for (int i = 0; i < span; ++i) {
          if ((i + j) / (2 * p) == (i + j + k) / (2 * p)) {
            net.lo[net.n] = i + j;
            net.hi[net.n] = i + j + k;
            ++net.n;
          }
        }
      }
    }
  }
  return net;
}

template <int C>
struct Schedule {
  static constexpr Network net = make_network(C);
};

// Scalar reads of the schedule, only ever evaluated as template arguments.
template <int C>
__host__ __device__ constexpr int pair_count() { return Schedule<C>::net.n; }
template <int C>
__host__ __device__ constexpr int pair_lo(int p) { return Schedule<C>::net.lo[p]; }
template <int C>
__host__ __device__ constexpr int pair_hi(int p) { return Schedule<C>::net.hi[p]; }

static_assert(pair_count<16>() == 63 && pair_count<20>() == 103 &&
              pair_count<32>() == 191 && pair_count<kMaxC>() == kMaxPairs,
              "Batcher's network has 63, 103, 191 and 543 comparators at "
              "C = 16, 20, 32 and 64");

__device__ __forceinline__ float min_nan(float a, float b) {
  float d;
  asm("min.NaN.f32 %0, %1, %2;" : "=f"(d) : "f"(a), "f"(b));
  return d;
}

__device__ __forceinline__ float max_nan(float a, float b) {
  float d;
  asm("max.NaN.f32 %0, %1, %2;" : "=f"(d) : "f"(a), "f"(b));
  return d;
}

template <int C, int VEC, int I, int J>
__device__ __forceinline__ void compare_exchange(float (&v)[C][VEC]) {
#pragma unroll
  for (int j = 0; j < VEC; ++j) {
    const float a = v[I][j], b = v[J][j];
    v[I][j] = min_nan(a, b);
    v[J][j] = max_nan(a, b);
  }
}

template <int C, int VEC, int... P>
__device__ __forceinline__ void sort_columns(float (&v)[C][VEC],
                                             std::integer_sequence<int, P...>) {
  (compare_exchange<C, VEC, pair_lo<C>(P), pair_hi<C>(P)>(v), ...);
}

template <int C, int VEC>
__global__ void __launch_bounds__(kThreads)
robust_kernel(const float* __restrict__ x, const float* __restrict__ mask,
              const float* __restrict__ w_row, float* __restrict__ out, int64_t M) {
  const int64_t m0 = (static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x) * VEC;
  if (m0 >= M) return;  // with VEC = 4, M % 4 == 0: a thread's columns all exist
  float v[C][VEC];
#pragma unroll
  for (int c = 0; c < C; ++c) {
    const float* p = x + static_cast<int64_t>(c) * M + m0;
    if constexpr (VEC == 4) {
      const float4 r = __ldg(reinterpret_cast<const float4*>(p));
      v[c][0] = r.x; v[c][1] = r.y; v[c][2] = r.z; v[c][3] = r.w;
    } else {
      v[c][0] = __ldg(p);
    }
  }
#pragma unroll
  for (int c = 0; c < C; ++c) {
    const bool keep = __ldg(mask + c) > 0.0f;
#pragma unroll
    for (int j = 0; j < VEC; ++j) v[c][j] = keep ? v[c][j] : kSentinel;
  }

  sort_columns<C, VEC>(v, std::make_integer_sequence<int, pair_count<C>()>{});

  float acc[VEC];
  const float w0 = __ldg(w_row);
#pragma unroll
  for (int j = 0; j < VEC; ++j) acc[j] = __fmul_rn(v[0][j], w0);
#pragma unroll
  for (int c = 1; c < C; ++c) {
    const float wc = __ldg(w_row + c);
#pragma unroll
    for (int j = 0; j < VEC; ++j) acc[j] = __fadd_rn(acc[j], __fmul_rn(v[c][j], wc));
  }
  if constexpr (VEC == 4) {
    *reinterpret_cast<float4*>(out + m0) = make_float4(acc[0], acc[1], acc[2], acc[3]);
  } else {
    out[m0] = acc[0];
  }
}

using LaunchFn = int (*)(const float*, const float*, const float*, float*, int64_t, bool,
                         cudaStream_t);

template <int C, int VEC>
int launch_vec(const float* x, const float* mask, const float* w_row, float* out, int64_t M,
               cudaStream_t stream) {
  const int64_t threads_needed = (M + VEC - 1) / VEC;
  const unsigned blocks = static_cast<unsigned>((threads_needed + kThreads - 1) / kThreads);
  robust_kernel<C, VEC><<<blocks, kThreads, 0, stream>>>(x, mask, w_row, out, M);
  return static_cast<int>(cudaGetLastError());
}

template <int C>
int launch(const float* x, const float* mask, const float* w_row, float* out, int64_t M,
           bool vec_ok, cudaStream_t stream) {
  if constexpr (C <= kVecMaxC) {
    if (vec_ok) return launch_vec<C, 4>(x, mask, w_row, out, M, stream);
  }
  return launch_vec<C, 1>(x, mask, w_row, out, M, stream);
}

template <int... I>
int dispatch(int C, const float* x, const float* mask, const float* w_row, float* out,
             int64_t M, bool vec_ok, cudaStream_t stream, std::integer_sequence<int, I...>) {
  static constexpr LaunchFn kTable[] = {&launch<I + 1>...};
  return kTable[C - 1](x, mask, w_row, out, M, vec_ok, stream);
}

constexpr int kSmemCols = 32;    // columns (threads) a block of the staged kernel
constexpr int kMaxSmemC = 1816;  // 1816 x 32 x 4 bytes = 232,448, a block's shared memory

__global__ void __launch_bounds__(kSmemCols)
robust_kernel_smem(const float* __restrict__ x, const float* __restrict__ mask,
                   const float* __restrict__ w_row, float* __restrict__ out, int C, int64_t M) {
  extern __shared__ float cols[];  // [C][kSmemCols]
  const int64_t m = static_cast<int64_t>(blockIdx.x) * kSmemCols + threadIdx.x;
  if (m >= M) return;  // no thread reads another's column: nothing to wait for
  float* v = cols + threadIdx.x;
  for (int c = 0; c < C; ++c) {
    const float xv = __ldg(x + static_cast<int64_t>(c) * M + m);
    v[c * kSmemCols] = __ldg(mask + c) > 0.0f ? xv : kSentinel;
  }
  for (int p = 1; p < C; p *= 2) {
    const int shift = __ffs(p);  // (i + j) / (2 p) == (i + j) >> shift
    for (int k = p; k >= 1; k /= 2) {
      for (int j = k % p; j < C - k; j += 2 * k) {
        const int span = min(k, C - j - k);
        for (int i = 0; i < span; ++i) {
          const int lo = i + j, hi = i + j + k;
          if ((lo >> shift) != (hi >> shift)) continue;
          const float a = v[lo * kSmemCols], b = v[hi * kSmemCols];
          v[lo * kSmemCols] = min_nan(a, b);
          v[hi * kSmemCols] = max_nan(a, b);
        }
      }
    }
  }
  float acc = __fmul_rn(v[0], __ldg(w_row));
  for (int c = 1; c < C; ++c) acc = __fadd_rn(acc, __fmul_rn(v[c * kSmemCols], __ldg(w_row + c)));
  out[m] = acc;
}

int launch_smem(const float* x, const float* mask, const float* w_row, float* out, int C,
                int64_t M, cudaStream_t stream) {
  static bool configured = false;  // above 48 KB only by opting in, once, for the largest C
  if (!configured) {
    const cudaError_t err =
        cudaFuncSetAttribute(robust_kernel_smem, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             kMaxSmemC * kSmemCols * static_cast<int>(sizeof(float)));
    if (err != cudaSuccess) return static_cast<int>(err);
    configured = true;
  }
  const unsigned blocks = static_cast<unsigned>((M + kSmemCols - 1) / kSmemCols);
  const size_t smem = static_cast<size_t>(C) * kSmemCols * sizeof(float);
  robust_kernel_smem<<<blocks, kSmemCols, smem, stream>>>(x, mask, w_row, out, C, M);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Plain C entry point for ctypes: device pointers, the CUDA stream as a
// pointer; the return value is cudaGetLastError() after the launch.
extern "C" int robust_combine_f32(const void* x, const void* mask, const void* w_row,
                                  void* out, int C, long long M, void* stream) {
  if (C < 1 || C > kMaxSmemC || M <= 0) return static_cast<int>(cudaErrorInvalidValue);
  if (C > kMaxC)
    return launch_smem(static_cast<const float*>(x), static_cast<const float*>(mask),
                       static_cast<const float*>(w_row), static_cast<float*>(out), C,
                       static_cast<int64_t>(M), static_cast<cudaStream_t>(stream));
  const bool vec_ok = (M % 4 == 0) && (reinterpret_cast<uintptr_t>(x) % 16 == 0) &&
                      (reinterpret_cast<uintptr_t>(out) % 16 == 0);
  return dispatch(C, static_cast<const float*>(x), static_cast<const float*>(mask),
                  static_cast<const float*>(w_row), static_cast<float*>(out),
                  static_cast<int64_t>(M), vec_ok, static_cast<cudaStream_t>(stream),
                  std::make_integer_sequence<int, kMaxC>{});
}

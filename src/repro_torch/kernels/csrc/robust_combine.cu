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
// Above 64 clients the reference's network (unrolled at trace time for any
// C) still has no limit; two more tiers carry it.
//
// 65 <= C <= 128, registers: the same one-thread-a-column kernel, its
// network built at compile time for a padded size C_pad in kPads (80, 96,
// 112, 128: four instances, not 64). Rows C..C_pad-1 hold +inf, which sorts
// past the 3.0e38 masked sentinel: a compare-exchange with a padding row
// leaves both rows as they were, so the first C sorted values are the
// plain network's own (its pairs are the padded network's with hi < C).
// A NaN in a real row still reaches all C outputs, as in the plain
// network: every output of a sorting network depends on every input, and
// min.NaN / max.NaN pass NaN on both ways. The dot runs over the C_pad
// positions with compile-time indices and a run-time c < C predicate, so
// nothing is indexed at run time. The mask and w_row are staged once a
// block in shared memory: read from global memory row by row, their loads
// were hoisted beside the x loads, ptxas ran out of registers and the
// tier ran several times slower. robust_combine/ref.py's
// robust_combine_padded_ref mirrors the tier.
//
// 128 < C <= kMaxSmemC, shared memory: a block of 8 warps owns 32 columns,
// C rows of 32 floats (value c of column t at c * 32 + t; 1,816 rows fill
// the 227 KB, 232,448 bytes, a block may have; the wrapper refuses more).
// First each warp loads 64-row segments of the 32 columns into registers
// (lane = column, one 128-byte row at a time, the segment's mask as a
// 64-bit ballot) and runs the network's stages with p <= 32 there: their
// pairs never leave an aligned 64-row block, so they are the 64-row
// network on each segment, padded with +inf where the last one is short.
// Then the block walks the remaining stages (p >= 64; 34 of 55 at
// C = 1,024, 64 % of the compare-exchanges) one at a time with
// __syncthreads between them. A stage's pairs are disjoint; slot t of
// stage (p, k) is the pair lo = k % p + 2k floor(t / k) + t % k,
// hi = lo + k, skipped where hi >= C or the two lie in different 2p blocks
// (robust_combine/ref.py's stage_pairs). The slots are dealt out to the
// warps four at a time, eight lanes a slot and a float4 (4 columns) a
// lane, so that each quarter-warp access is one 128-byte row, free of bank
// conflicts, and a warp's shared loads and stores are a quarter of the
// one-row-a-warp count; two rounds of slots are loaded before any is
// stored. After the last stage warp 0 takes the dot, one column a lane.
//
// Bound (C = 1,024, M = 2^16): 24,063 compare-exchanges a column, 15,375 of
// them in shared memory, 4 row accesses of 128 bytes each, at one 128-byte
// access a clock an SM: ~61,500 clocks a block, one block (128 KB) an SM
// at a time, 2,048 blocks; about 0.55 ms against the 0.08 ms of reading x
// once. At C = 100 (padded to 112): 1,264 compare-exchanges, 2,528 min/max
// a column, ~0.03 ms at 64 min/max a clock an SM, against 0.0228 ms of
// reading x once.
// Measured (chip_smoke.py, CUDA-graph replay, inputs from HBM, one NVIDIA
// H100 80GB HBM3 at a 700 W power limit; PERF.md section 6):
// [100, 188,810] 0.050 ms, 27x faster than torch.sort + torch.mv;
// [1,024, 2^16] 0.89 ms, 4.4x faster than them.
//
// Numerics: min and max propagate NaN, as torch.minimum and jnp.minimum do
// (CUDA's fminf and fmaxf drop it), through PTX's min.NaN / max.NaN. The
// masked sentinel stays the finite 3.0e38, so 0 * sentinel is 0, never NaN.
// The final dot is taken in the plain version's order, rounding each
// product and each sum (no fused multiply-add), as the plain version's
// separate multiply and add do.

#include <cuda_runtime.h>
#include <math_constants.h>
#include <stdint.h>

#include <utility>

namespace {

constexpr int kThreads = 256;
constexpr int kMaxC = 64;
constexpr int kVecMaxC = 32;    // above it, 4 columns of C values spill
constexpr float kSentinel = 3.0e38f;

// The loops of oddeven_merge_pairs, evaluated by the compiler: the pair
// count, and with lo / hi given, the pairs themselves.
__host__ __device__ constexpr int walk_network(int c, int* lo, int* hi) {
  int n = 0;
  for (int p = 1; p < c; p *= 2) {
    for (int k = p; k >= 1; k /= 2) {
      for (int j = k % p; j < c - k; j += 2 * k) {
        const int span = k < c - j - k ? k : c - j - k;
        for (int i = 0; i < span; ++i) {
          if ((i + j) / (2 * p) == (i + j + k) / (2 * p)) {
            if (lo != nullptr) {
              lo[n] = i + j;
              hi[n] = i + j + k;
            }
            ++n;
          }
        }
      }
    }
  }
  return n;
}

template <int N>
struct Network {
  int lo[N];
  int hi[N];
};

template <int N>
__host__ __device__ constexpr Network<N> make_network(int c) {
  Network<N> net{};
  walk_network(c, net.lo, net.hi);
  return net;
}

template <int C>
struct Schedule {
  static constexpr int n = walk_network(C, nullptr, nullptr);
  static constexpr Network<(n > 0 ? n : 1)> net = make_network<(n > 0 ? n : 1)>(C);
};

// Scalar reads of the schedule, only ever evaluated as template arguments.
template <int C>
__host__ __device__ constexpr int pair_count() { return Schedule<C>::n; }
template <int C>
__host__ __device__ constexpr int pair_lo(int p) { return Schedule<C>::net.lo[p]; }
template <int C>
__host__ __device__ constexpr int pair_hi(int p) { return Schedule<C>::net.hi[p]; }

static_assert(pair_count<16>() == 63 && pair_count<20>() == 103 &&
              pair_count<32>() == 191 && pair_count<kMaxC>() == 543 &&
              pair_count<112>() == 1264 && pair_count<128>() == 1471,
              "Batcher's network has 63, 103, 191, 543, 1,264 and 1,471 "
              "comparators at C = 16, 20, 32, 64, 112 and 128");

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

// Batcher's network for C rows over registers, every index a constant.
template <int C, int VEC>
__device__ __forceinline__ void sort_network(float (&v)[C][VEC]) {
  sort_columns<C, VEC>(v, std::make_integer_sequence<int, pair_count<C>()>{});
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

  sort_network<C, VEC>(v);

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

// ---- 65 <= C <= 128: one column a thread, the network padded to C_pad ----

constexpr int kPads[] = {80, 96, 112, 128};  // robust_combine/ref.py: REGISTER_PADS
constexpr int kMaxPadC = 128;
constexpr int kPadThreads = 128;

template <int CP>
__global__ void __launch_bounds__(kPadThreads)
robust_kernel_padded(const float* __restrict__ x, const float* __restrict__ mask,
                     const float* __restrict__ w_row, float* __restrict__ out, int C,
                     int64_t M) {
  // the mask and the weights once a block: 1 / 0 for a kept / masked row and
  // -1 for a padding row, and w_row. Read from global memory row by row, the
  // compiler hoists those loads beside the x loads and runs out of registers.
  __shared__ float keep[CP], wts[CP];
  for (int c = threadIdx.x; c < CP; c += kPadThreads) {
    keep[c] = c < C ? (__ldg(mask + c) > 0.0f ? 1.0f : 0.0f) : -1.0f;
    wts[c] = c < C ? __ldg(w_row + c) : 0.0f;
  }
  __syncthreads();
  const int64_t m = static_cast<int64_t>(blockIdx.x) * kPadThreads + threadIdx.x;
  if (m >= M) return;
  float v[CP][1];
  const float* px = x + m;
#pragma unroll
  for (int c = 0; c < CP; ++c, px += M) {
    const float k = keep[c];
    float val = k < 0.0f ? CUDART_INF_F : kSentinel;  // padding rows sort last, never dotted
    if (k > 0.0f) val = __ldg(px);
    v[c][0] = val;
  }

  sort_network<CP, 1>(v);

  float acc = __fmul_rn(v[0][0], wts[0]);  // C > 64: row 0 is real
#pragma unroll
  for (int c = 1; c < CP; ++c) {
    if (c < C) acc = __fadd_rn(acc, __fmul_rn(v[c][0], wts[c]));
  }
  out[m] = acc;
}

template <int CP>
int launch_padded(const float* x, const float* mask, const float* w_row, float* out, int C,
                  int64_t M, cudaStream_t stream) {
  const unsigned blocks = static_cast<unsigned>((M + kPadThreads - 1) / kPadThreads);
  robust_kernel_padded<CP><<<blocks, kPadThreads, 0, stream>>>(x, mask, w_row, out, C, M);
  return static_cast<int>(cudaGetLastError());
}

int dispatch_padded(const float* x, const float* mask, const float* w_row, float* out, int C,
                    int64_t M, cudaStream_t stream) {
  if (C <= kPads[0]) return launch_padded<kPads[0]>(x, mask, w_row, out, C, M, stream);
  if (C <= kPads[1]) return launch_padded<kPads[1]>(x, mask, w_row, out, C, M, stream);
  if (C <= kPads[2]) return launch_padded<kPads[2]>(x, mask, w_row, out, C, M, stream);
  return launch_padded<kPads[3]>(x, mask, w_row, out, C, M, stream);
}

static_assert(kPads[3] == kMaxPadC, "the last pad holds the register tier's largest C");

// ---- 128 < C <= kMaxSmemC: 32 columns a block in shared memory, 8 warps ----

constexpr int kSmemCols = 32;    // columns a block: one 128-byte row of shared memory
constexpr int kSmemWarps = 8;
constexpr int kSeg = 64;         // rows a warp sorts in registers: the stages p <= 32
constexpr int kRowLanes = kSmemCols / 4;  // lanes that cover a row, 4 columns (a float4) each
constexpr int kWarpSlots = 32 / kRowLanes;  // slots a warp takes at once, one a lane group
constexpr int kBlockSlots = kSmemWarps * kWarpSlots;
constexpr int kSlotsInFlight = 2;  // rounds of slots a warp loads before it stores
constexpr int kMaxSmemC = 1816;  // 1816 x 32 x 4 bytes = 232,448, a block's shared memory

__device__ __forceinline__ float4 min4(float4 a, float4 b) {
  return make_float4(min_nan(a.x, b.x), min_nan(a.y, b.y), min_nan(a.z, b.z), min_nan(a.w, b.w));
}

__device__ __forceinline__ float4 max4(float4 a, float4 b) {
  return make_float4(max_nan(a.x, b.x), max_nan(a.y, b.y), max_nan(a.z, b.z), max_nan(a.w, b.w));
}

__global__ void __launch_bounds__(kSmemCols * kSmemWarps)
robust_kernel_smem(const float* __restrict__ x, const float* __restrict__ mask,
                   const float* __restrict__ w_row, float* __restrict__ out, int C, int64_t M) {
  extern __shared__ float4 rows4[];  // [C][kRowLanes]: row c is columns 0..31 as 8 float4
  float* cols = reinterpret_cast<float*>(rows4);  // the same rows as [C][kSmemCols] floats
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  const int64_t m = static_cast<int64_t>(blockIdx.x) * kSmemCols + lane;
  const bool live = m < M;  // dead lanes carry the sentinel and store nothing out

  // the stages p <= 32: a warp sorts a 64-row segment of its 32 columns in
  // registers, lane = column; the segment's mask as bits, from two ballots
  for (int s = warp; s * kSeg < C; s += kSmemWarps) {
    const int row0 = s * kSeg, rows = min(kSeg, C - row0);
    const bool keep_lo = lane < rows && __ldg(mask + row0 + lane) > 0.0f;
    const bool keep_hi = lane + 32 < rows && __ldg(mask + row0 + 32 + lane) > 0.0f;
    const uint64_t keep = static_cast<uint64_t>(__ballot_sync(~0u, keep_hi)) << 32 |
                          __ballot_sync(~0u, keep_lo);
    float v[kSeg][1];
    const float* px = x + static_cast<int64_t>(row0) * M + m;
#pragma unroll
    for (int r = 0; r < kSeg; ++r, px += M) {
      float val = r < rows ? kSentinel : CUDART_INF_F;  // the short last segment's padding
      if (live && ((keep >> r) & 1)) val = __ldg(px);
      v[r][0] = val;
    }
    sort_network<kSeg, 1>(v);
#pragma unroll
    for (int r = 0; r < kSeg; ++r) {
      if (r < rows) cols[(row0 + r) * kSmemCols + lane] = v[r][0];
    }
  }
  __syncthreads();

  // the stages p >= 64, one at a time. A warp takes kWarpSlots slots at once,
  // a group of kRowLanes lanes each, a float4 of the row a lane: every access
  // is a 128-byte row in each quarter of the warp, so no bank is hit twice
  const int sub = lane % kRowLanes, group = lane / kRowLanes;
  for (int p = kSeg; p < C; p *= 2) {
    const int block_shift = __ffs(p);  // (lo / 2p == hi / 2p) as shifts
    for (int k = p; k >= 1; k /= 2) {
      const int log_k = __ffs(k) - 1;
      const int j0 = k % p;
      const int slots = C - k > j0 ? ((C - k - j0 + 2 * k - 1) >> (log_k + 1)) << log_k : 0;
      for (int base = warp * kWarpSlots; base < slots; base += kBlockSlots * kSlotsInFlight) {
        int lo[kSlotsInFlight], hi[kSlotsInFlight];
        bool ok[kSlotsInFlight];
        float4 a[kSlotsInFlight], b[kSlotsInFlight];
#pragma unroll
        for (int u = 0; u < kSlotsInFlight; ++u) {
          const int t = base + u * kBlockSlots + group;
          lo[u] = j0 + ((t >> log_k) << (log_k + 1)) + (t & (k - 1));
          hi[u] = lo[u] + k;
          ok[u] = t < slots && hi[u] < C && (lo[u] >> block_shift) == (hi[u] >> block_shift);
          if (ok[u]) {
            a[u] = rows4[lo[u] * kRowLanes + sub];
            b[u] = rows4[hi[u] * kRowLanes + sub];
          }
        }
#pragma unroll
        for (int u = 0; u < kSlotsInFlight; ++u) {
          if (ok[u]) {
            rows4[lo[u] * kRowLanes + sub] = min4(a[u], b[u]);
            rows4[hi[u] * kRowLanes + sub] = max4(a[u], b[u]);
          }
        }
      }
      __syncthreads();
    }
  }

  if (warp == 0 && live) {
    const float* v = cols + lane;
    float acc = __fmul_rn(v[0], __ldg(w_row));
    for (int c = 1; c < C; ++c) {
      acc = __fadd_rn(acc, __fmul_rn(v[c * kSmemCols], __ldg(w_row + c)));
    }
    out[m] = acc;
  }
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
  robust_kernel_smem<<<blocks, kSmemCols * kSmemWarps, smem, stream>>>(x, mask, w_row, out, C,
                                                                       M);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Plain C entry point for ctypes: device pointers, the CUDA stream as a
// pointer; the return value is cudaGetLastError() after the launch.
extern "C" int robust_combine_f32(const void* x, const void* mask, const void* w_row,
                                  void* out, int C, long long M, void* stream) {
  if (C < 1 || C > kMaxSmemC || M <= 0) return static_cast<int>(cudaErrorInvalidValue);
  const auto* x_ = static_cast<const float*>(x);
  const auto* mask_ = static_cast<const float*>(mask);
  const auto* w_ = static_cast<const float*>(w_row);
  auto* out_ = static_cast<float*>(out);
  const auto M_ = static_cast<int64_t>(M);
  const auto st = static_cast<cudaStream_t>(stream);
  if (C > kMaxPadC) return launch_smem(x_, mask_, w_, out_, C, M_, st);
  if (C > kMaxC) return dispatch_padded(x_, mask_, w_, out_, C, M_, st);
  const bool vec_ok = (M % 4 == 0) && (reinterpret_cast<uintptr_t>(x) % 16 == 0) &&
                      (reinterpret_cast<uintptr_t>(out) % 16 == 0);
  return dispatch(C, x_, mask_, w_, out_, M_, vec_ok, st, std::make_integer_sequence<int, kMaxC>{});
}

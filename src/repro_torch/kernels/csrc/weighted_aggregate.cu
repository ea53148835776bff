// Score-weighted reduction of C stacked client models (Algorithm 1, line 14):
//
//     out[m] = sum_c w[c] * x[c, m]      x [C, M] f32 or bf16, w [C] f32
//
// accumulated in fp32, in c order, and cast once to x's dtype.
//
// Replaces the Pallas TPU kernel
// src/repro/kernels/weighted_aggregate/kernel.py:weighted_aggregate_pallas.
//
// Bound on Hopper: memory. The kernel must read every x element once and
// write every output once, (C + 1) * M * itemsize bytes (plus 4C for w),
// while it does 2 * C * M flops -- about 0.5 flop a byte in fp32, far below
// the ~20 flop/byte at which an H100's fp32 units, not HBM, would limit it.
// So the least time is (C + 1) * M * itemsize / HBM bandwidth: 0.00473 ms
// for a round of fedtest-cnn (C=20, 188,810 f32 params in 10 leaves) and
// 0.10517 ms at M=2^22 on an H100 SXM (3.35 TB/s). Measured (chip_smoke.py,
// CUDA-graph replay over copies of the inputs that fill the L2 four times,
// so that they come from HBM; one NVIDIA H100 80GB HBM3 at a 700 W power
// limit): a round in one grouped launch 0.0080 ms, 1.7x the bound (ten
// launches took 0.0356 with the round's 15 MB left in L2; ten torch.mv
// calls take 0.040), and M=2^22 0.116 ms, 90 % of the bound; what keeps
// the round's launch further from its bound is not measured. Eager, a
// round takes about 0.24 ms of host work (the tree walk, the plan, the
// ctypes call).
//
// Design: the TPU kernel streams [C, block_m] tiles through VMEM on a
// sequential grid. Here a 1-D grid covers M instead. A round reduces a
// whole param tree, ten leaves for fedtest-cnn, each a few microseconds of
// device time, so one launch a leaf leaves the card waiting on the host.
// The grouped entry point reduces up to kMaxLeaves leaves in one launch:
// a leaf table (x and out pointers, M, the leaf's first block, the columns
// a thread takes) travels by value as a kernel parameter, so nothing is
// copied from the host per call and the launch can be captured in a CUDA
// graph; a tree with more leaves takes one launch per table
// (weighted_aggregate/ops.py:plan_launches). A block finds its leaf by a
// binary search over the table's block prefix, and every block lies in one
// leaf. Where a leaf's M is a multiple of VEC and both of its pointers are
// 16-byte aligned, a thread owns VEC consecutive columns (16 bytes of one
// row) and walks the C rows with an fp32 FMA accumulator per column:
// neighbouring threads read neighbouring 16-byte chunks, so each row access
// of a warp is one coalesced 512-byte segment. Otherwise a thread owns one
// column and issues its C loads 8 at a time into registers before the
// FMAs, so the loads of a batch are in flight together, not one
// load-then-FMA at a time; the FMAs still run in c order, so each output is
// bitwise what the vector path, and the one-array entry points, give: the
// one-array kernel runs the same per-thread code on plain parameters.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kMaxLeaves = 64;  // leaves one launch's table holds (ops.py: TABLE)
constexpr int kBatch = 8;       // loads a thread of the scalar path keeps in flight

struct F32 {
  using T = float;
  static constexpr int VEC = 4;
  __device__ static void load(const float* p, float (&f)[VEC]) {
    const float4 v = __ldg(reinterpret_cast<const float4*>(p));
    f[0] = v.x; f[1] = v.y; f[2] = v.z; f[3] = v.w;
  }
  __device__ static void store(float* p, const float (&f)[VEC]) {
    *reinterpret_cast<float4*>(p) = make_float4(f[0], f[1], f[2], f[3]);
  }
  __device__ static float get(const float* p) { return __ldg(p); }
  __device__ static void put(float* p, float v) { *p = v; }
};

struct BF16 {
  using T = __nv_bfloat16;
  static constexpr int VEC = 8;
  // a bf16 is the high half of the f32 with the same bits, so widening is
  // a shift; each 32-bit word holds elements 2i (low half) and 2i+1 (high)
  __device__ static void load(const T* p, float (&f)[VEC]) {
    const uint4 r = __ldg(reinterpret_cast<const uint4*>(p));
    const unsigned u[4] = {r.x, r.y, r.z, r.w};
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      f[2 * i] = __uint_as_float(u[i] << 16);
      f[2 * i + 1] = __uint_as_float(u[i] & 0xffff0000u);
    }
  }
  __device__ static unsigned bits(float v) {
    // round to nearest even, as torch's float -> bfloat16 cast does
    return static_cast<unsigned>(__bfloat16_as_ushort(__float2bfloat16_rn(v)));
  }
  __device__ static void store(T* p, const float (&f)[VEC]) {
    unsigned u[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) u[i] = bits(f[2 * i]) | (bits(f[2 * i + 1]) << 16);
    *reinterpret_cast<uint4*>(p) = make_uint4(u[0], u[1], u[2], u[3]);
  }
  __device__ static float get(const T* p) { return __bfloat162float(*p); }
  __device__ static void put(T* p, float v) { *p = __float2bfloat16_rn(v); }
};

// The leaves of one launch, passed by value (2,056 bytes of the 4 KB a
// kernel's parameters may take). Leaf i owns blocks first_block[i] ..
// first_block[i + 1] - 1; its threads take VEC columns each where vec[i],
// else one.
struct LeafTable {
  const void* x[kMaxLeaves];
  void* out[kMaxLeaves];
  long long M[kMaxLeaves];
  int first_block[kMaxLeaves + 1];
  int vec[kMaxLeaves];
  int n;
};

// The columns of one leaf that thread t owns: VEC consecutive ones where
// vec (16-byte loads), else column t alone, its C loads issued kBatch at a
// time; either way each column's FMAs run in c order.
template <typename K>
__device__ __forceinline__ void reduce_columns(const typename K::T* __restrict__ x,
                                               typename K::T* __restrict__ out, int64_t M,
                                               bool vec, int64_t t, const float* __restrict__ w,
                                               int C) {
  constexpr int VEC = K::VEC;
  if (vec) {
    const int64_t m0 = t * VEC;
    if (m0 >= M) return;
    float acc[VEC];
#pragma unroll
    for (int j = 0; j < VEC; ++j) acc[j] = 0.0f;
    const typename K::T* col = x + m0;
#pragma unroll 4
    for (int c = 0; c < C; ++c) {
      const float wc = __ldg(w + c);
      float v[VEC];
      K::load(col + static_cast<int64_t>(c) * M, v);
#pragma unroll
      for (int j = 0; j < VEC; ++j) acc[j] = fmaf(wc, v[j], acc[j]);
    }
    K::store(out + m0, acc);
    return;
  }
  if (t >= M) return;
  const typename K::T* col = x + t;
  float acc = 0.0f;
  int c = 0;
  for (; c + kBatch <= C; c += kBatch) {
    float v[kBatch];
#pragma unroll
    for (int u = 0; u < kBatch; ++u) v[u] = K::get(col + static_cast<int64_t>(c + u) * M);
#pragma unroll
    for (int u = 0; u < kBatch; ++u) acc = fmaf(__ldg(w + c + u), v[u], acc);
  }
  for (; c < C; ++c) acc = fmaf(__ldg(w + c), K::get(col + static_cast<int64_t>(c) * M), acc);
  K::put(out + t, acc);
}

// one array
template <typename K>
__global__ void __launch_bounds__(kThreads)
wagg_kernel(const typename K::T* __restrict__ x, const float* __restrict__ w,
            typename K::T* __restrict__ out, int C, int64_t M, bool vec) {
  reduce_columns<K>(x, out, M, vec, static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x,
                    w, C);
}

// the leaves of a table
template <typename K>
__global__ void __launch_bounds__(kThreads)
wagg_group_kernel(const LeafTable table, const float* __restrict__ w, int C) {
  // the leaf of this block: the last i with first_block[i] <= blockIdx.x
  const int blk = static_cast<int>(blockIdx.x);
  int lo = 0, hi = table.n - 1;
  while (lo < hi) {
    const int mid = (lo + hi + 1) / 2;
    if (table.first_block[mid] <= blk) lo = mid; else hi = mid - 1;
  }
  reduce_columns<K>(static_cast<const typename K::T*>(table.x[lo]),
                    static_cast<typename K::T*>(table.out[lo]), table.M[lo], table.vec[lo],
                    static_cast<int64_t>(blk - table.first_block[lo]) * kThreads + threadIdx.x,
                    w, C);
}

template <typename K>
int launch_group(const void* const* x, void* const* out, const long long* M,
                 const int* unit, const int* first_block, int n, const void* w, int C,
                 void* stream) {
  if (n < 1 || n > kMaxLeaves || C <= 0) return static_cast<int>(cudaErrorInvalidValue);
  LeafTable table{};
  table.n = n;
  for (int i = 0; i < n; ++i) {
    const bool vec = unit[i] == K::VEC;
    const long long blocks = first_block[i + 1] - first_block[i];
    if (M[i] <= 0 || (unit[i] != 1 && !vec) || blocks <= 0 ||
        (blocks - 1) * kThreads * unit[i] >= M[i] || blocks * kThreads * unit[i] < M[i] ||
        (vec && (M[i] % K::VEC != 0 || reinterpret_cast<uintptr_t>(x[i]) % 16 != 0 ||
                 reinterpret_cast<uintptr_t>(out[i]) % 16 != 0)))
      return static_cast<int>(cudaErrorInvalidValue);
    table.x[i] = x[i];
    table.out[i] = out[i];
    table.M[i] = M[i];
    table.vec[i] = vec;
    table.first_block[i] = first_block[i];
  }
  table.first_block[n] = first_block[n];
  if (first_block[0] != 0) return static_cast<int>(cudaErrorInvalidValue);
  wagg_group_kernel<K><<<static_cast<unsigned>(first_block[n]), kThreads, 0,
                         static_cast<cudaStream_t>(stream)>>>(
      table, static_cast<const float*>(w), C);
  return static_cast<int>(cudaGetLastError());
}

// one array: its own kernel, the columns a thread takes chosen as
// plan_launches chooses them
template <typename K>
int launch_one(const void* x, const void* w, void* out, int C, long long M, void* stream) {
  if (C <= 0 || M <= 0) return static_cast<int>(cudaErrorInvalidValue);
  const bool vec = (M % K::VEC == 0) &&
                   (reinterpret_cast<uintptr_t>(x) % 16 == 0) &&
                   (reinterpret_cast<uintptr_t>(out) % 16 == 0);
  const long long blocks = ((vec ? M / K::VEC : M) + kThreads - 1) / kThreads;
  if (blocks > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  wagg_kernel<K><<<static_cast<unsigned>(blocks), kThreads, 0,
                   static_cast<cudaStream_t>(stream)>>>(
      static_cast<const typename K::T*>(x), static_cast<const float*>(w),
      static_cast<typename K::T*>(out), C, static_cast<int64_t>(M), vec);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Plain C entry points for ctypes: device pointers, the CUDA stream as a
// pointer; the return value is cudaGetLastError() after the launch.
extern "C" int weighted_aggregate_f32(const void* x, const void* w, void* out,
                                      int C, long long M, void* stream) {
  return launch_one<F32>(x, w, out, C, M, stream);
}

extern "C" int weighted_aggregate_bf16(const void* x, const void* w, void* out,
                                       int C, long long M, void* stream) {
  return launch_one<BF16>(x, w, out, C, M, stream);
}

// n <= 64 leaves of one dtype and one C in one launch: host arrays of the
// leaves' x and out pointers, M, columns a thread (VEC or 1) and the block
// prefix (n + 1 entries, from 0), as plan_launches builds them.
extern "C" int weighted_aggregate_group_f32(const void* const* x, void* const* out,
                                            const long long* M, const int* unit,
                                            const int* first_block, int n, const void* w,
                                            int C, void* stream) {
  return launch_group<F32>(x, out, M, unit, first_block, n, w, C, stream);
}

extern "C" int weighted_aggregate_group_bf16(const void* const* x, void* const* out,
                                             const long long* M, const int* unit,
                                             const int* first_block, int n, const void* w,
                                             int C, void* stream) {
  return launch_group<BF16>(x, out, M, unit, first_block, n, w, C, stream);
}

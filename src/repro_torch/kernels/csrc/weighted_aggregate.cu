// Score-weighted reduction of C stacked client models (Algorithm 1, line 14):
//
//     out[m] = sum_c w[c] * x[c, m]      x [C, M] f32 or bf16, w [C] f32
//
// accumulated in fp32 and cast once to x's dtype.
//
// Replaces the Pallas TPU kernel
// src/repro/kernels/weighted_aggregate/kernel.py:weighted_aggregate_pallas.
//
// Bound on Hopper: memory. The kernel must read every x element once and
// write every output once, (C + 1) * M * itemsize bytes (plus 4C for w),
// while it does 2 * C * M flops -- about 0.5 flop a byte in fp32, far below
// the ~20 flop/byte at which an H100's fp32 units, not HBM, would limit it.
// So the least time is (C + 1) * M * itemsize / HBM bandwidth.
//
// Design: the TPU kernel streams [C, block_m] tiles through VMEM on a
// sequential grid. Here a 1-D grid covers M instead; each thread owns VEC
// consecutive columns (16 bytes of one row) and walks the C rows with an fp32
// FMA accumulator per column, so no partial sum ever leaves registers and no
// second pass is needed. Neighbouring threads read neighbouring 16-byte
// chunks, so each row access of a warp is one coalesced 512-byte segment, and
// every x element is read exactly once. The 16-byte loads need every row to
// start 16-byte aligned: that holds when M is a multiple of VEC and x is
// 16-byte aligned. Otherwise, and for the ragged last VEC columns, the thread
// uses scalar loads. The weights are read through the read-only cache; they
// stay on the device, so a launch never waits on the host.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;

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

template <typename K>
__global__ void __launch_bounds__(kThreads)
wagg_kernel(const typename K::T* __restrict__ x, const float* __restrict__ w,
            typename K::T* __restrict__ out, int C, int64_t M, bool vec_ok) {
  constexpr int VEC = K::VEC;
  const int64_t m0 = (static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x) * VEC;
  if (m0 >= M) return;
  float acc[VEC];
#pragma unroll
  for (int j = 0; j < VEC; ++j) acc[j] = 0.0f;

  if (vec_ok && m0 + VEC <= M) {
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

  const int n = static_cast<int>(M - m0 < VEC ? M - m0 : VEC);
  for (int c = 0; c < C; ++c) {
    const float wc = __ldg(w + c);
    const typename K::T* row = x + static_cast<int64_t>(c) * M + m0;
    for (int j = 0; j < n; ++j) acc[j] = fmaf(wc, K::get(row + j), acc[j]);
  }
  for (int j = 0; j < n; ++j) K::put(out + m0 + j, acc[j]);
}

template <typename K>
int launch(const void* x, const void* w, void* out, int C, long long M, void* stream) {
  if (C <= 0 || M <= 0) return static_cast<int>(cudaErrorInvalidValue);
  const bool vec_ok = (M % K::VEC == 0) &&
                      (reinterpret_cast<uintptr_t>(x) % 16 == 0) &&
                      (reinterpret_cast<uintptr_t>(out) % 16 == 0);
  const long long threads_needed = (M + K::VEC - 1) / K::VEC;
  const unsigned blocks = static_cast<unsigned>((threads_needed + kThreads - 1) / kThreads);
  wagg_kernel<K><<<blocks, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const typename K::T*>(x), static_cast<const float*>(w),
      static_cast<typename K::T*>(out), C, static_cast<int64_t>(M), vec_ok);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Plain C entry points for ctypes: device pointers, the CUDA stream as a
// pointer; the return value is cudaGetLastError() after the launch.
extern "C" int weighted_aggregate_f32(const void* x, const void* w, void* out,
                                      int C, long long M, void* stream) {
  return launch<F32>(x, w, out, C, M, stream);
}

extern "C" int weighted_aggregate_bf16(const void* x, const void* w, void* out,
                                       int C, long long M, void* stream) {
  return launch<BF16>(x, w, out, C, M, stream);
}

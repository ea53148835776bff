// Fused int8 dequantise + score-weighted reduction of C compressed client
// updates (the int8 compressor's server step, Int8.aggregate):
//
//     out[m] = sum_c w[c] * (float(q[c, m]) * scales[c, m / chunk])
//     q [C, M] int8, scales [C, M / chunk] f32, w [C] f32 -> [M] f32
//
// The dequantised f32 [C, M] stack is never written: each code is widened,
// scaled and accumulated in registers.
//
// Replaces the Pallas TPU kernel
// src/repro/kernels/dequant_aggregate/kernel.py:dequant_aggregate_pallas.
//
// Bound on Hopper: memory. The kernel must read C * M code bytes and
// 4 * C * M / chunk scale bytes and write 4 * M output bytes (at C=20,
// chunk 256: 24.3 bytes a column) while it does a convert, a multiply and
// a multiply-add per code (60 operations a column at C=20, 2.5 a byte),
// far below the ~20 operations a byte at which an H100's fp32 units, not
// HBM, would limit it.
//
// Design: the TPU kernel streams [C, block_m] int8 tiles with their scale
// columns through VMEM. Here a 1-D grid covers M and a thread owns VEC
// consecutive columns, all inside one chunk and so under one scale: one
// VEC-byte load of codes a row, VEC f32 accumulators. Neighbouring threads
// read neighbouring bytes, so a warp's row access is one 32 * VEC-byte
// segment. What holds the kernel is the bytes in flight: HBM needs about
// 2 MB of loads outstanding across the card to reach its rate, and at path
// C's M = 188,928 a grid of 16 columns a thread has 11,808 threads in 46
// blocks on 132 SMs. So VEC is picked from M and the SM count: 16 columns
// (16-byte loads) where that grid still covers the SMs twice over, else 4
// (4-byte loads, 128 bytes a warp row; 185 blocks at M = 188,928). Either
// way the C loop issues kInFlight rows of loads before it uses them, 8
// loads a thread outstanding. Where the chunk is not a multiple of VEC or
// q is not VEC-byte aligned the narrower width is taken, and where neither
// fits (a misaligned view) a thread owns one column and computes its chunk
// index itself. Codes are read as signed bytes and sign-extended. The order
// of the arithmetic is the reference's: dec = float(q) * scale, rounded,
// then an f32 multiply-add with w[c] over c = 0..C-1.
// Measured (chip_smoke.py, CUDA-graph replay, inputs from HBM, one NVIDIA
// H100 80GB HBM3 at a 700 W power limit; PERF.md section 6): path C's
// [20, 188,928] 0.0051 ms (16 columns a thread at every M: 0.0126),
// M = 2^22 0.0383 ms (0.0453).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kInFlight = 8;  // rows of codes loaded before the first is used
constexpr int kWideWaves = 2;  // 16 columns a thread where the grid covers the SMs this often

// byte k (0 = lowest address) of a little-endian word, as a signed code
__device__ __forceinline__ float code(uint32_t word, int k) {
  return static_cast<float>(static_cast<int32_t>(word << (24 - 8 * k)) >> 24);
}

template <int VEC> struct Codes;  // VEC codes as 32-bit words
template <> struct Codes<4> {
  uint32_t u[1];
  __device__ __forceinline__ void load(const int8_t* p) {
    u[0] = __ldg(reinterpret_cast<const unsigned int*>(p));
  }
};
template <> struct Codes<16> {
  uint32_t u[4];
  __device__ __forceinline__ void load(const int8_t* p) {
    const uint4 r = __ldg(reinterpret_cast<const uint4*>(p));
    u[0] = r.x; u[1] = r.y; u[2] = r.z; u[3] = r.w;
  }
};

template <int VEC>
__global__ void __launch_bounds__(kThreads)
dqagg_vec_kernel(const float* __restrict__ w, const float* __restrict__ scales,
                 const int8_t* __restrict__ q, float* __restrict__ out, int C, int64_t M,
                 int chunk) {
  const int64_t m0 = (static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x) * VEC;
  if (m0 >= M) return;  // M % VEC == 0: a thread's columns all exist
  const int64_t nchunks = M / chunk;
  const int64_t ch = m0 / chunk;
  float acc[VEC];
#pragma unroll
  for (int j = 0; j < VEC; ++j) acc[j] = 0.0f;
  for (int c0 = 0; c0 < C; c0 += kInFlight) {
    Codes<VEC> r[kInFlight];
    float s[kInFlight], wc[kInFlight];
#pragma unroll
    for (int u = 0; u < kInFlight; ++u) {
      const int c = c0 + u;
      if (c < C) {
        r[u].load(q + static_cast<int64_t>(c) * M + m0);
        s[u] = __ldg(scales + static_cast<int64_t>(c) * nchunks + ch);
        wc[u] = __ldg(w + c);
      }
    }
#pragma unroll
    for (int u = 0; u < kInFlight; ++u) {
      if (c0 + u < C) {
#pragma unroll
        for (int i = 0; i < VEC / 4; ++i) {
#pragma unroll
          for (int k = 0; k < 4; ++k) {
            acc[4 * i + k] = fmaf(wc[u], __fmul_rn(code(r[u].u[i], k), s[u]), acc[4 * i + k]);
          }
        }
      }
    }
  }
  float4* o = reinterpret_cast<float4*>(out + m0);
#pragma unroll
  for (int i = 0; i < VEC / 4; ++i) {
    o[i] = make_float4(acc[4 * i], acc[4 * i + 1], acc[4 * i + 2], acc[4 * i + 3]);
  }
}

__global__ void __launch_bounds__(kThreads)
dqagg_scalar_kernel(const float* __restrict__ w, const float* __restrict__ scales,
                    const int8_t* __restrict__ q, float* __restrict__ out, int C, int64_t M,
                    int chunk) {
  const int64_t m = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x;
  if (m >= M) return;
  const int64_t nchunks = M / chunk;
  const int64_t ch = m / chunk;
  float acc = 0.0f;
#pragma unroll 4
  for (int c = 0; c < C; ++c) {
    const float dec = __fmul_rn(static_cast<float>(__ldg(q + static_cast<int64_t>(c) * M + m)),
                                __ldg(scales + static_cast<int64_t>(c) * nchunks + ch));
    acc = fmaf(__ldg(w + c), dec, acc);
  }
  out[m] = acc;
}

template <int VEC>
unsigned blocks_for(long long M) {
  return static_cast<unsigned>((M / VEC + kThreads - 1) / kThreads);
}

}  // namespace

// Plain C entry point for ctypes: device pointers, the CUDA stream as a
// pointer; the return value is cudaGetLastError() after the launch.
extern "C" int dequant_aggregate_f32(const void* w, const void* scales, const void* q,
                                     void* out, int C, long long M, int chunk,
                                     void* stream) {
  if (C <= 0 || M <= 0 || chunk <= 0 || M % chunk != 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  int device = 0, sms = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const auto* w_ = static_cast<const float*>(w);
  const auto* s_ = static_cast<const float*>(scales);
  const auto* q_ = static_cast<const int8_t*>(q);
  auto* out_ = static_cast<float*>(out);
  const auto st = static_cast<cudaStream_t>(stream);
  const auto q_at = reinterpret_cast<uintptr_t>(q);
  const bool out_ok = reinterpret_cast<uintptr_t>(out) % 16 == 0;
  if (out_ok && chunk % 16 == 0 && q_at % 16 == 0 &&
      blocks_for<16>(M) >= static_cast<unsigned>(kWideWaves * sms)) {
    const unsigned blocks = blocks_for<16>(M);
    dqagg_vec_kernel<16><<<blocks, kThreads, 0, st>>>(w_, s_, q_, out_, C, M, chunk);
  } else if (out_ok && chunk % 4 == 0 && q_at % 4 == 0) {
    const unsigned blocks = blocks_for<4>(M);
    dqagg_vec_kernel<4><<<blocks, kThreads, 0, st>>>(w_, s_, q_, out_, C, M, chunk);
  } else {
    const unsigned blocks = static_cast<unsigned>((M + kThreads - 1) / kThreads);
    dqagg_scalar_kernel<<<blocks, kThreads, 0, st>>>(w_, s_, q_, out_, C, M, chunk);
  }
  return static_cast<int>(cudaGetLastError());
}

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
// columns through VMEM. Here a 1-D grid covers M; where chunk % 16 == 0 and
// q and out are 16-byte aligned, a thread owns 16 consecutive columns: one
// 16-byte load of codes per row, all 16 inside one chunk and so under one
// scale, and 16 f32 accumulators. Neighbouring threads read neighbouring
// 16 bytes, so a warp's row access is one 512-byte segment. Otherwise (a
// chunk that is not a multiple of 16, a misaligned view) a thread owns one
// column and computes its chunk index itself. Codes are read as signed
// bytes and sign-extended. The order of the arithmetic is the reference's:
// dec = float(q) * scale, rounded, then an f32 multiply-add with w[c] over
// c = 0..C-1.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kVec = 16;

// byte k (0 = lowest address) of a little-endian word, as a signed code
__device__ __forceinline__ float code(uint32_t word, int k) {
  return static_cast<float>(static_cast<int32_t>(word << (24 - 8 * k)) >> 24);
}

__global__ void __launch_bounds__(kThreads)
dqagg_vec_kernel(const float* __restrict__ w, const float* __restrict__ scales,
                 const int8_t* __restrict__ q, float* __restrict__ out, int C, int64_t M,
                 int chunk) {
  const int64_t m0 = (static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x) * kVec;
  if (m0 >= M) return;  // M % 16 == 0: a thread's columns all exist
  const int64_t nchunks = M / chunk;
  const int64_t ch = m0 / chunk;
  float acc[kVec];
#pragma unroll
  for (int j = 0; j < kVec; ++j) acc[j] = 0.0f;
#pragma unroll 4
  for (int c = 0; c < C; ++c) {
    const uint4 r = __ldg(reinterpret_cast<const uint4*>(q + static_cast<int64_t>(c) * M + m0));
    const float s = __ldg(scales + static_cast<int64_t>(c) * nchunks + ch);
    const float wc = __ldg(w + c);
    const uint32_t u[4] = {r.x, r.y, r.z, r.w};
#pragma unroll
    for (int i = 0; i < 4; ++i) {
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        acc[4 * i + k] = fmaf(wc, __fmul_rn(code(u[i], k), s), acc[4 * i + k]);
      }
    }
  }
  float4* o = reinterpret_cast<float4*>(out + m0);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
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

}  // namespace

// Plain C entry point for ctypes: device pointers, the CUDA stream as a
// pointer; the return value is cudaGetLastError() after the launch.
extern "C" int dequant_aggregate_f32(const void* w, const void* scales, const void* q,
                                     void* out, int C, long long M, int chunk,
                                     void* stream) {
  if (C <= 0 || M <= 0 || chunk <= 0 || M % chunk != 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const auto* w_ = static_cast<const float*>(w);
  const auto* s_ = static_cast<const float*>(scales);
  const auto* q_ = static_cast<const int8_t*>(q);
  auto* out_ = static_cast<float*>(out);
  const auto st = static_cast<cudaStream_t>(stream);
  const bool vec_ok = (chunk % kVec == 0) && (reinterpret_cast<uintptr_t>(q) % 16 == 0) &&
                      (reinterpret_cast<uintptr_t>(out) % 16 == 0);
  if (vec_ok) {
    const long long threads_needed = M / kVec;
    const unsigned blocks = static_cast<unsigned>((threads_needed + kThreads - 1) / kThreads);
    dqagg_vec_kernel<<<blocks, kThreads, 0, st>>>(w_, s_, q_, out_, C, M, chunk);
  } else {
    const unsigned blocks = static_cast<unsigned>((M + kThreads - 1) / kThreads);
    dqagg_scalar_kernel<<<blocks, kThreads, 0, st>>>(w_, s_, q_, out_, C, M, chunk);
  }
  return static_cast<int>(cudaGetLastError());
}

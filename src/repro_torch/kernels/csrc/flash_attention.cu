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
// a little. This kernel does not reach either: it runs both products as
// scalar fp32 FMAs from shared memory (about 67 TFLOP/s at best), which
// makes it bound by those FMAs and the shared-memory loads that feed
// them. wgmma and TMA are later work.
//
// Design: the TPU kernel walks a sequential grid axis over KV blocks with
// (m, l, acc) in VMEM scratch. Here one block of 128 threads owns one
// (b, query head, 64-row query tile) and loops over 64-key tiles inside
// the block, so the online-softmax state stays in registers: thread
// (ty, tx) = (tid / 8, tid % 8) owns rows ty + 16 i (i < 4) and, for the
// scores, keys tx + 8 j (j < 8); for the output, columns tx + 8 j
// (j < D / 8). A row's scores live in the 8 lanes of one warp that share
// ty, so its max and sum are three xor-shuffles. Q, K, V tiles are read
// through their strides (no transpose to heads-major) into shared memory
// as f32, rows padded by one float so that the score loop's column reads
// fall in distinct banks; P goes through shared memory to the PV product.
// GQA is the KV head index h / (Hq / Hkv), any group size.
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

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kBQ = 64;        // query rows per block
constexpr int kBK = 64;        // keys per tile
constexpr int kThreads = 128;
constexpr int kRows = 4;       // rows per thread: ty + 16 i
constexpr int kCols = 8;       // score columns per thread: tx + 8 j
constexpr float kNegInf = -1e30f;

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

template <typename T>
int dispatch(int D, const void* q, const void* k, const void* v, void* o, int B, int S,
             int T_len, int Hq, int Hkv, const long long* st, float scale, int causal,
             int window, int q_offset, cudaStream_t stream) {
  switch (D) {
    case 32:
      return launch<T, 32>(q, k, v, o, B, S, T_len, Hq, Hkv, st, scale, causal, window,
                           q_offset, stream);
    case 64:
      return launch<T, 64>(q, k, v, o, B, S, T_len, Hq, Hkv, st, scale, causal, window,
                           q_offset, stream);
    case 128:
      return launch<T, 128>(q, k, v, o, B, S, T_len, Hq, Hkv, st, scale, causal, window,
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
extern "C" int flash_attention_f32(const void* q, const void* k, const void* v, void* o,
                                   int B, int S, int T_len, int Hq, int Hkv, int D,
                                   const long long* strides, float scale, int causal,
                                   int window, int q_offset, void* stream) {
  if (!valid_shape(B, S, T_len, Hq, Hkv)) return static_cast<int>(cudaErrorInvalidValue);
  return dispatch<float>(D, q, k, v, o, B, S, T_len, Hq, Hkv, strides, scale, causal, window,
                         q_offset, static_cast<cudaStream_t>(stream));
}

extern "C" int flash_attention_bf16(const void* q, const void* k, const void* v, void* o,
                                    int B, int S, int T_len, int Hq, int Hkv, int D,
                                    const long long* strides, float scale, int causal,
                                    int window, int q_offset, void* stream) {
  if (!valid_shape(B, S, T_len, Hq, Hkv)) return static_cast<int>(cudaErrorInvalidValue);
  return dispatch<__nv_bfloat16>(D, q, k, v, o, B, S, T_len, Hq, Hkv, strides, scale, causal,
                                 window, q_offset, static_cast<cudaStream_t>(stream));
}

// Shared by the rel-pos attention kernels (attention_relpos.cu and
// attention_relpos_bwd.cu): tile sizes, type conversions and the loaders
// that bring (rows, DH) tiles of the (B, T, H, dh) tensors and bands of the
// (2T-1, H, dh) rel-pos table into shared memory as float32.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace relpos {

constexpr int kBlockQ = 32;
constexpr int kBlockK = 32;
constexpr int kThreads = 256;  // 8 threads per tile row
constexpr int kBand = kBlockQ + kBlockK - 1;
constexpr float kMaskValue = -1e30f;

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) { return __bfloat162float(x); }
template <typename T>
__device__ __forceinline__ T from_float(float x);
template <>
__device__ __forceinline__ float from_float<float>(float x) { return x; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_float<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

// dst[r][d] = src[t0 + r] for r in [0, rows), zero where t0 + r lies outside
// [0, seq).  `base` points at (batch row, t = 0, head, d = 0); rows of dst
// are DH + 1 floats apart (against bank conflicts).
template <typename T, int DH>
__device__ __forceinline__ void load_rows(float* dst, const T* __restrict__ base, int t0, int rows,
                                          int seq, size_t time_stride, int tid) {
  for (int idx = tid; idx < rows * DH; idx += kThreads) {
    const int r = idx / DH;
    const int d = idx - r * DH;
    const int t = t0 + r;
    dst[r * (DH + 1) + d] = (t >= 0 && t < seq) ? to_float(base[t * time_stride + d]) : 0.f;
  }
}

// dst[r][d] = p[rel0 + r][head] for r in [0, rows), zero outside [0, n_rel).
template <typename T, int DH>
__device__ __forceinline__ void load_band(float* dst, const T* __restrict__ p, int rel0, int rows,
                                          int n_rel, int heads, int head, int tid) {
  for (int idx = tid; idx < rows * DH; idx += kThreads) {
    const int r = idx / DH;
    const int d = idx - r * DH;
    const int rel = rel0 + r;
    dst[r * (DH + 1) + d] =
        (rel >= 0 && rel < n_rel) ? to_float(p[(static_cast<size_t>(rel) * heads + head) * DH + d]) : 0.f;
  }
}

}  // namespace relpos

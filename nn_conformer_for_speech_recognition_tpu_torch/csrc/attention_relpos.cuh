// Shared by the rel-pos attention kernels (attention_relpos.cu,
// attention_relpos_bwd.cu, and for bfloat16 attention_relpos_tc.cu and
// attention_relpos_bwd_tc.cu): tile sizes, type conversions, the loaders
// that bring (rows, DH) tiles of the (B, T, H, dh) tensors and bands of the
// (2T-1, H, dh) rel-pos table into shared memory as float32 (the CUDA-core
// kernels), the arguments of a forward and of a backward launch, and the
// table gradient's batch sum.

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

// The arguments of one forward launch.  Layout: qu, qv, k, v, out (B, T, H,
// dh), p (2T-1, H, dh) and lse (B, H, T) float32, contiguous.
struct FwdArgs {
  const void *qu, *qv, *k, *v, *p;
  const int* lengths;
  void* out;
  float* lse;  // NULL: the inference variant, no lse store
  int batch, seq, heads;
  float scale;
  cudaStream_t stream;
};

// The arguments of one backward launch.  Layout: qu, qv, k, v, g (dO) and
// the gradients (B, T, H, dh), p and dp (2T-1, H, dh), lse and delta
// (B, H, T) float32, all contiguous.
struct BwdArgs {
  const void *qu, *qv, *k, *v, *p;
  const int* lengths;
  const void* g;
  const float *lse, *delta;
  void *out0, *out1;  // dq: dqu, dqv; dkv: dk, dv; dband: dp, float32 partials (B, 2T-1, H, dh)
  int batch, seq, heads;
  float scale;
  cudaStream_t stream;
};

// bfloat16 inputs: the tensor-core forward (attention_relpos_tc.cu) and the
// dq, dkv and dband kernels (attention_relpos_bwd_tc.cu)
cudaError_t fwd_tc(int head_dim, const FwdArgs& a);
cudaError_t bwd_dq_tc(int head_dim, const BwdArgs& a);
cudaError_t bwd_dkv_tc(int head_dim, const BwdArgs& a);
cudaError_t bwd_dband_tc(int head_dim, const BwdArgs& a);

constexpr int kReduceThreads = 256;

// dp[x] = sum over the batch rows' float32 partials, in order: the table
// gradient is the same bits from launch to launch, with no atomics.
template <typename T>
__global__ void __launch_bounds__(kReduceThreads)
dband_reduce_kernel(const float* __restrict__ partial, T* __restrict__ dp, int batch, size_t n) {
  const size_t x = static_cast<size_t>(blockIdx.x) * kReduceThreads + threadIdx.x;
  if (x >= n) return;
  float sum = 0.f;
  for (int b = 0; b < batch; ++b) sum += partial[b * n + x];
  dp[x] = from_float<T>(sum);
}

template <typename T>
cudaError_t launch_dband_reduce(const float* partial, T* dp, int batch, size_t n, cudaStream_t stream) {
  const unsigned blocks = static_cast<unsigned>((n + kReduceThreads - 1) / kReduceThreads);
  dband_reduce_kernel<T><<<blocks, kReduceThreads, 0, stream>>>(partial, dp, batch, n);
  return cudaGetLastError();
}

}  // namespace relpos

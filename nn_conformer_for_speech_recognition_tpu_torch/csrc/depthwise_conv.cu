// SAME-padded depthwise 1-D convolution, channels-last, for sm_90a.
//
// Replaces nn_conformer_for_speech_recognition_tpu/ops/pallas/depthwise_conv.py:
// _dw_kernel.  x (B, T, C), w (K, C) -> out (B, T, C):
//   out[b][t][c] = sum_i w[i][c] * x[b][t + i - pad_lo][c],  zeros outside [0, T)
// One block per (tile of kTileT rows, slab of kSlab channels, batch row).
// Threads lie along C, so every load and store of a warp is one contiguous
// run of channels.  The tile's (kTileT + K - 1) x kSlab halo is read once
// into shared memory as float32, zero-filled outside [0, T) (no padded copy
// of x in device memory, no transposes), beside the K x kSlab taps; each
// thread then slides the K taps over kReg outputs at a time in registers.
// Products and sums are float32; the output is rounded once to x's type.
// pad_lo is an argument: the gradient with respect to x is this same kernel
// on the incoming gradient with the taps reversed (reverse_taps) and
// pad_lo = K - 1 - (K - 1) / 2.  Bound on the H100: bytes (x read once, out
// written once; 2 * K operations an element are far below the float32
// rate); see ops/cuda/depthwise_conv.py.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kSlab = 128;      // channels per block: threadIdx.x
constexpr int kTileT = 64;      // output rows per block
constexpr int kRowGroups = 4;   // threadIdx.y: each group owns kTileT / kRowGroups rows
constexpr int kRows = kTileT / kRowGroups;
constexpr int kReg = 8;         // outputs a thread keeps in registers per pass

__device__ __forceinline__ float to_float(float v) { return v; }
__device__ __forceinline__ float to_float(__nv_bfloat16 v) { return __bfloat162float(v); }
__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) { *p = __float2bfloat16(v); }

template <typename T>
__global__ void depthwise_conv_kernel(const T* __restrict__ x, const T* __restrict__ w,
                                      T* __restrict__ out, int t, int c, int k, int pad_lo,
                                      int reverse_taps) {
  extern __shared__ float smem[];
  float* taps = smem;               // [k][kSlab]
  float* halo = smem + k * kSlab;   // [kTileT + k - 1][kSlab]

  const int lane = threadIdx.x;
  const int ch = blockIdx.y * kSlab + lane;
  const bool has = ch < c;
  const int t0 = blockIdx.x * kTileT;
  const size_t row0 = static_cast<size_t>(blockIdx.z) * t;

  for (int i = threadIdx.y; i < k; i += kRowGroups) {
    const int src = reverse_taps ? k - 1 - i : i;
    taps[i * kSlab + lane] = has ? to_float(w[static_cast<size_t>(src) * c + ch]) : 0.f;
  }
  const int rows = kTileT + k - 1;
  for (int r = threadIdx.y; r < rows; r += kRowGroups) {
    const int src = t0 + r - pad_lo;
    float v = 0.f;
    if (has && src >= 0 && src < t) v = to_float(x[(row0 + src) * c + ch]);
    halo[r * kSlab + lane] = v;
  }
  __syncthreads();

  const int first = threadIdx.y * kRows;
  for (int base = first; base < first + kRows && t0 + base < t; base += kReg) {
    float acc[kReg];
#pragma unroll
    for (int r = 0; r < kReg; ++r) acc[r] = 0.f;
    for (int i = 0; i < k; ++i) {
      const float wi = taps[i * kSlab + lane];
#pragma unroll
      for (int r = 0; r < kReg; ++r) acc[r] = fmaf(wi, halo[(base + r + i) * kSlab + lane], acc[r]);
    }
    if (!has) continue;
#pragma unroll
    for (int r = 0; r < kReg; ++r) {
      const int row = t0 + base + r;
      if (row < t) store(out + (row0 + row) * c + ch, acc[r]);
    }
  }
}

template <typename T>
int launch(const void* x, const void* w, void* out, int batch, int t, int c, int k, int pad_lo,
           int reverse_taps, cudaStream_t stream) {
  const size_t smem = sizeof(float) * kSlab * (static_cast<size_t>(k) + kTileT + k - 1);
  if (smem > 227 * 1024) return cudaErrorInvalidValue;
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        depthwise_conv_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (err != cudaSuccess) return err;
  }
  const dim3 grid((t + kTileT - 1) / kTileT, (c + kSlab - 1) / kSlab, batch);
  const dim3 block(kSlab, kRowGroups);
  depthwise_conv_kernel<T><<<grid, block, smem, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(w), static_cast<T*>(out), t, c, k, pad_lo,
      reverse_taps);
  return cudaGetLastError();
}

}  // namespace

extern "C" int depthwise_conv_fwd(const void* x, const void* w, void* out, int batch, int t, int c,
                                  int k, int pad_lo, int reverse_taps, int is_bf16, void* stream) {
  if (batch > 65535) return cudaErrorInvalidValue;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (is_bf16) return launch<__nv_bfloat16>(x, w, out, batch, t, c, k, pad_lo, reverse_taps, s);
  return launch<float>(x, w, out, batch, t, c, k, pad_lo, reverse_taps, s);
}

// Fused centered STFT -> power -> mel -> log for sm_90a.
//
// Replaces nn_conformer_for_speech_recognition_tpu/ops/pallas/stft_logmel.py:
// _stft_logmel_kernel.  One block per (tile of kFrames frames, batch row):
//   frames[f][n] = window[n] * audio[reflect(t*hop + n - n_fft/2)]   (shared)
//   re, im      = frames @ dft_re, frames @ dft_im     (one bin per thread)
//   power[f][k] = re^2 + im^2                                        (shared)
//   out[t][m]   = log(max(sum_k power[f][k] * mel_fb[k][m], log_floor))
// All sums in float32.  Bound on the H100: each block streams both DFT
// bases from L2 once per kFrames frames; see ops/cuda/stft_logmel.py.

#include <cuda_runtime.h>

namespace {

constexpr int kFrames = 8;

// numpy/torch 'reflect' padding (the edge sample is not repeated); valid for
// -n < i < 2n - 1, which the launcher guarantees by requiring n > n_fft/2.
__device__ __forceinline__ int reflect_index(int i, int n) {
  if (i < 0) i = -i;
  if (i >= n) i = 2 * (n - 1) - i;
  return i;
}

__global__ void stft_logmel_kernel(const float* __restrict__ audio,
                                   const float* __restrict__ window,
                                   const float* __restrict__ dft_re,
                                   const float* __restrict__ dft_im,
                                   const float* __restrict__ mel_fb,
                                   float* __restrict__ out, int samples,
                                   int n_fft, int hop, int n_frames,
                                   int n_bins, int n_mels, float log_floor) {
  extern __shared__ float smem[];
  float* frames = smem;                    // [kFrames][n_fft]
  float* power = smem + kFrames * n_fft;   // [kFrames][n_bins]

  const int b = blockIdx.y;
  const int t0 = blockIdx.x * kFrames;
  const float* x = audio + static_cast<size_t>(b) * samples;
  const int pad = n_fft / 2;

  for (int idx = threadIdx.x; idx < kFrames * n_fft; idx += blockDim.x) {
    const int f = idx / n_fft;
    const int n = idx - f * n_fft;
    float val = 0.f;
    if (t0 + f < n_frames) {
      val = x[reflect_index((t0 + f) * hop + n - pad, samples)] * window[n];
    }
    frames[idx] = val;
  }
  __syncthreads();

  for (int k = threadIdx.x; k < n_bins; k += blockDim.x) {
    float re[kFrames], im[kFrames];
#pragma unroll
    for (int f = 0; f < kFrames; ++f) re[f] = im[f] = 0.f;
    for (int n = 0; n < n_fft; ++n) {
      const float c = __ldg(dft_re + n * n_bins + k);
      const float s = __ldg(dft_im + n * n_bins + k);
#pragma unroll
      for (int f = 0; f < kFrames; ++f) {
        const float v = frames[f * n_fft + n];
        re[f] = fmaf(v, c, re[f]);
        im[f] = fmaf(v, s, im[f]);
      }
    }
#pragma unroll
    for (int f = 0; f < kFrames; ++f) power[f * n_bins + k] = re[f] * re[f] + im[f] * im[f];
  }
  __syncthreads();

  for (int idx = threadIdx.x; idx < kFrames * n_mels; idx += blockDim.x) {
    const int f = idx / n_mels;
    const int m = idx - f * n_mels;
    if (t0 + f >= n_frames) continue;
    float acc = 0.f;
    for (int k = 0; k < n_bins; ++k) acc = fmaf(power[f * n_bins + k], __ldg(mel_fb + k * n_mels + m), acc);
    out[(static_cast<size_t>(b) * n_frames + t0 + f) * n_mels + m] = logf(fmaxf(acc, log_floor));
  }
}

}  // namespace

extern "C" int stft_logmel_fwd(const float* audio, const float* window,
                               const float* dft_re, const float* dft_im,
                               const float* mel_fb, float* out, int batch,
                               int samples, int n_fft, int hop, int n_frames,
                               int n_bins, int n_mels, float log_floor,
                               void* stream) {
  const size_t smem = sizeof(float) * kFrames * (n_fft + n_bins);
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        stft_logmel_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (err != cudaSuccess) return err;
  }
  int threads = ((n_bins + 31) / 32) * 32;
  if (threads > 1024) threads = 1024;
  const dim3 grid((n_frames + kFrames - 1) / kFrames, batch);
  stft_logmel_kernel<<<grid, threads, smem, static_cast<cudaStream_t>(stream)>>>(
      audio, window, dft_re, dft_im, mel_fb, out, samples, n_fft, hop, n_frames, n_bins, n_mels,
      log_floor);
  return cudaGetLastError();
}

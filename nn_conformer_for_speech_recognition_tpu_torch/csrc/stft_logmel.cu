// Fused centered STFT -> power -> mel -> log for sm_90a, the DFT on the
// tensor cores.
//
// Replaces nn_conformer_for_speech_recognition_tpu/ops/pallas/stft_logmel.py:
// _stft_logmel_kernel.  Per frame t of batch row b:
//   x[n]     = window[n] * audio[b][reflect(t*hop + n - n_fft/2)]
//   (re, im) = the real DFT of x
//   out[m]   = log(max(sum over mel m's band of (re^2 + im^2) * mel_fb, log_floor))
//
// What bounds it: the DFT's products, and feeding them.  The log of a power
// needs float32's accuracy, which one TF32 pass does not keep, so they run
// on mma.sync m16n8k8 TF32 in three passes (a_big*b_big + a_big*b_small +
// a_small*b_big), each operand split into its two TF32 halves here.  The
// design halves the products: the frame is folded over its mirror samples
// in shared memory,
//   v[p] = x[p] + x[n-p],  v[n-p] = x[n-p] - x[p]     (0 < p < n - p)
// so that re_k = v[0] + sum_{p=1..n/2} v[p] cos(2 pi p k/n) and
// im_k = sum_{p>n/2} v[p] (-sin(2 pi p k/n)): two GEMMs of K = n/2 over the
// bins, not one of K = n over twice the bins.  The even n's Nyquist bin
// (sum_p (-1)^p v[p], p <= n/2) is summed on the CUDA cores, and only where
// a mel weighs it.
//
// A block holds a tile of frames in shared memory (64 or 32 frames under 16
// warps, 16 or 8 under 8: the largest whose rows fit and that still gives
// every SM a block, so a short batch takes more, smaller blocks) and
// streams the folded float32 basis (ops/features.py::kernel_constants)
// through them once, from L2: 128-row stages (64 at 8 frames) of a
// two-stage cp.async ring, 64 bins a pass, the cosine rows then the sine
// rows.  Few, long stages matter: each
// stage ends in a block barrier that drains the warps' product chains
// (PERF.md).  Each stage's products start from fresh float32 sums that are
// then added to the running ones: the tensor cores' own adds drop a sum's
// low bits, which across all of K cost ~1e-5 of the log-mel.  A lane's
// cosine and sine accumulators hold the same (frame, bin), so the power
// forms in registers.  Power and mel never reach device memory: each pass's
// power goes to shared memory and is added into the block's mel sums in
// registers over each mel's band of bins only (the nonzeros of the
// filterbank, from the host), in a fixed order, so the output is bit-equal
// from launch to launch.  A block sums up to 128 mels; grid.y takes the
// next 128, doing the DFT again.  Interior frames are read with 16-byte
// copies where the source is aligned, the reflected edges and unaligned
// hops 4 bytes at a time, in the same kernel.

#include <cuda_runtime.h>

#include <cstdint>

#include "tensor_core.cuh"

namespace {

using tc::cp_async16;
using tc::cp_async4;
using tc::cp_async_commit;
using tc::cp_async_wait;
using tc::mma_tf32;

constexpr int kKTile = 128;                    // the basis's rows come padded to a multiple of it
constexpr int kStages = 2;                     // ring stages: the next stage loads while this one is used
constexpr int kSumRows = 32;                   // basis rows whose products a fresh float32 sum takes
constexpr int kBins = 64;                      // bins a pass
constexpr int kLdB = kBins + 8;                // = 8 (mod 32): a B fragment's loads hit 32 banks
constexpr int kLdP = kBins + 1;                // a frame's power in a pass
constexpr int kMaxMels = 128;                  // mels a block; grid.y covers the rest
constexpr int kSmemBytes = 227 * 1024 - 2048;  // the dynamic shared memory a block may opt into, less the static

// A frame's row in shared memory: the sine rows read columns up to
// n_fft / 2 + k_half, and the end stages the log-mel rows through it; = 4 (mod 32)
__host__ __device__ constexpr int frame_stride(int n_fft, int k_half) {
  const int need = n_fft > n_fft / 2 + k_half + 1 ? n_fft : n_fft / 2 + k_half + 1;
  const int lda = (need + 27) / 32 * 32 + 4;
  return lda > kMaxMels + 4 ? lda : kMaxMels + 4;
}

// A block's tile: THREADS / 32 warps, each MI m16 tiles of frames by NI n8 tiles of bins; the warps stand
// kBins / (8 NI) along the bins, the rest along the frames; a ring stage holds KCHUNK basis rows.  FRAMES = 8
// (rows too long for 16 frames in shared memory) fills the top half of the one m16 tile: its bottom half
// repeats those frames, and their products are dropped
template <int MI, int NI, int THREADS, int KCHUNK = kKTile, int FRAMES = THREADS / 32 / (kBins / (8 * NI)) * 16 * MI>
struct Tile {
  static constexpr int kMI = MI, kNI = NI, kThreads = THREADS, kWarpsN = kBins / (8 * NI), kFrames = FRAMES;
  static constexpr int kKChunk = KCHUNK, kStageFloats = KCHUNK * kLdB;
  static_assert(kKTile % KCHUNK == 0 && KCHUNK % kSumRows == 0, "a stage holds whole sums and tiles the padding");
  static_assert(FRAMES == THREADS / 32 / kWarpsN * 16 * MI || (FRAMES == 8 && THREADS / 32 == kWarpsN && MI == 1),
                "the warps cover the frames");
  static constexpr size_t smem_bytes(int lda) {
    return sizeof(float) * (static_cast<size_t>(kFrames) * lda + kStages * kStageFloats + kFrames * kLdP);
  }
  // the longest frame row (= 4 mod 32) whose tile fits in shared memory
  static constexpr int kMaxLda =
      ((kSmemBytes / 4 - kStages * kStageFloats - kFrames * kLdP) / kFrames - 4) / 32 * 32 + 4;
};
using Tile64 = Tile<1, 2, 512>;        // 16 x 16 a warp, 4 x 4 warps (n_fft up to 513)
using Tile32 = Tile<1, 1, 512>;        // 16 x 8 a warp, 2 x 8 warps (up to 1031)
using Tile16 = Tile<1, 1, 256>;        // 16 x 8 a warp, 1 x 8 warps (up to 2305)
using Tile8 = Tile<1, 1, 256, 64, 8>;  // 8 x 8 a warp, 1 x 8 warps, 64-row stages (up to 5889)

// x ~ big + small for a finite x: big is x rounded to TF32 (nearest, ties away), cvt.rna.tf32.f32 in two
// integer operations without its guard for Inf and NaN; small is the exact remainder, handed over as it
// is: the tensor cores read a TF32 operand's top 19 bits (on the H100 a rounded small gave bit-equal
// outputs with its low 13 bits cleared or not), so small is truncated to TF32, in no operation
__device__ __forceinline__ void split_tf32_finite(float x, unsigned& big, unsigned& small) {
  big = (__float_as_uint(x) + 0x1000u) & 0xffffe000u;
  small = __float_as_uint(x - __uint_as_float(big));
}

// The frames a block of a launch holds: the largest tile whose frame row fits and that gives each of the
// sms SMs a block, else the 16-frame tile (a short batch: more, smaller blocks), else the 8-frame one;
// 0 where none fits
int tile_of(int lda, long long total, int sms) {
  if (lda <= Tile64::kMaxLda && (total + 63) / 64 >= sms) return 64;
  if (lda <= Tile32::kMaxLda && (total + 31) / 32 >= sms) return 32;
  if (lda <= Tile16::kMaxLda) return 16;
  return lda <= Tile8::kMaxLda ? 8 : 0;
}

int sm_count() {
  int device = 0, sms = 0;
  if (cudaGetDevice(&device) != cudaSuccess ||
      cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device) != cudaSuccess)
    return 0;
  return sms;
}

// numpy/torch 'reflect' padding (the edge sample is not repeated); valid for
// -n < i < 2n - 1, which the launcher guarantees by requiring n > n_fft/2.
__device__ __forceinline__ int reflect_index(int i, int n) {
  if (i < 0) i = -i;
  if (i >= n) i = 2 * (n - 1) - i;
  return i;
}

template <class T>
__global__ void __launch_bounds__(T::kThreads, 1)
stft_logmel_tc_kernel(const float* __restrict__ audio, const float* __restrict__ window,
                      const float* __restrict__ basis, const float* __restrict__ mel_fb,
                      const int* __restrict__ bands, float* __restrict__ out, int batch, int samples, int n_fft,
                      int hop, int n_frames, int k_half, int nb_pad, int n_mels, float log_floor) {
  constexpr int MI = T::kMI, NI = T::kNI, kThreads = T::kThreads, kFrames = T::kFrames, kWarpsN = T::kWarpsN;
  constexpr int kKChunk = T::kKChunk, kStageFloats = T::kStageFloats;
  constexpr bool kHalfM = kFrames < 16;  // rows g + 8 of the m16 tile repeat rows g
  constexpr int kGroups = kThreads / kFrames;    // threads a frame in the mel sums
  constexpr int kMelSlots = kMaxMels / kGroups;  // mel sums a thread: mels grp, grp + kGroups, ...
  extern __shared__ __align__(16) float smem[];
  __shared__ long long src_row[kFrames];  // the frame's batch row times samples; -1 past the last frame
  __shared__ int src_start[kFrames];      // its first sample, t * hop - n_fft / 2
  __shared__ float nyquist_power[kFrames];
  const int half = n_fft / 2, pairs = (n_fft + 1) / 2;  // bins 0 .. pairs - 1 from the GEMMs
  const int lda = frame_stride(n_fft, k_half);
  float* as = smem;                           // [kFrames][lda]: the windowed, folded frames
  float* ring = as + kFrames * lda;           // kStages stages
  float* pw = ring + kStages * kStageFloats;  // [kFrames][kLdP]: one pass's power

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, q = lane & 3;
  const int wm = warp / kWarpsN * 16 * MI, wb = warp % kWarpsN * 8 * NI;
  const long long total = static_cast<long long>(batch) * n_frames;
  const long long r0 = static_cast<long long>(blockIdx.x) * kFrames;
  const int k_chunks = k_half / kKChunk, pass_steps = 2 * k_chunks, steps = (nb_pad / kBins) * pass_steps;
  const int m0 = blockIdx.y * kMaxMels, mels = min(kMaxMels, n_mels - m0);  // this block's mels

  if (tid < kFrames) {
    const long long r = r0 + tid;
    long long row = -1;
    int start = 0;
    if (r < total) {
      const long long b = r / n_frames;
      row = b * samples;
      start = static_cast<int>(r - b * n_frames) * hop - half;
    }
    src_row[tid] = row;
    src_start[tid] = start;
  }
  // the even n_fft's Nyquist bin, where the band of one of this block's mels reaches it
  const bool reach = n_fft % 2 == 0 && tid < mels && __ldg(bands + 2 * (m0 + tid)) <= half &&
                     __ldg(bands + 2 * (m0 + tid) + 1) >= half;
  const bool nyquist = __syncthreads_or(reach) != 0;  // also the barrier behind src_row, src_start

  // the frames, unwindowed: 16 bytes where all four samples lie inside the
  // row and the source is aligned, else sample by sample (reflected at the
  // edges); zero past n_fft and past the last frame
  const int chunks = lda / 4;
  for (int idx = tid; idx < kFrames * chunks; idx += kThreads) {
    const int f = idx / chunks, n = (idx - f * chunks) * 4;
    float* dst = as + f * lda + n;
    const long long row = src_row[f];
    const int i0 = src_start[f] + n;
    const float* x = audio + (row < 0 ? 0 : row);
    if (row >= 0 && n + 4 <= n_fft && i0 >= 0 && i0 + 4 <= samples &&
        (reinterpret_cast<uintptr_t>(x + i0) & 15) == 0) {
      cp_async16(dst, x + i0, true);
    } else {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const bool valid = row >= 0 && n + e < n_fft;
        cp_async4(dst + e, valid ? x + reflect_index(i0 + e, samples) : audio, valid);
      }
    }
  }

  // ring step s of pass j = s / pass_steps: basis rows [r * kKChunk, + kKChunk) of the cosine table
  // (c < k_chunks) or the sine table, bins [j * kBins, + kBins)
  auto load_basis = [&](int s) {
    const int j = s / pass_steps, c = s - j * pass_steps;
    const int table = c < k_chunks ? 0 : 1, r = c - table * k_chunks;
    float* stage = ring + (s % kStages) * kStageFloats;
    const size_t base = (static_cast<size_t>(table) * k_half + r * kKChunk) * nb_pad + j * kBins;
#pragma unroll
    for (int i = 0; i < kKChunk * kBins / 4 / kThreads; ++i) {
      const int idx = tid + i * kThreads;
      const int k = idx / (kBins / 4), n = (idx % (kBins / 4)) * 4;
      const size_t src = base + static_cast<size_t>(k) * nb_pad + n;
      cp_async16(stage + k * kLdB + n, basis + src, true);
    }
  };

  float acc_re[MI][NI][4] = {}, acc_im[MI][NI][4] = {};
  float mel[kMelSlots] = {};
  const int mf = tid % kFrames, grp = tid / kFrames;  // this thread's frame and mels in the sums
#pragma unroll
  for (int p = 0; p < kStages - 1; ++p) {  // group 0 also holds the frames
    if (p < steps) load_basis(p);
    cp_async_commit();
  }
  for (int s = 0; s < steps; ++s) {
    cp_async_wait<kStages - 2>();
    __syncthreads();  // step s's stage has landed for every thread; step s - 1's stage is free
    if (s == 0) {     // the frames have landed: window and fold them in place
      for (int p = tid; p <= half; p += kThreads) {
        const int p2 = n_fft - p;
        const float w = __ldg(window + p);
        if (p == 0 || p2 == p) {
          for (int f = 0; f < kFrames; ++f) as[f * lda + p] *= w;
        } else {
          const float w2 = __ldg(window + p2);
          for (int f = 0; f < kFrames; ++f) {
            const float a = as[f * lda + p] * w, b = as[f * lda + p2] * w2;
            as[f * lda + p] = a + b;
            as[f * lda + p2] = b - a;
          }
        }
      }
      __syncthreads();
      if (nyquist && tid < kFrames) {
        float sum = 0.f;
        for (int p = 0; p <= half; ++p) sum += (p & 1) ? -as[tid * lda + p] : as[tid * lda + p];
        nyquist_power[tid] = sum * sum;
      }
    }
    if (s + kStages - 1 < steps) load_basis(s + kStages - 1);
    cp_async_commit();  // an empty group near the end keeps the count
    const int j = s / pass_steps, c = s - j * pass_steps;
    const bool sine = c >= k_chunks;
    const int col0 = sine ? half + 1 + (c - k_chunks) * kKChunk : 1 + c * kKChunk;  // the frame's column of row 0
    const float* stage = ring + (s % kStages) * kStageFloats;
    float part[MI][NI][4] = {};  // the products of kSumRows rows, in fresh sums
    const int lo8 = kHalfM ? 0 : 8 * lda;
#pragma unroll
    for (int kk = 0; kk < kKChunk; kk += 8) {
      unsigned a_big[MI][4], a_small[MI][4], b_big[NI][2], b_small[NI][2];
#pragma unroll
      for (int mi = 0; mi < MI; ++mi) {
        const float* a = as + (wm + mi * 16 + g) * lda + col0 + kk + q;
        split_tf32_finite(a[0], a_big[mi][0], a_small[mi][0]);            // (m = g,     k = q)
        split_tf32_finite(a[lo8], a_big[mi][1], a_small[mi][1]);          // (m = g + 8, k = q)
        split_tf32_finite(a[4], a_big[mi][2], a_small[mi][2]);            // (m = g,     k = q + 4)
        split_tf32_finite(a[lo8 + 4], a_big[mi][3], a_small[mi][3]);      // (m = g + 8, k = q + 4)
      }
#pragma unroll
      for (int ni = 0; ni < NI; ++ni) {
        const int off = (kk + q) * kLdB + wb + ni * 8 + g;  // (k = q, n = g), then k = q + 4
        split_tf32_finite(stage[off], b_big[ni][0], b_small[ni][0]);
        split_tf32_finite(stage[off + 4 * kLdB], b_big[ni][1], b_small[ni][1]);
      }
      // one pass over the tiles at a time, so that back-to-back products are independent
#pragma unroll
      for (int mi = 0; mi < MI; ++mi)
#pragma unroll
        for (int ni = 0; ni < NI; ++ni) mma_tf32(part[mi][ni], a_small[mi], b_big[ni]);
#pragma unroll
      for (int mi = 0; mi < MI; ++mi)
#pragma unroll
        for (int ni = 0; ni < NI; ++ni) mma_tf32(part[mi][ni], a_big[mi], b_small[ni]);
#pragma unroll
      for (int mi = 0; mi < MI; ++mi)
#pragma unroll
        for (int ni = 0; ni < NI; ++ni) mma_tf32(part[mi][ni], a_big[mi], b_big[ni]);
      if ((kk + 8) % kSumRows != 0) continue;
#pragma unroll
      for (int mi = 0; mi < MI; ++mi)
#pragma unroll
        for (int ni = 0; ni < NI; ++ni)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            if (sine) {
              acc_im[mi][ni][e] += part[mi][ni][e];
            } else {
              acc_re[mi][ni][e] += part[mi][ni][e];
            }
            part[mi][ni][e] = 0.f;
          }
    }
    if (c + 1 < pass_steps) continue;

    // pass j is summed: lane (g, q) holds bins j * kBins + wb + ni * 8 + 2q (+1) of frames g and g + 8
    // of each m16 tile; re gains v[0], the cosine row of p = 0
#pragma unroll
    for (int mi = 0; mi < MI; ++mi)
#pragma unroll
      for (int h = 0; h < (kHalfM ? 1 : 2); ++h) {
        const int row = wm + mi * 16 + g + 8 * h;
        const float v0 = as[row * lda];
#pragma unroll
        for (int ni = 0; ni < NI; ++ni)
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const float re = acc_re[mi][ni][2 * h + e] + v0, im = acc_im[mi][ni][2 * h + e];
            pw[row * kLdP + wb + ni * 8 + 2 * q + e] = re * re + im * im;
            acc_re[mi][ni][2 * h + e] = acc_im[mi][ni][2 * h + e] = 0.f;
          }
      }
    __syncthreads();
    // each mel's band within the pass's bins, ascending; the Nyquist bin with pass 0
    const int bin0 = j * kBins, bin_end = min(bin0 + kBins, pairs);
    const float* prow = pw + mf * kLdP - bin0;
#pragma unroll
    for (int i = 0; i < kMelSlots; ++i) {
      const int m = m0 + grp + kGroups * i;
      if (grp + kGroups * i < mels) {
        const int lo = __ldg(bands + 2 * m), hi = __ldg(bands + 2 * m + 1);
        float sum = mel[i];
        for (int k = max(lo, bin0); k <= min(hi, bin_end - 1); ++k)
          sum = fmaf(prow[k], __ldg(mel_fb + static_cast<size_t>(k) * n_mels + m), sum);
        if (j == 0 && nyquist && hi >= half && lo <= half)
          sum = fmaf(nyquist_power[mf], __ldg(mel_fb + static_cast<size_t>(half) * n_mels + m), sum);
        mel[i] = sum;
      }
    }
  }

  // log, staged through the frame tile (free since the last pass's barrier) so the
  // block's rows, contiguous in out, are written coalesced
  const int ld_out = mels | 1;  // odd: a warp's 32 frames hit 32 banks
#pragma unroll
  for (int i = 0; i < kMelSlots; ++i) {
    const int c = grp + kGroups * i;
    // not fmaxf, which drops a NaN: a NaN sample stays NaN, as in the twin and jnp.maximum
    if (c < mels) as[mf * ld_out + c] = logf(mel[i] < log_floor ? log_floor : mel[i]);
  }
  __syncthreads();
  const int rows = static_cast<int>(min(static_cast<long long>(kFrames), total - r0));
  float* dst = out + r0 * n_mels + m0;
  for (int idx = tid; idx < rows * mels; idx += kThreads) {
    const int f = idx / mels, c = idx - f * mels;
    dst[static_cast<size_t>(f) * n_mels + c] = as[f * ld_out + c];
  }
}

// Sets the kernel's shared-memory opt-in once, to the most any launch of it asks.
template <class T>
cudaError_t configure() {
  static cudaError_t status = cudaFuncSetAttribute(stft_logmel_tc_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                                   static_cast<int>(T::smem_bytes(T::kMaxLda)));
  return status;
}

template <class T>
cudaError_t launch(const float* audio, const float* window, const float* basis, const float* mel_fb,
                   const int* bands, float* out, int batch, int samples, int n_fft, int hop, int n_frames, int k_half,
                   int nb_pad, int n_mels, float log_floor, cudaStream_t stream) {
  const cudaError_t err = configure<T>();
  if (err != cudaSuccess) return err;
  const long long total = static_cast<long long>(batch) * n_frames;
  const dim3 grid(static_cast<unsigned>((total + T::kFrames - 1) / T::kFrames), (n_mels + kMaxMels - 1) / kMaxMels);
  stft_logmel_tc_kernel<T><<<grid, T::kThreads, T::smem_bytes(frame_stride(n_fft, k_half)), stream>>>(
      audio, window, basis, mel_fb, bands, out, batch, samples, n_fft, hop, n_frames, k_half, nb_pad, n_mels,
      log_floor);
  return cudaGetLastError();
}

template <class T>
cudaError_t plan(int lda, int* frames, int* blocks_per_sm, int* registers, int* local_bytes, int* shared_bytes) {
  cudaError_t err = configure<T>();
  if (err != cudaSuccess) return err;
  cudaFuncAttributes attr;
  err = cudaFuncGetAttributes(&attr, stft_logmel_tc_kernel<T>);
  if (err != cudaSuccess) return err;
  *frames = T::kFrames;
  *registers = attr.numRegs;
  *local_bytes = static_cast<int>(attr.localSizeBytes);
  *shared_bytes = static_cast<int>(T::smem_bytes(lda));
  return cudaOccupancyMaxActiveBlocksPerMultiprocessor(blocks_per_sm, stft_logmel_tc_kernel<T>, T::kThreads,
                                                       T::smem_bytes(lda));
}

int k_half_of(int n_fft) { return (n_fft / 2 + kKTile - 1) / kKTile * kKTile; }

}  // namespace

// basis: (2, k_half, nb_pad) float32 row-major, the cosine rows
// p = 1 .. n_fft/2 then the sine rows p = n_fft/2 + 1 .. n_fft - 1 of the
// (n_fft + 1)/2 bins below the Nyquist bin, zero-padded: k_half a multiple of
// 128 (kKTile) covering n_fft/2, nb_pad a multiple of 64 (kBins); bands:
// (n_mels, 2) int32; mel_fb: (n_fft/2 + 1, n_mels) row-major; any n_mels;
// n_fft whose frame row fits the 8-frame tile (up to 5889); samples > n_fft / 2.
extern "C" int stft_logmel_fwd(const float* audio, const float* window, const float* basis, const float* mel_fb,
                               const int* bands, float* out, int batch, int samples, int n_fft, int hop,
                               int n_frames, int k_half, int nb_pad, int n_mels, float log_floor, void* stream) {
  if (k_half % kKTile != 0 || k_half < n_fft / 2 || nb_pad % kBins != 0 || nb_pad < (n_fft + 1) / 2 ||
      n_mels < 1 || samples <= n_fft / 2)
    return cudaErrorInvalidValue;
  const auto s = static_cast<cudaStream_t>(stream);
  switch (tile_of(frame_stride(n_fft, k_half), static_cast<long long>(batch) * n_frames, sm_count())) {
    case 64:
      return launch<Tile64>(audio, window, basis, mel_fb, bands, out, batch, samples, n_fft, hop, n_frames, k_half,
                            nb_pad, n_mels, log_floor, s);
    case 32:
      return launch<Tile32>(audio, window, basis, mel_fb, bands, out, batch, samples, n_fft, hop, n_frames, k_half,
                            nb_pad, n_mels, log_floor, s);
    case 16:
      return launch<Tile16>(audio, window, basis, mel_fb, bands, out, batch, samples, n_fft, hop, n_frames, k_half,
                            nb_pad, n_mels, log_floor, s);
    case 8:
      return launch<Tile8>(audio, window, basis, mel_fb, bands, out, batch, samples, n_fft, hop, n_frames, k_half,
                           nb_pad, n_mels, log_floor, s);
    default:
      return cudaErrorInvalidValue;
  }
}

// Host only, no launch: what the card makes of the kernel that a launch of
// total_frames frames at n_fft takes (after its shared-memory opt-in): its
// frames a block, the blocks an SM holds at once (the occupancy calculator),
// registers a thread, local memory a thread (non-zero: spills or a stack
// frame) and dynamic shared memory a block.
extern "C" int stft_logmel_tc_plan(int n_fft, int total_frames, int* frames, int* blocks_per_sm, int* registers,
                                   int* local_bytes, int* shared_bytes) {
  const int lda = frame_stride(n_fft, k_half_of(n_fft));
  switch (tile_of(lda, total_frames, sm_count())) {
    case 64: return plan<Tile64>(lda, frames, blocks_per_sm, registers, local_bytes, shared_bytes);
    case 32: return plan<Tile32>(lda, frames, blocks_per_sm, registers, local_bytes, shared_bytes);
    case 16: return plan<Tile16>(lda, frames, blocks_per_sm, registers, local_bytes, shared_bytes);
    case 8: return plan<Tile8>(lda, frames, blocks_per_sm, registers, local_bytes, shared_bytes);
    default: return cudaErrorInvalidValue;
  }
}

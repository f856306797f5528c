// Adafactor's update and the gradients' global norm over every parameter of
// a model at once, for sm_90a.
//
// Replace no TPU kernel: the JAX package leaves optax.adafactor and
// optax.global_norm to XLA, which fuses each into a few programs.  The
// port's per-tensor loops (train/optim.py::Adafactor.step,
// train/loop.py::optax_global_norm) launch ~12,700 small kernels a
// Conformer-M step, each a few microseconds of device work behind ~30 us of
// host time, so the card idled under them.  These kernels walk a device
// table of all the parameters instead: four launches for Adafactor, two
// for the norm, whatever the number of parameters.
//
// What bounds them on the H100: bytes.  Conformer-M's update reads the
// gradient three times, reads and writes the parameter and the momentum
// once, and touches second moments that are small except where a
// parameter is not factored: ~1 GB a step, ~0.3 ms at 3.35 TB/s.  The
// arithmetic (a few flops and one reciprocal square root an element, some
// integer index math for factored parameters) is far below the card's peak.
//
// Semantics, all float32, as the per-tensor loop (optax.adafactor with
// multiply_by_parameter_scale off): decay 1 - (step+1)^-0.8 (keep / take),
// eps added to g^2, the row and column means of g^2 + eps over the two
// factored axes of the JAX layout and row_col_mean, clip_by_block_rms
// (u / max(1, rms(u) / threshold) per parameter), the learning rate, the
// momentum EMA (not debiased), the optional weight decay, p -= u.  Each
// product and sum that the loop forms as a tensor op is rounded as one here
// (__fmul_rn / __fadd_rn, no contraction into FMAs), and g * v^-0.5 is
// __frsqrt_rn, the correctly rounded reciprocal square root; only the
// means' and the clip's sums run in another order than torch's.
//
// Passes (each a launch over a job table, one job a block):
//   1. moments: an unfactored parameter's chunk updates v in place and
//      writes its partial sum of u^2; a factored parameter's row and column
//      sums of g^2 + eps, one output a warp, update v_row and v_col in place.
//   2. factors: each batch slice's row_col_mean (the mean of v_row over the
//      second largest axis), then row factors (v_row / row_col_mean)^-0.5
//      and column factors v_col^-0.5 into scratch.
//   3. clip sums: a factored parameter's chunk writes its partial sum of
//      u^2 = ((g * row factor) * column factor)^2 (skipped without a clip).
//   4. apply: each block adds its parameter's partials in chunk order (every
//      block of a parameter forms the same sum), then clips, scales by the
//      learning rate, updates the momentum, decays and updates p.
// The norm: one partial sum of g^2 a chunk, then one block adds the
// partials in chunk order (in double) and takes the square root.
//
// Layouts.  p and g are the port's layout, contiguous; a chunk is a run of
// kChunk elements of one parameter in memory order.  The elementwise slots
// v and ema are JAX-shaped views over port-ordered memory (the wrapper lays
// them out so), so one linear index walks p, g, v and ema, coalesced.  v_row
// and v_col are contiguous in the JAX layout.  Each parameter's row of the
// meta table (ops/cuda/adafactor.py::AdafactorTable) maps the indices:
// "walks" that decompose a flat index over sizes (row-major) and sum its
// coordinates times strides.
//
// No atomics: every sum has one owner (a thread, a warp or a block) and a
// fixed order, and cross-block sums are float32 partials a block added in
// block order, so launches are bit-equal.

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kChunk = 4096;  // elements a block of an elementwise pass takes (ops/cuda/adafactor.py::CHUNK)

// meta table: int64 fields a parameter (ops/cuda/adafactor.py::META_FIELDS, same order)
constexpr int kN = 0;          // elements
constexpr int kChunk0 = 1;     // the parameter's first chunk among all chunks
constexpr int kChunks = 2;     // its chunks
constexpr int kRow0 = 3;       // its first row factor in the scratch
constexpr int kCol0 = 4;       // its first column factor
constexpr int kL0 = 5;         // length of the largest axis, which v_row averages over
constexpr int kS0 = 6;         // its stride in the port's memory
constexpr int kL1 = 7;         // length of the second largest axis, which v_col averages over
constexpr int kS1 = 8;         // its stride in the port's memory
constexpr int kRs1 = 9;        // its stride inside v_row
constexpr int kWalkRow = 10;   // v_row entry → port offset of its first element: nd, 4 sizes, 4 strides
constexpr int kWalkCol = 19;   // v_col entry → port offset
constexpr int kWalkBatch = 28; // batch slice → v_row offset of its first entry
constexpr int kWalkElem = 37;  // port offset → v_row index, v_col index: nd, 4 sizes, 4 + 4 strides
constexpr int kMeta = 50;

// pointer table: a parameter's row, read anew each step (ops/cuda/adafactor.py::_slots)
constexpr int kP = 0, kG = 1, kA = 2, kB = 3, kEma = 4, kPtrs = 5;  // kA: v or v_row; kB: v_col

// job kinds (ops/cuda/adafactor.py, the same names)
enum Kind { kUnfactored = 0, kRowSums = 1, kColSums = 2, kBatchMeans = 3, kColFactors = 4, kClipSums = 5,
            kApply = 6 };

__device__ __forceinline__ long long walk(const long long* w, long long i) {
  const int nd = static_cast<int>(w[0]);
  long long off = 0;
  for (int k = nd - 1; k >= 0; --k) {
    const unsigned int size = static_cast<unsigned int>(w[1 + k]);
    const unsigned int x = static_cast<unsigned int>(i) % size;
    i = static_cast<unsigned int>(i) / size;
    off += static_cast<long long>(x) * w[5 + k];
  }
  return off;
}

// port offset → (v_row index, v_col index)
__device__ __forceinline__ void walk2(const long long* w, long long i, long long* r, long long* c) {
  const int nd = static_cast<int>(w[0]);
  long long ro = 0, co = 0;
  for (int k = nd - 1; k >= 0; --k) {
    const unsigned int size = static_cast<unsigned int>(w[1 + k]);
    const unsigned int x = static_cast<unsigned int>(i) % size;
    i = static_cast<unsigned int>(i) / size;
    ro += static_cast<long long>(x) * w[5 + k];
    co += static_cast<long long>(x) * w[9 + k];
  }
  *r = ro;
  *c = co;
}

// xor butterfly: every lane ends with the same bits (a + b == b + a)
__device__ __forceinline__ float warp_sum(float x) {
  for (int o = 16; o > 0; o >>= 1) x = __fadd_rn(x, __shfl_xor_sync(0xffffffffu, x, o));
  return x;
}

__device__ __forceinline__ double warp_sum(double x) {
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

// the block's sum, in warp order, given to every thread
template <typename T>
__device__ __forceinline__ T block_sum(T x) {
  __shared__ T part[kWarps];
  x = warp_sum(x);
  if ((threadIdx.x & 31) == 0) part[threadIdx.x >> 5] = x;
  __syncthreads();
  T s = part[0];
  for (int w = 1; w < kWarps; ++w) s += part[w];
  __syncthreads();
  return s;
}

__device__ __forceinline__ float ema(float keep, float old, float take, float x) {
  return __fadd_rn(__fmul_rn(keep, old), __fmul_rn(take, x));
}

template <typename T>
__device__ __forceinline__ T* at(const long long* ptr, int k) {
  return reinterpret_cast<T*>(ptr[k]);
}

__global__ void __launch_bounds__(kThreads) adafactor_moments_kernel(
    const long long* __restrict__ meta, const long long* __restrict__ ptrs, const int4* __restrict__ jobs,
    float* __restrict__ usq, float keep, float take, float eps, int clip) {
  const int4 job = jobs[blockIdx.x];
  const long long* m = meta + static_cast<long long>(job.y) * kMeta;
  const long long* ptr = ptrs + static_cast<long long>(job.y) * kPtrs;
  const float* __restrict__ g = at<const float>(ptr, kG);
  if (job.x == kUnfactored) {
    float* __restrict__ v = at<float>(ptr, kA);
    float acc = 0.f;
    for (int i = threadIdx.x; i < job.w; i += kThreads) {
      const long long e = static_cast<long long>(job.z) + i;
      const float gi = g[e];
      const float vi = ema(keep, v[e], take, __fadd_rn(__fmul_rn(gi, gi), eps));
      v[e] = vi;
      const float u = __fmul_rn(gi, __frsqrt_rn(vi));
      acc = fmaf(u, u, acc);
    }
    if (clip) {
      const float s = block_sum(acc);
      if (threadIdx.x == 0) usq[m[kChunk0] + job.z / kChunk] = s;
    }
    return;
  }
  // row or column sums of g^2 + eps: one output a warp
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  if (warp >= job.w) return;
  const bool row = job.x == kRowSums;
  const long long o = static_cast<long long>(job.z) + warp;
  const long long base = walk(m + (row ? kWalkRow : kWalkCol), o);
  const long long len = m[row ? kL0 : kL1], stride = m[row ? kS0 : kS1];
  float acc = 0.f;
  for (long long x = lane; x < len; x += 32) {
    const float gi = g[base + x * stride];
    acc = __fadd_rn(acc, __fadd_rn(__fmul_rn(gi, gi), eps));
  }
  acc = warp_sum(acc);
  if (lane == 0) {
    float* slot = at<float>(ptr, row ? kA : kB);
    slot[o] = ema(keep, slot[o], take, __fdiv_rn(acc, static_cast<float>(len)));
  }
}

__global__ void __launch_bounds__(kThreads) adafactor_factors_kernel(
    const long long* __restrict__ meta, const long long* __restrict__ ptrs, const int4* __restrict__ jobs,
    float* __restrict__ rf, float* __restrict__ cf) {
  const int4 job = jobs[blockIdx.x];
  const long long* m = meta + static_cast<long long>(job.y) * kMeta;
  const long long* ptr = ptrs + static_cast<long long>(job.y) * kPtrs;
  if (job.x == kColFactors) {
    const float* __restrict__ vcol = at<const float>(ptr, kB);
    for (int i = threadIdx.x; i < job.w; i += kThreads) {
      const long long c = static_cast<long long>(job.z) + i;
      cf[m[kCol0] + c] = __frsqrt_rn(vcol[c]);
    }
    return;
  }
  // a batch slice a warp: row_col_mean, then its row factors
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  if (warp >= job.w) return;
  const float* __restrict__ vrow = at<const float>(ptr, kA);
  const long long base = walk(m + kWalkBatch, static_cast<long long>(job.z) + warp);
  const long long len = m[kL1], stride = m[kRs1];
  float acc = 0.f;
  for (long long x = lane; x < len; x += 32) acc = __fadd_rn(acc, vrow[base + x * stride]);
  const float mean = __fdiv_rn(warp_sum(acc), static_cast<float>(len));
  for (long long x = lane; x < len; x += 32) {
    const long long r = base + x * stride;
    rf[m[kRow0] + r] = __frsqrt_rn(__fdiv_rn(vrow[r], mean));
  }
}

__device__ __forceinline__ float factored_update(const long long* m, const float* __restrict__ rf,
                                                 const float* __restrict__ cf, float gi, long long e) {
  long long r, c;
  walk2(m + kWalkElem, e, &r, &c);
  return __fmul_rn(__fmul_rn(gi, rf[m[kRow0] + r]), cf[m[kCol0] + c]);
}

__global__ void __launch_bounds__(kThreads) adafactor_clip_sums_kernel(
    const long long* __restrict__ meta, const long long* __restrict__ ptrs, const int4* __restrict__ jobs,
    const float* __restrict__ rf, const float* __restrict__ cf, float* __restrict__ usq) {
  const int4 job = jobs[blockIdx.x];
  const long long* m = meta + static_cast<long long>(job.y) * kMeta;
  const long long* ptr = ptrs + static_cast<long long>(job.y) * kPtrs;
  const float* __restrict__ g = at<const float>(ptr, kG);
  float acc = 0.f;
  for (int i = threadIdx.x; i < job.w; i += kThreads) {
    const long long e = static_cast<long long>(job.z) + i;
    const float u = factored_update(m, rf, cf, g[e], e);
    acc = fmaf(u, u, acc);
  }
  const float s = block_sum(acc);
  if (threadIdx.x == 0) usq[m[kChunk0] + job.z / kChunk] = s;
}

struct Scalars {
  float lr, threshold, momentum, momentum_take, decay;
  int clip, use_momentum, use_decay;
};

__global__ void __launch_bounds__(kThreads) adafactor_apply_kernel(
    const long long* __restrict__ meta, const long long* __restrict__ ptrs, const int4* __restrict__ jobs,
    const float* __restrict__ rf, const float* __restrict__ cf, const float* __restrict__ usq, Scalars s) {
  const int4 job = jobs[blockIdx.x];
  const long long* m = meta + static_cast<long long>(job.y) * kMeta;
  const long long* ptr = ptrs + static_cast<long long>(job.y) * kPtrs;
  float scale = 1.f;
  if (s.clip) {  // the parameter's sum of u^2: its partials in chunk order, the same in each of its blocks
    float acc = 0.f;
    for (long long c = threadIdx.x; c < m[kChunks]; c += kThreads) acc = __fadd_rn(acc, usq[m[kChunk0] + c]);
    const float ms = __fdiv_rn(block_sum(acc), static_cast<float>(m[kN]));
    const float ratio = __fdiv_rn(__fsqrt_rn(ms), s.threshold);
    scale = ratio < 1.f ? 1.f : ratio;  // torch.clamp_min: a NaN stays NaN
  }
  const bool factored = ptr[kB] != 0;
  const float* __restrict__ g = at<const float>(ptr, kG);
  const float* __restrict__ v = at<const float>(ptr, kA);
  float* __restrict__ p = at<float>(ptr, kP);
  float* __restrict__ mom = at<float>(ptr, kEma);
  for (int i = threadIdx.x; i < job.w; i += kThreads) {
    const long long e = static_cast<long long>(job.z) + i;
    const float gi = g[e];
    float u = factored ? factored_update(m, rf, cf, gi, e) : __fmul_rn(gi, __frsqrt_rn(v[e]));
    if (s.clip) u = __fdiv_rn(u, scale);
    u = __fmul_rn(s.lr, u);
    if (s.use_momentum) {
      u = __fadd_rn(__fmul_rn(s.momentum_take, u), __fmul_rn(s.momentum, mom[e]));
      mom[e] = u;
    }
    const float pe = p[e];
    if (s.use_decay) u = __fadd_rn(u, __fmul_rn(s.decay, pe));
    p[e] = __fsub_rn(pe, u);
  }
}

__global__ void __launch_bounds__(kThreads) sumsq_partials_kernel(const long long* __restrict__ ptrs,
                                                                  const int4* __restrict__ jobs,
                                                                  float* __restrict__ part) {
  const int4 job = jobs[blockIdx.x];
  const float* __restrict__ x = reinterpret_cast<const float*>(ptrs[job.y]);
  float acc = 0.f;
  for (int i = threadIdx.x; i < job.w; i += kThreads) {
    const float xi = x[static_cast<long long>(job.z) + i];
    acc = fmaf(xi, xi, acc);
  }
  const float s = block_sum(acc);
  if (threadIdx.x == 0) part[blockIdx.x] = s;
}

__global__ void __launch_bounds__(kThreads) sumsq_finish_kernel(const float* __restrict__ part, int count,
                                                                float* __restrict__ out) {
  double acc = 0.0;
  for (int i = threadIdx.x; i < count; i += kThreads) acc += static_cast<double>(part[i]);
  const double total = block_sum(acc);
  if (threadIdx.x == 0) out[0] = static_cast<float>(sqrt(total));
}

}  // namespace

extern "C" {

// Adafactor's passes over the job tables (jobs of a pass as (kind, parameter,
// first element or output, count) int4 rows; a table of 0 jobs is not
// launched, nor the clip sums without a clip); usq: a float a chunk, rf / cf:
// a float a v_row / v_col entry of every factored parameter.
int adafactor_step(const void* meta, const void* ptrs, const void* moments, int n_moments, const void* factors,
                   int n_factors, const void* clip_sums, int n_clip_sums, const void* apply, int n_apply, void* usq,
                   void* rf, void* cf, float keep, float take, float eps, float lr, int clip, float threshold,
                   int use_momentum, float momentum, float momentum_take, int use_decay, float decay,
                   void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const auto* m = static_cast<const long long*>(meta);
  const auto* pt = static_cast<const long long*>(ptrs);
  float* u = static_cast<float*>(usq);
  float* r = static_cast<float*>(rf);
  float* c = static_cast<float*>(cf);
  if (n_moments > 0) {
    adafactor_moments_kernel<<<n_moments, kThreads, 0, st>>>(m, pt, static_cast<const int4*>(moments), u, keep, take,
                                                             eps, clip);
    cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return err;
  }
  if (n_factors > 0) {
    adafactor_factors_kernel<<<n_factors, kThreads, 0, st>>>(m, pt, static_cast<const int4*>(factors), r, c);
    cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return err;
  }
  if (clip && n_clip_sums > 0) {
    adafactor_clip_sums_kernel<<<n_clip_sums, kThreads, 0, st>>>(m, pt, static_cast<const int4*>(clip_sums), r, c,
                                                                 u);
    cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return err;
  }
  if (n_apply > 0) {
    const Scalars s{lr, threshold, momentum, momentum_take, decay, clip, use_momentum, use_decay};
    adafactor_apply_kernel<<<n_apply, kThreads, 0, st>>>(m, pt, static_cast<const int4*>(apply), r, c, u, s);
  }
  return cudaGetLastError();
}

// sqrt of the sum of squares of every tensor: jobs (0, tensor, first element,
// count) a chunk, part a float a job, out one float.
int global_norm(const void* ptrs, const void* jobs, int n_jobs, void* part, void* out, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  float* p = static_cast<float*>(part);
  if (n_jobs > 0) {
    sumsq_partials_kernel<<<n_jobs, kThreads, 0, st>>>(static_cast<const long long*>(ptrs),
                                                       static_cast<const int4*>(jobs), p);
    cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return err;
  }
  sumsq_finish_kernel<<<1, kThreads, 0, st>>>(p, n_jobs, static_cast<float*>(out));
  return cudaGetLastError();
}

}  // extern "C"

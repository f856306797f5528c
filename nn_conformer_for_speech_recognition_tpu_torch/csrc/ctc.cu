// CTC alpha (forward) and beta (backward) recursions over a padded batch,
// for sm_90a.
//
// Replace nn_conformer_for_speech_recognition_tpu/ops/pallas/ctc.py:
// _alpha_kernel (pallas_call at :162) and _beta_kernel (:201).  Both walk the
// S = 2L+1 blank-interleaved states of one batch row in log space:
//   alpha_t[s] = logaddexp(alpha[s], alpha[s-1], canskip[s] ? alpha[s-2])
//                + emit_t[s]                       (t < input length)
//   beta_t[s]  = logaddexp(eb[s], eb[s+1], canskip[s+2] ? eb[s+2]),
//                eb = emit_{t+1} + beta_{t+1}      (t < input length - 1)
// with states at or beyond ext_len held at LOG_EPS, alpha carried and the
// end-state beta init carried through the padded frames, and
//   demit_t[s] = g * exp(min(alpha_t[s] + beta_t[s] - ll, 0))
// on valid frames and states (0 elsewhere).  The clamp keeps rows with no
// valid alignment (ll = LOG_EPS) finite; their cotangent g is 0 under
// zero_infinity.  Layout is (B, T, S) float32, written whole: the beta
// kernel reads alpha back.
//
// What bounds them on the H100: a row's T steps are a chain, each step
// needing the whole previous step, so the work cannot spread over more
// than one SM a row (B blocks on 132 SMs) and the bytes (0.002-0.011 ms at
// the train steps' shapes) do not matter.  The bound is a serial floor: a
// step's exps and logs for S states on one SM's special-function units (16
// a clock), its float32 arithmetic, and one block barrier with a
// shared-memory round trip (chip_smoke.ctc_serial_floor_ms).  So the design
// keeps everything but that off the step's chain:
// - No load from device memory in the chain: each thread copies its own
//   states of frame t + kAhead (emit; for beta also alpha) with cp.async
//   into its column of a ring of kAhead frames in shared memory, and waits
//   for a frame with its own cp.async.wait_group, so no barrier is needed
//   for it; it writes its alpha (or demit) straight from registers, and
//   nothing waits on those stores.  Measured on the H100 and slower: whole
//   frames (or chunks of frames) copied by the block and staged out through
//   shared memory, loads into registers ahead (each step still waited on
//   recent loads), and one bulk (TMA) copy a frame completing on an
//   mbarrier.
// - The posterior is off beta's chain: demit_{t+1} is formed from the
//   registers' beta_{t+1} and the staged alpha_{t+1} while step t's
//   neighbours are exchanged, and nothing waits on it.
// - Less arithmetic a state: logaddexp3 is the max plus two exps and one log
//   (the max's own exp is 1), written phase by phase across a thread's
//   states so that their chains interleave; the skip masks are added biases
//   (0 or LOG_EPS) and the validity masks selects; the exps and the log are
//   ex2.approx and lg2.approx (fast_exp2, fast_log2) on log2e-scaled
//   differences: the log's argument lies in [1, 3] and the exps' in
//   (-inf, 0], where their errors (~1e-7 absolute in the log-sum) sit far
//   below the float32 rounding of log-space values of ~1e3 (6e-5); the
//   agreement gates against the plain twin and float64 are unchanged.
// - Fewer, fuller warps: an alpha thread owns K consecutive states (K = 1,
//   3 or 5), a beta thread one; neighbours come from registers and
//   __shfl_up/down_sync, and only each warp's two edge values pass through
//   shared memory, published at the end of a step and double-buffered by
//   frame parity, so a step has one block barrier, and none with one warp.
//   ops/cuda/ctc.py::ctc_plan picks K and the warps by S and kernel (timed
//   over K = 1..9: alpha K = 1 in 7 warps at S = 201 and K = 3 in 9 at 801;
//   beta K = 1 won at every S, so it is the only beta build), and the
//   frames copied ahead and the shared bytes; the launchers check all of
//   it against the layout below and launch with the plan's bytes.
// Each state has one owner thread and nothing is atomic: launches are
// bit-equal.

#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

#include "tensor_core.cuh"

namespace {

constexpr float LOG_EPS = -1e30f;
constexpr unsigned kFull = 0xffffffffu;
constexpr int kMaxStates = 1024;
constexpr int kMaxWarps = 32;
constexpr int kAhead = 8;  // frames whose inputs are copied ahead of the chain

// A block's shared memory, all of it dynamic: each warp's two edge values of either frame parity, [parity][warp][2]
// with the parities `stride` warps apart, then `rings` rings (alpha: emit; beta: emit, alpha) of kAhead frames of
// each thread's K states.  The stride is kMaxWarps, but the block's warps in alpha's builds of K > 1: each timed
// the faster (the K = 3 build also spills at the fixed stride).
__host__ __device__ constexpr int alpha_edge_stride(int k, int warps) { return k > 1 ? warps : kMaxWarps; }
__host__ __device__ constexpr int edge_floats(int stride) { return 2 * stride * 2; }
size_t shared_bytes(int stride, int rings, int threads, int k) {
  return sizeof(float) * (edge_floats(stride) + static_cast<size_t>(rings) * kAhead * k * threads);
}

// the offset in the shared memory of warp w's two edge values of a frame of parity p
__device__ __forceinline__ int edge_at(int stride, int p, int w) { return 2 * (p * stride + w); }

// The most threads a launch with K states a thread can need for S <= kMaxStates.
__host__ __device__ constexpr int max_threads(int k) { return 32 * ((kMaxStates + 32 * k - 1) / (32 * k)); }

constexpr float kLog2e = 1.4426950408889634f, kLn2 = 0.6931471805599453f;

// 2^x and log2(x) on the special-function unit (ex2.approx and lg2.approx, flushing subnormals to zero): one
// MUFU each.  Their arguments here: exps of (-inf, 0] in natural units, logs of [1, 3]; a flushed exp below
// 1.2e-38 changes no sum and no posterior the gates can see.
__device__ __forceinline__ float fast_exp2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ float fast_log2(float x) {
  float y;
  asm("lg2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

// out[k] = log(e^a[k] + e^b[k] + e^c[k]) for k in [FROM, TO), as m + ln2·log2(1 + 2^((mid-m)·log2e) +
// 2^((lo-m)·log2e)) (the max's own exp is 1), LOG_EPS when every term is; written phase by phase across the
// states so that their independent chains interleave
template <int FROM, int TO, int K>
__device__ __forceinline__ void logaddexp3(const float (&a)[K], const float (&b)[K], const float (&c)[K],
                                           float (&out)[K]) {
  float m[K], u[K], v[K];
#pragma unroll
  for (int k = FROM; k < TO; ++k) {
    const float hi = fmaxf(a[k], b[k]), lo = fminf(a[k], b[k]);
    m[k] = fmaxf(hi, c[k]);
    // the differences first, exactly where they are small: m·log2e rounded would err by ~1e-4 at |m| ~ 1e3
    u[k] = (fminf(hi, c[k]) - m[k]) * kLog2e;
    v[k] = (lo - m[k]) * kLog2e;
  }
#pragma unroll
  for (int k = FROM; k < TO; ++k) u[k] = fast_exp2(u[k]);
#pragma unroll
  for (int k = FROM; k < TO; ++k) v[k] = fast_exp2(v[k]);
#pragma unroll
  for (int k = FROM; k < TO; ++k) u[k] = fast_log2(1.f + u[k] + v[k]);
#pragma unroll
  for (int k = FROM; k < TO; ++k) out[k] = m[k] <= LOG_EPS ? LOG_EPS : fmaf(u[k], kLn2, m[k]);
}

// the same for one state
__device__ __forceinline__ float logaddexp3(float a, float b, float c) {
  const float a1[1] = {a}, b1[1] = {b}, c1[1] = {c};
  float out[1];
  logaddexp3<0, 1, 1>(a1, b1, c1, out);
  return out[0];
}

// A thread's ring of frames in shared memory: its K states of kAhead frames, laid out [frame slot][k][thread] so
// that a warp's k-th states are 32 consecutive floats.  The thread copies and reads only its own states, so its
// own cp.async.wait_group, and no barrier, makes a frame visible.
template <int K>
struct Ring {
  float* base;  // this thread's column
  int nt;
  __device__ __forceinline__ float* at(int slot, int k) const { return base + (slot * K + k) * nt; }
  // this thread's states of frame t (when 0 <= t < seq) into a slot, asynchronously, as one group
  __device__ __forceinline__ void copy(int slot, const float* row0, int t, int seq, int states, int own) const {
    const bool live = t >= 0 && t < seq;
    const float* src = row0 + static_cast<ptrdiff_t>(t) * states;
#pragma unroll
    for (int k = 0; k < K; ++k)
      if (live && k < own) tc::cp_async4(at(slot, k), src + k, true);
  }
  __device__ __forceinline__ void read(int slot, float (&v)[K]) const {
#pragma unroll
    for (int k = 0; k < K; ++k) v[k] = *at(slot, k);
  }
};

template <int K>
__device__ __forceinline__ void store_states(float* dst, const float (&v)[K], int own) {
#pragma unroll
  for (int k = 0; k < K; ++k)
    if (k < own) dst[k] = v[k];
}

template <int K>
__global__ void __launch_bounds__(max_threads(K))
    ctc_alpha_kernel(const float* __restrict__ emit, const uint8_t* __restrict__ can_skip,
                     const int* __restrict__ ext_len, const int* __restrict__ input_len, float* __restrict__ alpha,
                     int seq, int states) {
  extern __shared__ float smem[];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5, warps = blockDim.x >> 5;
  // smem[edge_at(stride, p, w)]: warp w's last two states of a frame of parity p
  const int stride = alpha_edge_stride(K, warps);
  const int b = blockIdx.x, s0 = tid * K;
  const int len = input_len[b], elen = ext_len[b];
  const Ring<K> ring{smem + edge_floats(stride) + tid, static_cast<int>(blockDim.x)};
  const int own = max(0, min(K, states - s0));  // states of this thread inside the row
  unsigned valid = 0;
  float skip[K];  // 0 where the skip from s-2 is allowed, LOG_EPS where not: added, it rounds that term to a
                  // log(0) whose exp is 0, as the twin's LOG_EPS is
  const uint8_t* cs = can_skip + static_cast<size_t>(b) * states;
#pragma unroll
  for (int k = 0; k < K; ++k) {
    const int s = s0 + k;
    if (s < states && s < elen) valid |= 1u << k;
    skip[k] = s >= 2 && s < states && cs[s] ? 0.f : LOG_EPS;
  }
  const float* e = emit + static_cast<size_t>(b) * seq * states + s0;
  float* out = alpha + static_cast<size_t>(b) * seq * states + s0;
  // emit of frames t .. t + kAhead - 1, frame t in slot t % kAhead
  for (int j = 0; j < kAhead; ++j) {
    ring.copy(j, e, j, seq, states, own);
    tc::cp_async_commit();
  }

  float a[K];
  for (int t0 = 0; t0 < seq; t0 += kAhead) {
#pragma unroll
    for (int j = 0; j < kAhead; ++j) {
      const int t = t0 + j;
      if (t >= seq) break;  // block-uniform
      float ev[K];
      tc::cp_async_wait<kAhead - 1>();
      ring.read(j, ev);
      if (t == 0) {  // the init, whatever the row's length
#pragma unroll
        for (int k = 0; k < K; ++k) a[k] = ((valid >> k) & 1) && s0 + k < 2 ? ev[k] : LOG_EPS;
      } else if (t < len) {  // block-uniform
        // neighbours s0-1 and s0-2 of frame t-1 from the lanes below, and across a warp's edge through shared
        // memory, published at the end of the last step
        float p1 = __shfl_up_sync(kFull, a[K - 1], 1);
        float p2 = K >= 2 ? __shfl_up_sync(kFull, a[K >= 2 ? K - 2 : 0], 1) : __shfl_up_sync(kFull, a[0], 2);
        if (warps > 1) __syncthreads();
        const int below = edge_at(stride, (t - 1) & 1, max(warp - 1, 0));
        if (lane == 0) {
          p1 = warp > 0 ? smem[below + 1] : LOG_EPS;
          p2 = warp > 0 ? smem[below] : LOG_EPS;
        }
        if (K == 1 && lane == 1) p2 = warp > 0 ? smem[below + 1] : LOG_EPS;
        constexpr int kEdge = K < 2 ? K : 2;  // states whose neighbours s-1, s-2 lie with the lanes below
        float x1[K], x2[K], na[K];
#pragma unroll
        for (int k = kEdge; k < K; ++k) {
          x1[k] = a[k - 1 >= 0 ? k - 1 : 0];
          x2[k] = a[k - 2 >= 0 ? k - 2 : 0] + skip[k];
        }
        x1[0] = p1;
        x2[0] = p2 + skip[0];
        if (K >= 2) {
          x1[K >= 2 ? 1 : 0] = a[0];
          x2[K >= 2 ? 1 : 0] = p1 + skip[K >= 2 ? 1 : 0];
        }
        logaddexp3<kEdge, K>(a, x1, x2, na);
        logaddexp3<0, kEdge>(a, x1, x2, na);
#pragma unroll
        for (int k = 0; k < K; ++k) a[k] = (valid >> k) & 1 ? na[k] + ev[k] : LOG_EPS;
      }
      store_states<K>(out + static_cast<size_t>(t) * states, a, own);
      if (t + 1 < len) {  // the next step reads them (a carried frame's would race a slower warp's last read)
        const int mine = edge_at(stride, t & 1, warp);
        if (lane == 31) smem[mine + 1] = a[K - 1];
        if (lane == (K >= 2 ? 31 : 30)) smem[mine] = a[K >= 2 ? K - 2 : 0];
      }
      ring.copy(j, e, t + kAhead, seq, states, own);
      tc::cp_async_commit();
    }
  }
  tc::cp_async_wait<0>();
}

// g·exp(min(alpha + beta - ll, 0)) on a live frame's valid state, else 0; every thread computes it, whether or not
// it owns a state (so that it is scheduled as the chain's neighbour, not behind a branch), and an owner stores it
__device__ __forceinline__ void posterior(float* dst, float al, float beta, bool live, bool valid, bool own,
                                          float llb, float gb) {
  const float v = gb * fast_exp2(fminf(al + beta - llb, 0.f) * kLog2e);
  if (own) *dst = live && valid ? v : 0.f;
}

// One state a thread (ctc_plan: timed faster than several at every S).
__global__ void __launch_bounds__(max_threads(1))
    ctc_beta_kernel(const float* __restrict__ emit, const float* __restrict__ alpha,
                    const uint8_t* __restrict__ can_skip, const int* __restrict__ ext_len,
                    const int* __restrict__ input_len, const float* __restrict__ ll, const float* __restrict__ g,
                    float* __restrict__ demit, int seq, int states) {
  extern __shared__ float smem[];
  const int s = threadIdx.x, lane = s & 31, warp = s >> 5, warps = blockDim.x >> 5;
  // smem[edge_at(kMaxWarps, p, w)]: warp w's first two eb values of a frame of parity p
  const int ring_floats = kAhead * static_cast<int>(blockDim.x);
  const Ring<1> ering{smem + edge_floats(kMaxWarps) + s, static_cast<int>(blockDim.x)};                // emit
  const Ring<1> aring{smem + edge_floats(kMaxWarps) + ring_floats + s, static_cast<int>(blockDim.x)};  // alpha
  const int b = blockIdx.x;
  const int len = min(input_len[b], seq), elen = ext_len[b];
  const int own = s < states;
  const bool valid = s < states && s < elen;
  // 0 where the skip into s+2 is allowed, LOG_EPS where not (as alpha's skip)
  const float skip2 = s + 2 < states && can_skip[static_cast<size_t>(b) * states + s + 2] ? 0.f : LOG_EPS;
  // t = T-1 is the init step: the end states
  float beta = s < states && (s == elen - 1 || (s == elen - 2 && elen >= 2)) ? 0.f : LOG_EPS;
  const float llb = ll[b], gb = g[b];
  const size_t row0 = static_cast<size_t>(b) * seq * states + s;
  const float* e = emit + row0;
  const float* al = alpha + row0;
  float* out = demit + row0;
  // step i walks frame t = seq-1-i, whose emit and alpha sit in slot i % kAhead.  Step t copies emit of frame
  // t - kAhead (after using emit of t) and alpha of frame t + 1 - kAhead (after using alpha of t + 1), as one
  // group; the first kAhead groups do the same for the steps t = seq - 1 + kAhead .. seq before the first.
  const auto slot_of = [&](int t) { return (seq - 1 - t) % kAhead; };
  for (int u = seq - 1 + kAhead; u >= seq; --u) {
    if (u - kAhead >= 0) ering.copy(slot_of(u - kAhead), e, u - kAhead, seq, states, own);
    if (u + 1 - kAhead < seq) aring.copy(slot_of(u + 1 - kAhead), al, u + 1 - kAhead, seq, states, own);
    tc::cp_async_commit();
  }

  float eb;  // emit_{t+1} + beta_{t+1} on a valid state, for the step from t+1 into t
  for (int i0 = 0; i0 < seq; i0 += kAhead) {
#pragma unroll
    for (int j = 0; j < kAhead; ++j) {
      const int t = seq - 1 - (i0 + j);
      if (t < 0) break;  // block-uniform
      const int up = (j + kAhead - 1) % kAhead;  // the slot of frame t+1
      tc::cp_async_wait<kAhead - 1>();
      const float ev = *ering.at(j, 0), av = *aring.at(up, 0);  // emit of frame t, alpha of frame t+1
      if (t < len - 1) {  // block-uniform: a transition into t+1 exists
        // neighbours s+1 and s+2 from the lanes above, and across a warp's edge through shared memory,
        // published at the end of the last step
        float n1 = __shfl_down_sync(kFull, eb, 1);
        float n2 = __shfl_down_sync(kFull, eb, 2);
        if (warps > 1) __syncthreads();
        // the warp above's (past the last warp: the other parity's or the ring's first, read and not used)
        const float* ed = smem + edge_at(kMaxWarps, t & 1, warp + 1);
        const bool above = warp + 1 < warps;
        if (lane == 31) {
          n1 = above ? ed[0] : LOG_EPS;
          n2 = above ? ed[1] : LOG_EPS;
        }
        if (lane == 30) n2 = above ? ed[0] : LOG_EPS;
        // off the chain: demit of frame t+1 from beta_{t+1}
        posterior(out + static_cast<size_t>(t + 1) * states, av, beta, true, valid, own, llb, gb);
        const float nb = logaddexp3(eb, n1, n2 + skip2);
        beta = valid ? nb : LOG_EPS;
      } else if (t + 1 < seq) {  // beta carries the end-state init
        posterior(out + static_cast<size_t>(t + 1) * states, av, beta, t + 1 < len, valid, own, llb, gb);
      }
      if (t == 0) {  // alpha of frame 0 came in the group after the one the step waited for
        tc::cp_async_wait<0>();
        posterior(out, *aring.at(j, 0), beta, 0 < len, valid, own, llb, gb);
      } else {  // eb for the step into t-1, and the warp's first two for the warp below
        eb = valid ? ev + beta : LOG_EPS;
        if (lane == 0) smem[edge_at(kMaxWarps, (t - 1) & 1, warp)] = eb;
        if (lane == 1) smem[edge_at(kMaxWarps, (t - 1) & 1, warp) + 1] = eb;
      }
      ering.copy(j, e, t - kAhead, seq, states, own);
      aring.copy(up, al, t + 1 - kAhead, seq, states, own);
      tc::cp_async_commit();
    }
  }
  tc::cp_async_wait<0>();
}

// One block barrier and one shared-memory round trip a pass, chained: what a step of either kernel pays
// beside its arithmetic (chip_smoke.ctc_serial_floor_ms times it).
__global__ void ctc_step_probe_kernel(int iters, float* sink) {
  __shared__ float buf[2][1024];
  const int tid = threadIdx.x;
  float v = static_cast<float>(tid);
  for (int i = 0; i < iters; ++i) {
    buf[i & 1][tid] = v;
    __syncthreads();
    v = buf[i & 1][(tid + 1) % blockDim.x] + 1.f;
  }
  if (v < 0.f) sink[0] = v;
}

int smem_optin() {
  static int bytes = [] {
    int device = 0, value = 0;
    cudaGetDevice(&device);
    cudaDeviceGetAttribute(&value, cudaDevAttrMaxSharedMemoryPerBlockOptin, device);
    return value;
  }();
  return bytes;
}

// Sets a kernel's shared-memory opt-in once, to the device's maximum.
template <auto Kernel>
cudaError_t configure() {
  static const cudaError_t status =
      cudaFuncSetAttribute(Kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem_optin());
  return status;
}

// What ctc_plan hands a launch, checked: S in [1, 1024], T >= 1, whole warps (at most 32) covering S at K states a
// thread, kAhead frames copied ahead, and the plan's shared bytes those of the kernel's layout above (`layout`
// bytes) and within what a block may opt into.
bool plan_ok(int seq, int states, int threads, int k, int ahead, int smem, size_t layout) {
  return states >= 1 && states <= kMaxStates && seq >= 1 && threads >= 32 && threads % 32 == 0 &&
         threads <= 32 * kMaxWarps && k >= 1 && threads <= max_threads(k) && threads * k >= states &&
         ahead == kAhead && static_cast<size_t>(smem) == layout && smem <= smem_optin();
}

// f(std::integral_constant<int, K>) for the K states a thread that the alpha kernel is built for
template <class F>
cudaError_t by_states_per_thread(int k, F&& f) {
  switch (k) {
    case 1: return f(std::integral_constant<int, 1>{});
    case 3: return f(std::integral_constant<int, 3>{});
    case 5: return f(std::integral_constant<int, 5>{});
    default: return cudaErrorInvalidValue;
  }
}

template <class Kernel>
cudaError_t attributes(Kernel* kernel, int* registers, int* local_bytes) {
  cudaFuncAttributes attr;
  const cudaError_t err = cudaFuncGetAttributes(&attr, kernel);
  if (err != cudaSuccess) return err;
  *registers = attr.numRegs;
  *local_bytes = static_cast<int>(attr.localSizeBytes);
  return cudaSuccess;
}

}  // namespace

// threads, states_per_thread, ahead and smem_bytes: ops/cuda/ctc.py::ctc_plan(states, "alpha")
extern "C" int ctc_alpha(const float* emit, const uint8_t* can_skip, const int* ext_len, const int* input_len,
                         float* alpha, int batch, int seq, int states, int threads, int states_per_thread, int ahead,
                         int smem_bytes, void* stream) {
  if (!plan_ok(seq, states, threads, states_per_thread, ahead, smem_bytes,
               shared_bytes(alpha_edge_stride(states_per_thread, threads / 32), 1, threads, states_per_thread))) {
    return cudaErrorInvalidValue;
  }
  return by_states_per_thread(states_per_thread, [&](auto k) {
    const cudaError_t err = configure<ctc_alpha_kernel<decltype(k)::value>>();
    if (err != cudaSuccess || batch < 1) return err;
    ctc_alpha_kernel<decltype(k)::value><<<batch, threads, smem_bytes, static_cast<cudaStream_t>(stream)>>>(
        emit, can_skip, ext_len, input_len, alpha, seq, states);
    return cudaGetLastError();
  });
}

// threads, ahead and smem_bytes: ops/cuda/ctc.py::ctc_plan(states, "beta") (one state a thread)
extern "C" int ctc_beta(const float* emit, const float* alpha, const uint8_t* can_skip, const int* ext_len,
                        const int* input_len, const float* ll, const float* g, float* demit, int batch, int seq,
                        int states, int threads, int ahead, int smem_bytes, void* stream) {
  if (!plan_ok(seq, states, threads, 1, ahead, smem_bytes, shared_bytes(kMaxWarps, 2, threads, 1))) {
    return cudaErrorInvalidValue;
  }
  const cudaError_t err = configure<ctc_beta_kernel>();
  if (err != cudaSuccess || batch < 1) return err;
  ctc_beta_kernel<<<batch, threads, smem_bytes, static_cast<cudaStream_t>(stream)>>>(
      emit, alpha, can_skip, ext_len, input_len, ll, g, demit, seq, states);
  return cudaGetLastError();
}

// beta (0: the alpha kernel), states a thread (1 for beta) → registers a thread and local memory a thread
// (non-zero: spills or a stack frame) of that build (host only; no launch)
extern "C" int ctc_kernel_attributes(int beta, int states_per_thread, int* registers, int* local_bytes) {
  if (beta) {
    return states_per_thread == 1 ? attributes(ctc_beta_kernel, registers, local_bytes) : cudaErrorInvalidValue;
  }
  return by_states_per_thread(states_per_thread, [&](auto k) {
    return attributes(ctc_alpha_kernel<decltype(k)::value>, registers, local_bytes);
  });
}

// iters passes of ctc_step_probe_kernel in one block of `threads` (a measurement)
extern "C" int ctc_step_probe(int iters, int threads, float* sink, void* stream) {
  if (threads < 1 || threads > 1024) return cudaErrorInvalidValue;
  ctc_step_probe_kernel<<<1, threads, 0, static_cast<cudaStream_t>(stream)>>>(iters, sink);
  return cudaGetLastError();
}

// CTC alpha (forward) and beta (backward) recursions over a padded batch,
// for sm_90a.
//
// Replace nn_conformer_for_speech_recognition_tpu/ops/pallas/ctc.py:
// _alpha_kernel and _beta_kernel.  Both walk the S = 2L+1 blank-interleaved
// states of one batch row in log space:
//   alpha_t[s] = logaddexp(alpha[s], alpha[s-1], canskip[s] ? alpha[s-2])
//                + emit_t[s]                       (t < input length)
//   beta_t[s]  = logaddexp(eb[s], eb[s+1], canskip[s+2] ? eb[s+2]),
//                eb = emit_{t+1} + beta_{t+1}      (t < input length - 1)
// with states at or beyond ext_len held at LOG_EPS, alpha carried and the
// end-state beta init carried through the padded frames, and
//   demit_t[s] = g * exp(min(alpha_t[s] + beta_t[s] - ll, 0))
// on valid frames and states (0 elsewhere).  The clamp keeps rows with no
// valid alignment (ll = LOG_EPS) finite; their cotangent g is 0 under
// zero_infinity.
//
// One block per batch row, one thread per state (S <= 1024; the wrapper
// rejects more), T sequential steps.  Each thread keeps its own state in a
// register; the neighbours it needs (s-1, s-2 or s+1, s+2) come from a
// double-buffered row in shared memory, one barrier per step.  Layout is
// (B, T, S) float32, written whole: the beta kernel reads alpha back.
// Bound on the H100: the T steps are sequential and each is a handful of
// exp/log per state, so a launch is latency-bound (B blocks on 132 SMs);
// many rows per block or a warp per row are later work.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr float LOG_EPS = -1e30f;

__device__ __forceinline__ float logaddexp3(float a, float b, float c) {
  const float m = fmaxf(fmaxf(a, b), c);
  if (m <= LOG_EPS) return LOG_EPS;
  const float s = expf(a - m) + expf(b - m) + expf(c - m);
  return m + logf(fmaxf(s, 1e-37f));
}

__global__ void ctc_alpha_kernel(const float* __restrict__ emit, const uint8_t* __restrict__ can_skip,
                                 const int* __restrict__ ext_len, const int* __restrict__ input_len,
                                 float* __restrict__ alpha, int seq, int states) {
  extern __shared__ float buf[];  // [2][states]
  const int b = blockIdx.x;
  const int s = threadIdx.x;
  const bool in = s < states;
  const int len = input_len[b];
  const bool valid = in && s < ext_len[b];
  const bool skip = in && s >= 2 && can_skip[static_cast<size_t>(b) * states + s];
  const float* e = emit + static_cast<size_t>(b) * seq * states;
  float* out = alpha + static_cast<size_t>(b) * seq * states;

  // t = 0 is the init whatever the row's length
  float a = (valid && s < 2) ? e[s] : LOG_EPS;
  if (in) {
    buf[s] = a;
    out[s] = a;
  }
  __syncthreads();
  int cur = 0;
  for (int t = 1; t < seq; ++t) {
    if (in) {
      if (t < len) {
        const float* prev = buf + cur * states;
        const float s1 = s >= 1 ? prev[s - 1] : LOG_EPS;
        const float s2 = skip ? prev[s - 2] : LOG_EPS;
        a = valid ? logaddexp3(a, s1, s2) + e[static_cast<size_t>(t) * states + s] : LOG_EPS;
      }
      buf[(cur ^ 1) * states + s] = a;
      out[static_cast<size_t>(t) * states + s] = a;
    }
    cur ^= 1;
    __syncthreads();
  }
}

__global__ void ctc_beta_kernel(const float* __restrict__ emit, const float* __restrict__ alpha,
                                const uint8_t* __restrict__ can_skip, const int* __restrict__ ext_len,
                                const int* __restrict__ input_len, const float* __restrict__ ll,
                                const float* __restrict__ g, float* __restrict__ demit, int seq,
                                int states) {
  extern __shared__ float buf[];  // [2][states + 2]: eb, then two LOG_EPS pads
  const int b = blockIdx.x;
  const int s = threadIdx.x;
  const int stride = states + 2;
  const bool in = s < states;
  const int len = min(input_len[b], seq);
  const int elen = ext_len[b];
  const bool valid = in && s < elen;
  const bool fin = in && (s == elen - 1 || (s == elen - 2 && elen >= 2));
  const bool skip2 = in && s + 2 < states && can_skip[static_cast<size_t>(b) * states + s + 2];
  const float llb = ll[b];
  const float gb = g[b];
  const float* e = emit + static_cast<size_t>(b) * seq * states;
  const float* al = alpha + static_cast<size_t>(b) * seq * states;
  float* out = demit + static_cast<size_t>(b) * seq * states;
  if (s < 2) {
    buf[states + s] = LOG_EPS;
    buf[stride + states + s] = LOG_EPS;
  }

  // t = T-1 is the init step: the end states
  float beta = fin ? 0.f : LOG_EPS;
  int cur = 0;
  for (int t = seq - 1; t >= 0; --t) {
    if (t < len - 1) {  // uniform across the block: a transition into t+1 exists
      float* eb = buf + cur * stride;
      if (in) eb[s] = valid ? e[static_cast<size_t>(t + 1) * states + s] + beta : LOG_EPS;
      __syncthreads();
      if (in) {
        const float nb = logaddexp3(eb[s], eb[s + 1], skip2 ? eb[s + 2] : LOG_EPS);
        beta = valid ? nb : LOG_EPS;
      }
      cur ^= 1;
    }
    if (in) {
      float d = 0.f;
      if (t < len && valid) d = gb * expf(fminf(al[static_cast<size_t>(t) * states + s] + beta - llb, 0.f));
      out[static_cast<size_t>(t) * states + s] = d;
    }
  }
}

int threads_for(int states) { return ((states + 31) / 32) * 32; }

}  // namespace

extern "C" int ctc_alpha(const float* emit, const uint8_t* can_skip, const int* ext_len,
                         const int* input_len, float* alpha, int batch, int seq, int states,
                         void* stream) {
  if (states < 1 || states > 1024 || seq < 1) return cudaErrorInvalidValue;
  const size_t smem = sizeof(float) * 2 * states;
  ctc_alpha_kernel<<<batch, threads_for(states), smem, static_cast<cudaStream_t>(stream)>>>(
      emit, can_skip, ext_len, input_len, alpha, seq, states);
  return cudaGetLastError();
}

extern "C" int ctc_beta(const float* emit, const float* alpha, const uint8_t* can_skip,
                        const int* ext_len, const int* input_len, const float* ll, const float* g,
                        float* demit, int batch, int seq, int states, void* stream) {
  if (states < 1 || states > 1024 || seq < 1) return cudaErrorInvalidValue;
  const size_t smem = sizeof(float) * 2 * (states + 2);
  ctc_beta_kernel<<<batch, threads_for(states), smem, static_cast<cudaStream_t>(stream)>>>(
      emit, alpha, can_skip, ext_len, input_len, ll, g, demit, seq, states);
  return cudaGetLastError();
}

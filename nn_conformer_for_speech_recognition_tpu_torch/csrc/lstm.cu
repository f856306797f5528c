// One LSTM direction over a padded batch, forward only, for sm_90a.
//
// Replaces nn_conformer_for_speech_recognition_tpu/ops/pallas/lstm.py:
// _fwd_kernel.  For each step t (t = T-1..0 when reverse):
//   gates = xw[b][t] + h @ w_hh        (i, f, g, o blocks of H columns)
//   c' = sigmoid(f) * c + sigmoid(i) * tanh(g);  h' = sigmoid(o) * tanh(c')
// Rows freeze once t >= length: a padded step emits the carried h, so the
// reverse direction starts at each row's own len-1.
//
// One block per batch row runs all T steps (a persistent loop).  Thread j
// owns hidden unit j: it computes the four gate columns j, H+j, 2H+j, 3H+j,
// so the cell update needs no exchange of gates; only h goes through shared
// memory (double-buffered: one barrier per step).  h and c stay in float32.
// Bound on the H100: every step reads all of w_hh (H x 4H floats, 1.6 MB for
// Conformer-M) from L2, which no SM's shared memory can hold; splitting it
// over a thread-block cluster is later work.

#include <cuda_runtime.h>

namespace {

__device__ __forceinline__ float sigmoidf(float x) { return 1.f / (1.f + expf(-x)); }

__global__ void lstm_fwd_kernel(const float* __restrict__ xw, const float* __restrict__ w_hh,
                                const int* __restrict__ lengths, float* __restrict__ h_out,
                                int seq, int hidden, int reverse) {
  extern __shared__ float h_buf[];  // [2][hidden]
  const int b = blockIdx.x;
  const int j = threadIdx.x;
  const int len = lengths[b];
  const int h4 = 4 * hidden;
  float h = 0.f, c = 0.f;
  if (j < hidden) h_buf[j] = 0.f;
  __syncthreads();

  int cur = 0;
  for (int step = 0; step < seq; ++step) {
    const int t = reverse ? seq - 1 - step : step;
    if (j < hidden) {
      if (t < len) {  // uniform across the block
        const float* hp = h_buf + cur * hidden;
        float gi = 0.f, gf = 0.f, gg = 0.f, go = 0.f;
#pragma unroll 4
        for (int kk = 0; kk < hidden; ++kk) {
          const float hk = hp[kk];
          const float* w = w_hh + static_cast<size_t>(kk) * h4 + j;
          gi = fmaf(hk, __ldg(w), gi);
          gf = fmaf(hk, __ldg(w + hidden), gf);
          gg = fmaf(hk, __ldg(w + 2 * hidden), gg);
          go = fmaf(hk, __ldg(w + 3 * hidden), go);
        }
        const float* x = xw + (static_cast<size_t>(b) * seq + t) * h4 + j;
        const float ig = sigmoidf(x[0] + gi);
        const float fg = sigmoidf(x[hidden] + gf);
        const float cg = tanhf(x[2 * hidden] + gg);
        const float og = sigmoidf(x[3 * hidden] + go);
        c = fg * c + ig * cg;
        h = og * tanhf(c);
      }
      h_buf[(cur ^ 1) * hidden + j] = h;
      h_out[(static_cast<size_t>(b) * seq + t) * hidden + j] = h;
    }
    cur ^= 1;
    __syncthreads();
  }
}

}  // namespace

extern "C" int lstm_fwd(const float* xw, const float* w_hh, const int* lengths, float* h_out,
                        int batch, int seq, int hidden, int reverse, void* stream) {
  if (hidden < 1 || hidden > 1024) return cudaErrorInvalidValue;
  const int threads = ((hidden + 31) / 32) * 32;
  const size_t smem = sizeof(float) * 2 * hidden;
  lstm_fwd_kernel<<<batch, threads, smem, static_cast<cudaStream_t>(stream)>>>(
      xw, w_hh, lengths, h_out, seq, hidden, reverse);
  return cudaGetLastError();
}

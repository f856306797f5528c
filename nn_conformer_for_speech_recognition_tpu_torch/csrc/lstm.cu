// One LSTM direction over a padded batch, forward and backward, for sm_90a.
//
// lstm_fwd replaces nn_conformer_for_speech_recognition_tpu/ops/pallas/lstm.py:
// _fwd_kernel.  For each step t (t = T-1..0 when reverse):
//   gates = xw[b][t] + h @ w_hh        (i, f, g, o blocks of H columns)
//   c' = sigmoid(f) * c + sigmoid(i) * tanh(g);  h' = sigmoid(o) * tanh(c')
// Rows freeze once t >= length: a padded step emits the carried h (and c),
// so the reverse direction starts at each row's own len-1.  The training
// variant (c_out, gates_out not null) also stores c_t and the
// post-activation gates (zeros at padded steps, which the backward never
// reads).  It is a separate template instantiation: with null pointers the
// inference path stores h only, with no added traffic or branch.
//
// One block per batch row runs all T steps (a persistent loop).  Thread j
// owns hidden unit j: it computes the four gate columns j, H+j, 2H+j, 3H+j,
// so the cell update needs no exchange of gates; only h goes through shared
// memory (double-buffered: one barrier per step).  h and c stay in float32.
// Bound on the H100: every step reads all of w_hh (H x 4H floats, 1.6 MB for
// Conformer-M) from L2, which no SM's shared memory can hold; splitting it
// over a thread-block cluster is later work.  The reads are latency-bound
// (16 blocks, 10 warps each), so the inner loops keep many loads in flight:
// unrolled 16 times, the forward takes 6.8 ms per direction at B=16, T=235,
// H=320 on an H100 (12.6 ms unrolled 4 times); the backward's product is
// split into four partial sums for the same reason (6.4 ms against 12.8).
// Small changes to these loops can halve their speed: time them again.
//
// lstm_bwd and lstm_dwhh replace ops/pallas/lstm.py:_bwd_kernel (BPTT from
// the saved gates, c and h).  lstm_bwd walks the steps in the opposite
// order of the forward, thread j again owning unit j:
//   dh_tot = dh + gout_t;  do = dh_tot tanh(c_t) o(1-o)
//   dc_t = dc + dh_tot o (1 - tanh(c_t)^2)
//   di = dc_t g i(1-i);  df = dc_t c_prev f(1-f);  dg = dc_t i (1-g^2)
//   dxw_t = (di, df, dg, do);  dh = dxw_t @ w_hh^T;  dc = dc_t f
// where c_prev is c at the previous step in SEQUENCE order (t+1 for the
// reverse direction).  On a padded step dxw_t = 0 and dh, dc pass through
// unchanged.  The recurrent product reads w_hh^T (4H x H), so thread j's
// loads are coalesced across the warp; the four dgates of the step go
// through a double-buffered row of 4H floats in shared memory.  Bound: as
// the forward, w_hh re-read from L2 at every step by B blocks.
//
// The TPU kernel accumulates dW_hh = sum_t h_prev^T dgates_t inside the
// recurrence.  Here it is hoisted out of it: once dxw is complete it is one
// (H x B*T) . (B*T x 4H) product, lstm_dwhh, a shared-memory tiled float32
// GEMM (64 x 64 tiles, 4 x 4 outputs per thread) whose A-tile loader reads
// h_prev straight from h by index (h[t-1], or h[t+1] when reverse; 0 at the
// sequence start), so no shifted copy of h is made.  About 3.1 GFLOP per
// direction at Conformer-M; on CUDA cores, no tensor cores yet.

#include <cuda_runtime.h>

namespace {

__device__ __forceinline__ float sigmoidf(float x) { return 1.f / (1.f + expf(-x)); }

// kSave: the training variant, which also stores c_t and the gates
template <bool kSave>
__global__ void lstm_fwd_kernel(const float* __restrict__ xw, const float* __restrict__ w_hh,
                                const int* __restrict__ lengths, float* __restrict__ h_out,
                                float* __restrict__ c_out, float* __restrict__ gates_out,
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
      const size_t row = static_cast<size_t>(b) * seq + t;
      if (t < len) {  // uniform across the block
        const float* hp = h_buf + cur * hidden;
        float gi = 0.f, gf = 0.f, gg = 0.f, go = 0.f;
#pragma unroll 16  // 64 loads in flight
        for (int kk = 0; kk < hidden; ++kk) {
          const float hk = hp[kk];
          const float* w = w_hh + static_cast<size_t>(kk) * h4 + j;
          gi = fmaf(hk, __ldg(w), gi);
          gf = fmaf(hk, __ldg(w + hidden), gf);
          gg = fmaf(hk, __ldg(w + 2 * hidden), gg);
          go = fmaf(hk, __ldg(w + 3 * hidden), go);
        }
        const float* x = xw + row * h4 + j;
        const float ig = sigmoidf(x[0] + gi);
        const float fg = sigmoidf(x[hidden] + gf);
        const float cg = tanhf(x[2 * hidden] + gg);
        const float og = sigmoidf(x[3 * hidden] + go);
        c = fg * c + ig * cg;
        h = og * tanhf(c);
        if constexpr (kSave) {
          float* gt = gates_out + row * h4 + j;
          gt[0] = ig;
          gt[hidden] = fg;
          gt[2 * hidden] = cg;
          gt[3 * hidden] = og;
        }
      } else if constexpr (kSave) {
        float* gt = gates_out + row * h4 + j;
        gt[0] = gt[hidden] = gt[2 * hidden] = gt[3 * hidden] = 0.f;
      }
      h_buf[(cur ^ 1) * hidden + j] = h;
      h_out[row * hidden + j] = h;
      if constexpr (kSave) c_out[row * hidden + j] = c;
    }
    cur ^= 1;
    __syncthreads();
  }
}

__global__ void lstm_bwd_kernel(const float* __restrict__ gout, const float* __restrict__ gates,
                                const float* __restrict__ c_all, const float* __restrict__ w_hh_t,
                                const int* __restrict__ lengths, float* __restrict__ dxw, int seq,
                                int hidden, int reverse) {
  extern __shared__ float dg_buf[];  // [2][4 * hidden]
  const int b = blockIdx.x;
  const int j = threadIdx.x;
  const int len = lengths[b];
  const int h4 = 4 * hidden;
  float dh = 0.f, dc = 0.f;

  int cur = 0;
  for (int step = 0; step < seq; ++step) {
    // the forward visited t = step (t = seq-1-step when reverse): walk it back
    const int t = reverse ? step : seq - 1 - step;
    const bool active = t < len;  // uniform across the block
    const size_t row = static_cast<size_t>(b) * seq + t;
    if (j < hidden) {
      const float dh_tot = dh + gout[row * hidden + j];
      float* dx = dxw + row * h4 + j;
      if (active) {
        const float* gt = gates + row * h4 + j;
        const float ig = gt[0], fg = gt[hidden], cg = gt[2 * hidden], og = gt[3 * hidden];
        const int tp = reverse ? t + 1 : t - 1;  // previous step in sequence order
        const float cp = (tp >= 0 && tp < seq) ? c_all[(static_cast<size_t>(b) * seq + tp) * hidden + j] : 0.f;
        const float th = tanhf(c_all[row * hidden + j]);
        const float d_o = dh_tot * th * og * (1.f - og);
        const float dct = dc + dh_tot * og * (1.f - th * th);
        const float d_i = dct * cg * ig * (1.f - ig);
        const float d_f = dct * cp * fg * (1.f - fg);
        const float d_g = dct * ig * (1.f - cg * cg);
        float* sh = dg_buf + cur * h4 + j;
        dx[0] = sh[0] = d_i;
        dx[hidden] = sh[hidden] = d_f;
        dx[2 * hidden] = sh[2 * hidden] = d_g;
        dx[3 * hidden] = sh[3 * hidden] = d_o;
        dc = dct * fg;
      } else {  // h_t = h_{t-1} and c_t = c_{t-1}: the cotangents pass through
        dx[0] = dx[hidden] = dx[2 * hidden] = dx[3 * hidden] = 0.f;
        dh = dh_tot;
      }
    }
    if (active) {
      __syncthreads();
      if (j < hidden) {
        const float* d = dg_buf + cur * h4;
        const float* w = w_hh_t + j;
        // four partial sums (4H is a multiple of 4), unrolled 8 times: 32
        // loads in flight
        float a0 = 0.f, a1 = 0.f, a2 = 0.f, a3 = 0.f;
#pragma unroll 8
        for (int k = 0; k < h4; k += 4) {
          a0 = fmaf(d[k], __ldg(w + static_cast<size_t>(k) * hidden), a0);
          a1 = fmaf(d[k + 1], __ldg(w + static_cast<size_t>(k + 1) * hidden), a1);
          a2 = fmaf(d[k + 2], __ldg(w + static_cast<size_t>(k + 2) * hidden), a2);
          a3 = fmaf(d[k + 3], __ldg(w + static_cast<size_t>(k + 3) * hidden), a3);
        }
        dh = a0 + a1 + a2 + a3;
      }
      cur ^= 1;
    }
  }
}

constexpr int TM = 64, TN = 64, TK = 16, GEMM_THREADS = 256;

// dw[m][n] = sum_r h_prev[r][m] * dxw[r][n], r = b * seq + t over all rows
__global__ void __launch_bounds__(GEMM_THREADS)
lstm_dwhh_kernel(const float* __restrict__ h, const float* __restrict__ dxw, float* __restrict__ dw,
                 int batch, int seq, int hidden, int reverse) {
  __shared__ float as[TK][TM];
  __shared__ float bs[TK][TN];
  const int h4 = 4 * hidden;
  const int rows = batch * seq;
  const int m0 = blockIdx.y * TM, n0 = blockIdx.x * TN;
  const int tid = threadIdx.x;
  const int tm = (tid / (TN / 4)) * 4, tn = (tid % (TN / 4)) * 4;
  float acc[4][4] = {};

  for (int r0 = 0; r0 < rows; r0 += TK) {
    for (int e = tid; e < TK * TM; e += GEMM_THREADS) {
      const int rr = e / TM, cc = e % TM;
      const int r = r0 + rr;
      float a = 0.f, bv = 0.f;
      if (r < rows) {
        const int bi = r / seq, t = r % seq;
        const int tp = reverse ? t + 1 : t - 1;  // previous step in sequence order
        if (m0 + cc < hidden && tp >= 0 && tp < seq)
          a = h[(static_cast<size_t>(bi) * seq + tp) * hidden + m0 + cc];
        if (n0 + cc < h4) bv = dxw[static_cast<size_t>(r) * h4 + n0 + cc];
      }
      as[rr][cc] = a;
      bs[rr][cc] = bv;
    }
    __syncthreads();
#pragma unroll
    for (int k = 0; k < TK; ++k) {
      float av[4], bw[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        av[i] = as[k][tm + i];
        bw[i] = bs[k][tn + i];
      }
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int q = 0; q < 4; ++q) acc[i][q] = fmaf(av[i], bw[q], acc[i][q]);
    }
    __syncthreads();
  }
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const int m = m0 + tm + i, n = n0 + tn + q;
      if (m < hidden && n < h4) dw[static_cast<size_t>(m) * h4 + n] = acc[i][q];
    }
}

int threads_for(int hidden) { return ((hidden + 31) / 32) * 32; }

}  // namespace

extern "C" int lstm_fwd(const float* xw, const float* w_hh, const int* lengths, float* h_out,
                        float* c_out, float* gates_out, int batch, int seq, int hidden, int reverse,
                        void* stream) {
  if (hidden < 1 || hidden > 1024) return cudaErrorInvalidValue;
  if ((c_out == nullptr) != (gates_out == nullptr)) return cudaErrorInvalidValue;
  const size_t smem = sizeof(float) * 2 * hidden;
  const auto kernel = c_out != nullptr ? lstm_fwd_kernel<true> : lstm_fwd_kernel<false>;
  kernel<<<batch, threads_for(hidden), smem, static_cast<cudaStream_t>(stream)>>>(
      xw, w_hh, lengths, h_out, c_out, gates_out, seq, hidden, reverse);
  return cudaGetLastError();
}

extern "C" int lstm_bwd(const float* gout, const float* gates, const float* c_all,
                        const float* w_hh_t, const int* lengths, float* dxw, int batch, int seq,
                        int hidden, int reverse, void* stream) {
  if (hidden < 1 || hidden > 1024) return cudaErrorInvalidValue;
  const size_t smem = sizeof(float) * 2 * 4 * hidden;  // 32 KB at H = 1024
  lstm_bwd_kernel<<<batch, threads_for(hidden), smem, static_cast<cudaStream_t>(stream)>>>(
      gout, gates, c_all, w_hh_t, lengths, dxw, seq, hidden, reverse);
  return cudaGetLastError();
}

extern "C" int lstm_dwhh(const float* h, const float* dxw, float* dw, int batch, int seq,
                         int hidden, int reverse, void* stream) {
  if (hidden < 1 || batch < 1 || seq < 1) return cudaErrorInvalidValue;
  const dim3 grid((4 * hidden + TN - 1) / TN, (hidden + TM - 1) / TM);
  lstm_dwhh_kernel<<<grid, GEMM_THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      h, dxw, dw, batch, seq, hidden, reverse);
  return cudaGetLastError();
}

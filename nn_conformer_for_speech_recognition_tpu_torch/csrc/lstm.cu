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
// (H x B*T) . (B*T x 4H) product, lstm_dwhh, whose A-tile loader reads
// h_prev straight from h by index (h[t-1], or h[t+1] when reverse; 0 at the
// sequence start), so no shifted copy of h is made.  About 3.1 GFLOP per
// direction at Conformer-M (H=320, B*T=3760) on 3.9 + 19.3 MB of inputs:
// bound by operations.  Design:
// - split-K: each block owns one 64 x 128 output tile and one contiguous
//   slice of the B*T rows (lstm_dwhh_plan picks the slice count so that the
//   grid covers two waves of the card's 132 SMs); it writes a float32
//   partial tile, and lstm_dwhh_reduce sums the slices in slice order.  No
//   atomics: two launches on the same inputs give bit-equal dW_hh.
// - tensor cores at float32 accuracy: mma.sync m16n8k8 TF32 with float32
//   accumulation and the 3xTF32 split x = big + small, big = tf32(x),
//   small = tf32(x - big); each product is big*big + big*small + small*big
//   (the small*small term, 2^-22 relative, is dropped).
// - cp.async: slabs of 32 rows of h_prev and dxw go to shared memory in
//   16-byte copies (4-byte ones when H % 4 != 0) through a two-stage ring,
//   the next slab in flight during this one's products; rows past the
//   slice, h_prev at the sequence start and columns past H or 4H are
//   zero-filled by the copy itself.  A slab row's h_prev offset is worked
//   out once per row, by one thread, into a shared table.
// - shared rows are padded to 8 floats mod 32 banks, so the fragment reads
//   are free of bank conflicts.

#include <cuda_runtime.h>

#include <algorithm>

#include "tensor_core.cuh"

namespace {

using namespace tc;

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

// lstm_dwhh: the tile shape, two warps along M and four along N, each warp
// 32 x 32 outputs (2 x 4 mma tiles of 16 x 8); the most slices of the rows
constexpr int kTileM = 64, kTileN = 128, kSlab = 32, kDwThreads = 256, kMaxSlices = 16;
constexpr int kLdA = kTileM + 8, kLdB = kTileN + 8;  // = 8 (mod 32) floats
constexpr int kStageFloats = kSlab * (kLdA + kLdB);
constexpr size_t kDwSmem = 2 * kStageFloats * sizeof(float);  // 53,248 bytes: two stages

// part[slice][m][n] = sum over the slice's rows r of h_prev[r][m] * dxw[r][n].
// kVecA: 4 when H % 4 == 0 (h rows in 16-byte copies), else 1.
template <int kVecA>
__global__ void __launch_bounds__(kDwThreads)
lstm_dwhh_kernel(const float* __restrict__ h, const float* __restrict__ dxw, float* __restrict__ part,
                 int batch, int seq, int hidden, int reverse, int rows_per_slice) {
  extern __shared__ __align__(16) float dw_smem[];  // two stages of [kSlab][kLdA] then [kSlab][kLdB]
  __shared__ long long a_src[2][kSlab];             // h offset of each slab row's h_prev; -1: it is 0

  const int h4 = 4 * hidden;
  const int n0 = blockIdx.x * kTileN, m0 = blockIdx.y * kTileM;
  const int r_begin = blockIdx.z * rows_per_slice;
  const int r_end = min(batch * seq, r_begin + rows_per_slice);
  const int slabs = (r_end - r_begin + kSlab - 1) / kSlab;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int wm = (warp >> 2) * 32, wn = (warp & 3) * 32;
  const int g = lane >> 2, q = lane & 3;

  // thread tid < kSlab tracks the row r_begin + slab * kSlab + tid: (b, t) by
  // one division here, then by steps of kSlab
  int row_b = 0, row_t = 0;
  if (tid < kSlab) {
    row_b = (r_begin + tid) / seq;
    row_t = r_begin + tid - row_b * seq;
  }
  auto fill_source = [&](int slab) {
    if (tid < kSlab) {
      long long off = -1;
      const int tp = reverse ? row_t + 1 : row_t - 1;  // previous step in sequence order
      if (r_begin + slab * kSlab + tid < r_end && tp >= 0 && tp < seq)
        off = (static_cast<long long>(row_b) * seq + tp) * hidden;
      a_src[slab & 1][tid] = off;
      row_t += kSlab;
      while (row_t >= seq) {
        row_t -= seq;
        ++row_b;
      }
    }
  };
  auto load_slab = [&](int slab) {
    float* as = dw_smem + (slab & 1) * kStageFloats;
    float* bs = as + kSlab * kLdA;
    const int r0 = r_begin + slab * kSlab;
    constexpr int kChunksA = kTileM / kVecA, kRowsA = kDwThreads / kChunksA;
    const int ca = (tid % kChunksA) * kVecA;
#pragma unroll
    for (int i = 0; i < kSlab / kRowsA; ++i) {
      const int rr = tid / kChunksA + i * kRowsA;
      const long long off = a_src[slab & 1][rr];
      const bool valid = off >= 0 && m0 + ca < hidden;
      const float* src = valid ? h + off + m0 + ca : h;
      if constexpr (kVecA == 4) {
        cp_async16(as + rr * kLdA + ca, src, valid);
      } else {
        cp_async4(as + rr * kLdA + ca, src, valid);
      }
    }
    constexpr int kChunksB = kTileN / 4, kRowsB = kDwThreads / kChunksB;
    const int cb = (tid % kChunksB) * 4;
#pragma unroll
    for (int i = 0; i < kSlab / kRowsB; ++i) {
      const int rr = tid / kChunksB + i * kRowsB;
      const int r = r0 + rr;
      const bool valid = r < r_end && n0 + cb < h4;  // 4H is a multiple of 4: a chunk is all in or all out
      cp_async16(bs + rr * kLdB + cb, valid ? dxw + static_cast<size_t>(r) * h4 + n0 + cb : dxw, valid);
    }
  };

  float acc[2][4][4] = {};
  fill_source(0);
  __syncthreads();
  load_slab(0);
  cp_async_commit();
  if (slabs > 1) fill_source(1);
  for (int slab = 0; slab < slabs; ++slab) {
    __syncthreads();  // a_src for slab + 1 is written; slab - 1's tiles are read
    if (slab + 1 < slabs) load_slab(slab + 1);
    cp_async_commit();  // an empty group on the last slab keeps the count
    cp_async_wait_one();
    __syncthreads();  // slab's copies, from every thread, have landed
    const float* as = dw_smem + (slab & 1) * kStageFloats;
    const float* bs = as + kSlab * kLdA;
#pragma unroll
    for (int kk = 0; kk < kSlab; kk += 8) {
      unsigned a_big[2][4], a_small[2][4], b_big[4][2], b_small[4][2];
#pragma unroll
      for (int mi = 0; mi < 2; ++mi) {
        const float* a = as + (kk + q) * kLdA + wm + mi * 16 + g;
        split_tf32(a[0], a_big[mi][0], a_small[mi][0]);               // (m = g,     k = q)
        split_tf32(a[8], a_big[mi][1], a_small[mi][1]);               // (m = g + 8, k = q)
        split_tf32(a[4 * kLdA], a_big[mi][2], a_small[mi][2]);        // (m = g,     k = q + 4)
        split_tf32(a[4 * kLdA + 8], a_big[mi][3], a_small[mi][3]);    // (m = g + 8, k = q + 4)
      }
#pragma unroll
      for (int ni = 0; ni < 4; ++ni) {
        const float* b = bs + (kk + q) * kLdB + wn + ni * 8 + g;
        split_tf32(b[0], b_big[ni][0], b_small[ni][0]);         // (k = q,     n = g)
        split_tf32(b[4 * kLdB], b_big[ni][1], b_small[ni][1]);  // (k = q + 4, n = g)
      }
#pragma unroll
      for (int mi = 0; mi < 2; ++mi)
#pragma unroll
        for (int ni = 0; ni < 4; ++ni) {
          mma_tf32(acc[mi][ni], a_small[mi], b_big[ni]);
          mma_tf32(acc[mi][ni], a_big[mi], b_small[ni]);
          mma_tf32(acc[mi][ni], a_big[mi], b_big[ni]);
        }
    }
    if (slab + 2 < slabs) fill_source(slab + 2);  // a_src[slab & 1] was last read issuing this slab
  }

  float* out = part + static_cast<size_t>(blockIdx.z) * hidden * h4;
#pragma unroll
  for (int mi = 0; mi < 2; ++mi)
#pragma unroll
    for (int ni = 0; ni < 4; ++ni) {
      const int n = n0 + wn + ni * 8 + 2 * q;  // even, and 4H is even: n < 4H means n + 1 < 4H
      if (n >= h4) continue;
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int m = m0 + wm + mi * 16 + g + 8 * half;
        if (m < hidden)
          *reinterpret_cast<float2*>(out + static_cast<size_t>(m) * h4 + n) =
              make_float2(acc[mi][ni][2 * half], acc[mi][ni][2 * half + 1]);
      }
    }
}

// dw[i] = sum over s = 0, 1, ... of part[s][i], in that order
__global__ void lstm_dwhh_reduce_kernel(const float4* __restrict__ part, float4* __restrict__ dw, int n4,
                                        int slices) {
  for (int i = blockIdx.x * blockDim.x + threadIdx.x; i < n4; i += gridDim.x * blockDim.x) {
    float4 s = part[i];
    for (int k = 1; k < slices; ++k) {
      const float4 p = part[static_cast<size_t>(k) * n4 + i];
      s.x += p.x;
      s.y += p.y;
      s.z += p.z;
      s.w += p.w;
    }
    dw[i] = s;
  }
}

template <int kVecA>
cudaError_t launch_dwhh(const float* h, const float* dxw, float* part, int batch, int seq, int hidden,
                        int reverse, int rows_per_slice, int slices, cudaStream_t stream) {
  static bool configured = false;
  if (!configured) {
    const cudaError_t err = cudaFuncSetAttribute(lstm_dwhh_kernel<kVecA>,
                                                 cudaFuncAttributeMaxDynamicSharedMemorySize,
                                                 static_cast<int>(kDwSmem));
    if (err != cudaSuccess) return err;
    configured = true;
  }
  const dim3 grid((4 * hidden + kTileN - 1) / kTileN, (hidden + kTileM - 1) / kTileM, slices);
  lstm_dwhh_kernel<kVecA><<<grid, kDwThreads, kDwSmem, stream>>>(h, dxw, part, batch, seq, hidden, reverse,
                                                                  rows_per_slice);
  return cudaGetLastError();
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

// The split of lstm_dwhh over the B*T rows: enough slices that the grid holds
// two blocks for each of the card's `sms` SMs, at most kMaxSlices and at most
// one a slab; a slice is a whole number of slabs, and none is empty.  The
// caller allocates the partials (slices x H x 4H floats) when slices > 1.
extern "C" int lstm_dwhh_plan(int rows, int hidden, int sms, int* slices, int* rows_per_slice) {
  if (rows < 1 || hidden < 1 || sms < 1) return cudaErrorInvalidValue;
  const int tiles = ((hidden + kTileM - 1) / kTileM) * ((4 * hidden + kTileN - 1) / kTileN);
  const int slabs = (rows + kSlab - 1) / kSlab;
  const int want = std::min(std::min(kMaxSlices, slabs), (2 * sms + tiles - 1) / tiles);
  *rows_per_slice = (slabs + want - 1) / want * kSlab;
  *slices = (rows + *rows_per_slice - 1) / *rows_per_slice;
  return cudaSuccess;
}

// dW_hh into dw (H, 4H).  The B*T rows go in `slices` slices of
// rows_per_slice (a multiple of the 32-row slab; lstm_dwhh_plan) to as many
// blocks per output tile; with more than one slice, part holds slices x H x
// 4H floats of partial sums and a second kernel adds them up in slice order.
extern "C" int lstm_dwhh(const float* h, const float* dxw, float* part, float* dw, int batch, int seq,
                         int hidden, int reverse, int rows_per_slice, int slices, void* stream) {
  const long long rows = static_cast<long long>(batch) * seq;
  if (hidden < 1 || batch < 1 || seq < 1 || slices < 1 || rows_per_slice < 1 || rows_per_slice % kSlab ||
      static_cast<long long>(slices) * rows_per_slice < rows ||
      static_cast<long long>(slices - 1) * rows_per_slice >= rows || rows * 4 * hidden >= (1LL << 31) ||
      (slices > 1 && part == nullptr))
    return cudaErrorInvalidValue;
  const auto s = static_cast<cudaStream_t>(stream);
  float* out = slices > 1 ? part : dw;
  const cudaError_t err =
      hidden % 4 == 0 ? launch_dwhh<4>(h, dxw, out, batch, seq, hidden, reverse, rows_per_slice, slices, s)
                      : launch_dwhh<1>(h, dxw, out, batch, seq, hidden, reverse, rows_per_slice, slices, s);
  if (err != cudaSuccess || slices == 1) return err;
  const int n4 = hidden * hidden;  // H x 4H floats in float4s
  lstm_dwhh_reduce_kernel<<<(n4 + 255) / 256, 256, 0, s>>>(reinterpret_cast<const float4*>(part),
                                                            reinterpret_cast<float4*>(dw), n4, slices);
  return cudaGetLastError();
}

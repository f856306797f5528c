// The LSTM recurrence over a padded batch, forward and backward, for sm_90a.
//
// lstm_fwd_cluster replaces nn_conformer_for_speech_recognition_tpu/
// ops/pallas/lstm.py:_fwd_kernel for H up to 385 on an H100 (lstm_grid.cu
// past it).  For each step t (t = T-1..0 when reverse):
//   gates = xw[b][t] + h @ w_hh        (i, f, g, o blocks of H columns)
//   c' = sigmoid(f) * c + sigmoid(i) * tanh(g);  h' = sigmoid(o) * tanh(c')
// Rows freeze once t >= length: a padded step emits the carried h (and c),
// so the reverse direction starts at each row's own len-1.  The training
// variant (c_out, gates_out not null) also stores c_t and the
// post-activation gates (zeros at padded steps, which the backward never
// reads).  It is a separate template instantiation: with null pointers the
// inference path stores h only, with no added traffic or branch.
//
// lstm_bwd_cluster (lstm_grid.cu past the cluster) and lstm_dwhh replace
// ops/pallas/lstm.py:_bwd_kernel (BPTT from the saved gates, c and h),
// walking the steps in the opposite order of the forward:
//   dh_tot = dh + gout_t;  do = dh_tot tanh(c_t) o(1-o)
//   dc_t = dc + dh_tot o (1 - tanh(c_t)^2)
//   di = dc_t g i(1-i);  df = dc_t c_prev f(1-f);  dg = dc_t i (1-g^2)
//   dxw_t = (di, df, dg, do);  dh = dxw_t @ w_hh^T;  dc = dc_t f
// where c_prev is c at the previous step in SEQUENCE order (t+1 for the
// reverse direction).  On a padded step dxw_t = 0 and dh, dc pass through
// unchanged.
//
// The recurrence is a chain of T dependent steps, each a (B x H) . (H x 4H)
// product: what bounds it is the latency of one step, not bytes or FLOPs.
// The product needs all of w_hh (H x 4H float32: 1.6 MB at Conformer-M's
// H = 320), more than one SM's 227 KB of shared memory.
//
// The cluster kernels (H up to 385 on an H100: lstm_cluster_plan) split w_hh over a
// thread-block cluster of kClusterSize = 16 CTAs on 16 SMs.  A cluster holds
// one direction and one tile of up to 16 batch rows; the grid is 16 x
// ceil(B / 16) x directions, so both directions of a BiLSTM run in one
// launch, side by side.  CTA k owns the hidden units U_k = [k U, (k+1) U),
// U = ceil(H / 16) (masked past H), and their four gate columns j, H+j,
// 2H+j, 3H+j; it loads w_hh's rows restricted to those columns (H x 4U
// floats, 100 KB at H = 320) into its shared memory once, and every step:
// - forward: gates[:, cols_k] = xw[:, t, cols_k] + h_prev @ w_slice from the
//   h_prev (<= 16 x H) in its own shared memory, on the CUDA cores in float32
//   (the K of the product split over the threads in kslices slices summed
//   in slice order); the cell update of U_k (c in registers; each step's
//   xw is loaded into registers one step ahead, so its latency hides behind
//   a whole step); then h[:, U_k] goes into every peer's next h buffer by
//   distributed shared memory stores, and the cluster meets at one barrier
//   (barrier.cluster arrive.release / wait.acquire).  The h buffers are
//   double-buffered, so one barrier a step suffices.
// - backward: CTA k computes dgates for its 4|U_k| columns (dh, dc in
//   registers; gout, the gates and c loaded one step ahead), writes them to
//   dxw, forms its partial dh_k = dgates[:, cols_k]
//   @ w_slice^T (<= 16 x H) and stores each unit's share into the receive
//   buffer of the CTA that owns the unit, one slot per sender; after the
//   barrier each CTA adds up the 16 partials of its units in rank order
//   0..15.  No atomics: two launches give bit-equal dxw.  The same w_slice
//   serves, read by rows, so no transposed copy of w_hh is made.
// Steps at which every row of the tile is past its length need no product
// and no barrier: the carried state is stored (forward) or the cotangents
// passed through (backward) without a meeting.  Row groups of 4 past the
// batch are skipped at compile time (kRG), so the long-form B = 4 tile does
// a quarter of the B = 16 tile's product.  On an H100 (700 W) the forward
// takes 1.63 ms for both directions at B=16, T=235, H=320 (6.9 us a step)
// and 3.17 ms at B=4, T=938 (3.4 us), the backward 1.52 and 2.30 ms: about
// 3 us a step of fixed cost (the cluster barrier is 0.51 us of it) and ~1.2
// us for each 4-row group of the product, against a serial floor of ~2.1 us
// a step at B=16; time any edit to these loops against the parent.
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

#include <cooperative_groups.h>
#include <cuda_runtime.h>

#include <algorithm>
#include <mutex>
#include <vector>

#include "tensor_core.cuh"

namespace {

using namespace tc;

__device__ __forceinline__ float sigmoidf(float x) { return 1.f / (1.f + expf(-x)); }

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

// ---- the cluster kernels -----------------------------------------------------

namespace cg = cooperative_groups;

constexpr int kClusterSize = 16;         // CTAs per cluster (above 8: a non-portable size)
constexpr int kTileRows = 16;            // batch rows per cluster
constexpr int kClusterMaxThreads = 512;  // __launch_bounds__: at most 128 registers a thread
constexpr int kLdDg = 20;  // floats per column of the backward's dgates: 16 rows and 4 of padding (4-way bank spread)
constexpr int kClusterUnplaceable = -2;  // no cluster of kClusterSize CTAs with that shared memory fits on the card

__host__ __device__ constexpr int round4(int x) { return (x + 3) & ~3; }

// Shared-memory layout of one CTA, in floats from the start of dynamic shared
// memory (every section 16-byte aligned), and its thread count.
struct ClusterLayout {
  int hidden, units, cols, ldw, threads, kslices, kchunk;
  int w_off;                               // [hidden][ldw]: w_hh's rows on this CTA's 4U columns
  int h_off, red_off, hs_off, fwd_floats;  // forward: h [2][hidden][16], partial gates [kslices][16][cols],
                                           // this CTA's new h [16][units]
  int dg_off, recv_off, bwd_floats;        // backward: dgates [cols][kLdDg], partial dh [2][16 senders][16][units]
};

ClusterLayout cluster_layout(int hidden) {
  ClusterLayout L{};
  L.hidden = hidden;
  L.units = (hidden + kClusterSize - 1) / kClusterSize;
  L.cols = 4 * L.units;
  L.ldw = L.cols + 1;  // odd: the backward reads w_hh by rows, lanes on consecutive rows, free of bank conflicts
  // one thread per (row, unit) of the cell update and per hidden unit of the backward's product
  L.threads = (std::max(kTileRows * L.units, hidden) + 31) / 32 * 32;
  L.kslices = std::max(1, L.threads / L.cols);  // the forward's product: one thread per (slice of K, column)
  L.kchunk = (hidden + L.kslices - 1) / L.kslices;
  L.w_off = 0;
  L.h_off = round4(hidden * L.ldw);
  L.red_off = L.h_off + 2 * hidden * kTileRows;
  L.hs_off = L.red_off + L.kslices * kTileRows * L.cols;
  L.fwd_floats = L.hs_off + kTileRows * L.units;
  L.dg_off = L.h_off;
  L.recv_off = L.dg_off + L.cols * kLdDg;
  L.bwd_floats = L.recv_off + 2 * kClusterSize * kTileRows * L.units;
  return L;
}

struct ClusterFwdDirection {
  const float* xw;
  const float* w_hh;
  float* h;
  float* c;      // training variant only
  float* gates;  // training variant only
  int reverse;
};

struct ClusterFwdArgs {
  ClusterFwdDirection dir[2];
  const int* lengths;
  int batch, seq;
};

struct ClusterBwdDirection {
  const float* gout;
  const float* gates;
  const float* c;
  const float* w_hh;
  float* dxw;
  int reverse;
};

struct ClusterBwdArgs {
  ClusterBwdDirection dir[2];
  const int* lengths;
  int batch, seq;
};

// w_hh (H, 4H) restricted to the columns of units [u0, u0 + nu): local column
// g U + u holds global column g H + u0 + u (0 past the last unit)
__device__ __forceinline__ void load_w_slice(float* w, const float* __restrict__ w_hh, const ClusterLayout& L,
                                             int u0, int nu) {
  const int U = L.units;
  for (int i = threadIdx.x; i < L.hidden * L.cols; i += blockDim.x) {
    const int k = i / L.cols, lc = i - k * L.cols, g = lc / U, u = lc - g * U;
    w[k * L.ldw + lc] = u < nu ? w_hh[static_cast<size_t>(k) * 4 * L.hidden + g * L.hidden + u0 + u] : 0.f;
  }
}

// the longest row of this tile: steps at or past it are padding for every row
__device__ __forceinline__ int tile_max_length(const int* __restrict__ lengths, int b0, int rows) {
  int m = 0;
  for (int r = 0; r < rows; ++r) m = max(m, lengths[b0 + r]);
  return m;
}

// one barrier of the whole cluster, every thread of every CTA; the release /
// acquire pair orders each shared-memory access made before it (remote stores
// included) before each one made after it, across the cluster
__device__ __forceinline__ void cluster_barrier() {
  asm volatile("barrier.cluster.arrive.release.aligned;\n" ::: "memory");
  asm volatile("barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
}

// kSave: the training variant (also c_t and the gates).  kRG: groups of 4
// batch rows in a tile, ceil(min(B, 16) / 4); rows past the batch hold 0.
template <bool kSave, int kRG>
__global__ void __launch_bounds__(kClusterMaxThreads, 1)
lstm_fwd_cluster_kernel(const ClusterFwdArgs a, const ClusterLayout L) {
  extern __shared__ __align__(16) float smem[];
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = static_cast<int>(cluster.block_rank());
  const ClusterFwdDirection d = blockIdx.z ? a.dir[1] : a.dir[0];
  const int H = L.hidden, U = L.units, H4 = 4 * H, seq = a.seq;
  const int u0 = rank * U, nu = max(0, min(U, H - u0));
  const int b0 = blockIdx.y * kTileRows, rows = min(kTileRows, a.batch - b0);
  const int tid = threadIdx.x;
  float* w = smem + L.w_off;
  float* hbuf = smem + L.h_off;  // [2][H][16]: h_prev by hidden unit, 16 rows each
  float* red = smem + L.red_off;
  float* hs = smem + L.hs_off;  // [16][U]

  load_w_slice(w, d.w_hh, L, u0, nu);
  for (int i = tid; i < H * kTileRows; i += blockDim.x) hbuf[i] = 0.f;  // h before the first step
  for (int i = tid; i < kTileRows * U; i += blockDim.x) hs[i] = 0.f;
  const int max_len = tile_max_length(a.lengths, b0, rows);

  // the cell update: thread (row cr, unit cu), units fastest (coalesced rows of xw, h, c, gates)
  const int cr = tid / U, cu = tid - cr * U;
  const bool cell = tid < kTileRows * U && cr < rows && cu < nu;
  const int len = cell ? a.lengths[b0 + cr] : 0;
  const size_t row0 = static_cast<size_t>(b0 + cr) * seq;
  // the product: thread (slice ps of K, local column plc)
  const int ps = tid / L.cols, plc = tid - ps * L.cols;
  const int k_begin = ps * L.kchunk, k_end = min(H, k_begin + L.kchunk);
  // the exchange: (unit, row group) items of this CTA's new h, each sent to every peer
  const int items = nu * kRG;
  const int groups = items > 0 ? static_cast<int>(blockDim.x) / items : 0;
  const int item = items > 0 ? tid % items : 0, group = items > 0 ? tid / items : groups;
  const int xu = item / kRG, xq = item - xu * kRG;

  // a step's xw, loaded one step ahead: its latency hides behind a whole step
  auto load_xw = [&](int step, float (&x)[4]) {
    const int t = d.reverse ? seq - 1 - step : step;
    if (cell && step < seq && t < len) {
      const float* xr = d.xw + (row0 + t) * H4 + u0 + cu;
#pragma unroll
      for (int g = 0; g < 4; ++g) x[g] = xr[g * H];
    }
  };
  float h = 0.f, c = 0.f, x[4] = {}, x_next[4] = {};
  load_xw(0, x_next);
  cluster.sync();  // every CTA has started and zeroed its first h buffer
  int cur = 0;
  for (int step = 0; step < seq; ++step) {
    const int t = d.reverse ? seq - 1 - step : step;
    const size_t row = row0 + t;
    const bool on = cell && t < len;
#pragma unroll
    for (int g = 0; g < 4; ++g) x[g] = x_next[g];
    load_xw(step + 1, x_next);
    if (t >= max_len) {  // every row of the tile is past its length: carry, no product, no meeting
      if (cell) {
        d.h[row * H + u0 + cu] = h;
        if constexpr (kSave) {
          d.c[row * H + u0 + cu] = c;
          float* gt = d.gates + row * H4 + u0 + cu;
          gt[0] = gt[H] = gt[2 * H] = gt[3 * H] = 0.f;
        }
      }
      continue;
    }
    if (ps < L.kslices) {
      float acc[4 * kRG] = {};
      const float* hp = hbuf + cur * H * kTileRows;
#pragma unroll 4
      for (int k = k_begin; k < k_end; ++k) {
        const float wk = w[k * L.ldw + plc];
        const float4* hk = reinterpret_cast<const float4*>(hp + k * kTileRows);
#pragma unroll
        for (int q = 0; q < kRG; ++q) {
          const float4 v = hk[q];
          acc[4 * q] = fmaf(v.x, wk, acc[4 * q]);
          acc[4 * q + 1] = fmaf(v.y, wk, acc[4 * q + 1]);
          acc[4 * q + 2] = fmaf(v.z, wk, acc[4 * q + 2]);
          acc[4 * q + 3] = fmaf(v.w, wk, acc[4 * q + 3]);
        }
      }
#pragma unroll
      for (int r = 0; r < 4 * kRG; ++r) red[(ps * kTileRows + r) * L.cols + plc] = acc[r];
    }
    __syncthreads();
    if (cell) {
      if (on) {
        float pre[4];
#pragma unroll
        for (int g = 0; g < 4; ++g) {  // the slices' partial sums in slice order, then xw
          const float* p = red + cr * L.cols + g * U + cu;
          float s = p[0];
          for (int sl = 1; sl < L.kslices; ++sl) s += p[sl * kTileRows * L.cols];
          pre[g] = x[g] + s;
        }
        const float ig = sigmoidf(pre[0]), fg = sigmoidf(pre[1]), gg = tanhf(pre[2]), og = sigmoidf(pre[3]);
        c = fg * c + ig * gg;
        h = og * tanhf(c);
        if constexpr (kSave) {
          float* gt = d.gates + row * H4 + u0 + cu;
          gt[0] = ig;
          gt[H] = fg;
          gt[2 * H] = gg;
          gt[3 * H] = og;
        }
      } else if constexpr (kSave) {
        float* gt = d.gates + row * H4 + u0 + cu;
        gt[0] = gt[H] = gt[2 * H] = gt[3 * H] = 0.f;
      }
      hs[tid] = h;  // hs[cr][cu]
      d.h[row * H + u0 + cu] = h;
      if constexpr (kSave) d.c[row * H + u0 + cu] = c;
    }
    __syncthreads();
    if (group < groups) {  // h[4 rows][unit] into every peer's next buffer
      const float4 v = make_float4(hs[4 * xq * U + xu], hs[(4 * xq + 1) * U + xu], hs[(4 * xq + 2) * U + xu],
                                   hs[(4 * xq + 3) * U + xu]);
      const int off = ((cur ^ 1) * H + u0 + xu) * kTileRows + 4 * xq;
      for (int peer = group; peer < kClusterSize; peer += groups)
        *reinterpret_cast<float4*>(cluster.map_shared_rank(hbuf, peer) + off) = v;
    }
    cluster_barrier();
    cur ^= 1;
  }
}

template <int kRG>
__global__ void __launch_bounds__(kClusterMaxThreads, 1)
lstm_bwd_cluster_kernel(const ClusterBwdArgs a, const ClusterLayout L) {
  extern __shared__ __align__(16) float smem[];
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = static_cast<int>(cluster.block_rank());
  const ClusterBwdDirection d = blockIdx.z ? a.dir[1] : a.dir[0];
  const int H = L.hidden, U = L.units, H4 = 4 * H, seq = a.seq;
  const int u0 = rank * U, nu = max(0, min(U, H - u0));
  const int b0 = blockIdx.y * kTileRows, rows = min(kTileRows, a.batch - b0);
  const int tid = threadIdx.x;
  const int slot = kTileRows * U;  // one sender's partials in a receive buffer: [16 rows][U]
  float* w = smem + L.w_off;
  float* dg = smem + L.dg_off;      // [4U][kLdDg]: this step's dgates by local column, 16 rows each
  float* recv = smem + L.recv_off;  // [2][16 senders][16 rows][U]

  load_w_slice(w, d.w_hh, L, u0, nu);
  for (int i = tid; i < L.cols * kLdDg; i += blockDim.x) dg[i] = 0.f;
  const int max_len = tile_max_length(a.lengths, b0, rows);

  const int cr = tid / U, cu = tid - cr * U;
  const bool cell = tid < kTileRows * U && cr < rows && cu < nu;
  const int len = cell ? a.lengths[b0 + cr] : 0;
  const size_t row0 = static_cast<size_t>(b0 + cr) * seq;
  // the product: thread n < H sums hidden unit n's partial dh over this CTA's columns, for its owner
  const int owner = tid / U, owner_unit = tid - owner * U;

  // a step's operands (gout, the gates, c_t and c at the previous step in
  // sequence order), loaded one step ahead: their latency hides behind a whole step
  auto load_step = [&](int step, float (&v)[7]) {
    // the forward visited t = step (t = seq-1-step when reverse): walk it back
    const int t = d.reverse ? step : seq - 1 - step;
    if (!cell || step >= seq) return;
    v[0] = d.gout[(row0 + t) * H + u0 + cu];
    if (t < len) {
      const float* gr = d.gates + (row0 + t) * H4 + u0 + cu;
#pragma unroll
      for (int g = 0; g < 4; ++g) v[1 + g] = gr[g * H];
      const float* cc = d.c + row0 * H + u0 + cu;
      v[5] = cc[static_cast<size_t>(t) * H];
      const int tp = d.reverse ? t + 1 : t - 1;  // previous step in sequence order
      v[6] = tp >= 0 && tp < seq ? cc[static_cast<size_t>(tp) * H] : 0.f;
    }
  };
  float dh = 0.f, dc = 0.f, carry = 0.f, v[7] = {}, v_next[7] = {};
  bool pending = false;  // the last step's partials wait in recv
  load_step(0, v_next);
  cluster.sync();  // every CTA has started
  int cur = 0;
  for (int step = 0; step < seq; ++step) {
    const int t = d.reverse ? step : seq - 1 - step;
    const size_t row = row0 + t;
    const bool live = t < max_len;  // uniform across the cluster
    const bool on = cell && t < len;
#pragma unroll
    for (int i = 0; i < 7; ++i) v[i] = v_next[i];
    load_step(step + 1, v_next);
    const float go = v[0], ct = v[5], cp = v[6];
    if (pending && cell) {  // dh = the 16 senders' partials for (cr, cu), added in rank order
      const float* p = recv + (cur ^ 1) * kClusterSize * slot + tid;  // tid = cr * U + cu
      float s = p[0];
#pragma unroll
      for (int k = 1; k < kClusterSize; ++k) s += p[k * slot];
      dh = s + carry;
    }
    if (cell) {
      const float dh_tot = dh + go;
      float* dx = d.dxw + row * H4 + u0 + cu;
      float* dgc = dg + cu * kLdDg + cr;
      if (on) {
        const float ig = v[1], fg = v[2], gg = v[3], og = v[4];
        const float th = tanhf(ct);
        const float d_o = dh_tot * th * og * (1.f - og);
        const float dct = dc + dh_tot * og * (1.f - th * th);
        const float d_i = dct * gg * ig * (1.f - ig);
        const float d_f = dct * cp * fg * (1.f - fg);
        const float d_g = dct * ig * (1.f - gg * gg);
        dx[0] = dgc[0] = d_i;
        dx[H] = dgc[U * kLdDg] = d_f;
        dx[2 * H] = dgc[2 * U * kLdDg] = d_g;
        dx[3 * H] = dgc[3 * U * kLdDg] = d_o;
        dc = dct * fg;
        carry = 0.f;
      } else {  // h_t = h_{t-1} and c_t = c_{t-1}: the cotangents pass through
        dx[0] = dx[H] = dx[2 * H] = dx[3 * H] = 0.f;
        dgc[0] = dgc[U * kLdDg] = dgc[2 * U * kLdDg] = dgc[3 * U * kLdDg] = 0.f;
        carry = dh_tot;
      }
      dh = dh_tot;  // kept where no product follows (past the tile's longest row)
    }
    pending = live;
    if (!live) continue;
    __syncthreads();
    if (tid < H) {  // partial dh[rows][n] = sum over this CTA's columns of dgates . w_hh[n][col]
      float acc[4 * kRG] = {};
      const float* wr = w + tid * L.ldw;
#pragma unroll 4
      for (int lc = 0; lc < L.cols; ++lc) {
        const float wv = wr[lc];
        const float4* dv = reinterpret_cast<const float4*>(dg + lc * kLdDg);
#pragma unroll
        for (int q = 0; q < kRG; ++q) {
          const float4 v = dv[q];
          acc[4 * q] = fmaf(v.x, wv, acc[4 * q]);
          acc[4 * q + 1] = fmaf(v.y, wv, acc[4 * q + 1]);
          acc[4 * q + 2] = fmaf(v.z, wv, acc[4 * q + 2]);
          acc[4 * q + 3] = fmaf(v.w, wv, acc[4 * q + 3]);
        }
      }
      float* dst = cluster.map_shared_rank(recv, owner) + (cur * kClusterSize + rank) * slot + owner_unit;
#pragma unroll
      for (int r = 0; r < 4 * kRG; ++r) dst[r * U] = acc[r];
    }
    cluster_barrier();
    cur ^= 1;
  }
}

// A launch of kClusterSize-CTA clusters; attr is the storage cfg points to.
cudaLaunchConfig_t cluster_config(dim3 grid, int threads, size_t smem, cudaStream_t stream,
                                  cudaLaunchAttribute* attr) {
  cudaLaunchConfig_t cfg = {};
  attr->id = cudaLaunchAttributeClusterDimension;
  attr->val.clusterDim.x = kClusterSize;
  attr->val.clusterDim.y = 1;
  attr->val.clusterDim.z = 1;
  cfg.gridDim = grid;
  cfg.blockDim = dim3(threads, 1, 1);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cfg;
}

// Attributes and the placement check of one cluster kernel: 0, a CUDA error,
// or kClusterUnplaceable.  The attributes are set once per device and kernel
// (the dynamic shared memory to all a block may have: the attribute belongs to
// the kernel, whatever H a launch has), the check made once per shared-memory size.
int prepare_cluster_kernel(const void* fn, int threads, size_t smem) {
  struct Prepared {
    int device;
    const void* fn;
    size_t smem;  // 0: the kernel's attributes
    int status;
  };
  static std::mutex mutex;
  static std::vector<Prepared> done;
  int device = 0, optin = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, device);
  if (err != cudaSuccess) return err;
  std::lock_guard<std::mutex> lock(mutex);
  auto find = [&](size_t key) -> const Prepared* {
    for (const Prepared& p : done)
      if (p.device == device && p.fn == fn && p.smem == key) return &p;
    return nullptr;
  };
  if (const Prepared* p = find(smem)) return p->status;
  const Prepared* attributes = find(0);
  if (attributes == nullptr) {
    err = cudaFuncSetAttribute(fn, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
    if (err == cudaSuccess) err = cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize, optin);
    done.push_back({device, fn, 0, static_cast<int>(err)});
    attributes = &done.back();
  }
  int status = attributes->status;
  if (status == 0) {
    cudaLaunchAttribute attr;
    const cudaLaunchConfig_t cfg = cluster_config(dim3(kClusterSize, 1, 1), threads, smem, nullptr, &attr);
    int clusters = 0;
    err = cudaOccupancyMaxActiveClusters(&clusters, fn, &cfg);
    status = err != cudaSuccess ? static_cast<int>(err) : clusters < 1 ? kClusterUnplaceable : 0;
  }
  done.push_back({device, fn, smem, status});
  return status;
}

// `iters` cluster barriers and nothing else: what one barrier of the
// recurrences' step costs (lstm_cluster_barrier_probe)
__global__ void __launch_bounds__(kClusterMaxThreads, 1) lstm_cluster_barrier_kernel(int iters) {
  for (int i = 0; i < iters; ++i) cluster_barrier();
}

// Prepares `kernel` (prepare_cluster_kernel) and launches it on a grid of
// kClusterSize-CTA clusters; returns the launch's error.
template <typename... Params, typename... Args>
int launch_cluster(void (*kernel)(Params...), dim3 grid, int threads, size_t smem, cudaStream_t stream,
                   const Args&... args) {
  const int status = prepare_cluster_kernel(reinterpret_cast<const void*>(kernel), threads, smem);
  if (status != 0) return status;
  cudaLaunchAttribute attr;
  const cudaLaunchConfig_t cfg = cluster_config(grid, threads, smem, stream, &attr);
  const cudaError_t err = cudaLaunchKernelEx(&cfg, kernel, args...);
  return err != cudaSuccess ? static_cast<int>(err) : static_cast<int>(cudaGetLastError());
}

// the cluster route's layout for this shape, if the current device lets a
// block have the shared memory it needs
int cluster_shape_check(int batch, int seq, int hidden, int dirs, ClusterLayout* L) {
  if (batch < 1 || seq < 1 || hidden < 1 || dirs < 1 || dirs > 2 || (batch + kTileRows - 1) / kTileRows > 65535)
    return cudaErrorInvalidValue;
  *L = cluster_layout(hidden);
  int device = 0, optin = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, device);
  if (err != cudaSuccess) return err;
  if (L->threads > kClusterMaxThreads || 4LL * std::max(L->fwd_floats, L->bwd_floats) > optin)
    return cudaErrorInvalidValue;
  return cudaSuccess;
}

int row_groups(int batch) { return (std::min(batch, kTileRows) + 3) / 4; }

}  // namespace

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

// Whether the cluster route holds (batch, hidden): w_hh's slice, the h or
// partial-dh buffers and the thread count of one CTA within max_smem bytes
// and kClusterMaxThreads.  Writes *fits (0 or 1), the CTAs per cluster, the
// batch rows per cluster and the larger of the forward's and the backward's
// shared memory per CTA.  Host only; no launch.
extern "C" int lstm_cluster_plan(int batch, int hidden, int max_smem, int* fits, int* cluster, int* tile_rows,
                                 int* smem_bytes) {
  if (batch < 1 || hidden < 1 || max_smem < 0) return cudaErrorInvalidValue;
  const ClusterLayout L = cluster_layout(hidden);
  const long long bytes = 4LL * std::max(L.fwd_floats, L.bwd_floats);
  *fits = bytes <= max_smem && L.threads <= kClusterMaxThreads;
  *cluster = kClusterSize;
  *tile_rows = std::min(batch, kTileRows);
  *smem_bytes = static_cast<int>(bytes);
  return cudaSuccess;
}

// the shared memory a block may opt in to on `device`
extern "C" int lstm_smem_optin(int device, int* bytes) {
  return cudaDeviceGetAttribute(bytes, cudaDevAttrMaxSharedMemoryPerBlockOptin, device);
}

// One or two directions (dirs) in one launch; direction i reads xw_i
// (B, T, 4H), w_hh_i (H, 4H) and writes h_i (B, T, H), and with c0 and
// gates0 not null (the training variant; then c1 and gates1 too, for two
// directions) c_i (B, T, H) and gates_i (B, T, 4H).  Returns
// kClusterUnplaceable (-2) if no cluster can be placed.
extern "C" int lstm_fwd_cluster(const float* xw0, const float* xw1, const float* w0, const float* w1,
                                const int* lengths, float* h0, float* h1, float* c0, float* c1, float* gates0,
                                float* gates1, int dirs, int reverse0, int reverse1, int batch, int seq, int hidden,
                                void* stream) {
  ClusterLayout L;
  const int err = cluster_shape_check(batch, seq, hidden, dirs, &L);
  if (err != cudaSuccess) return err;
  const bool save = c0 != nullptr;
  if ((gates0 != nullptr) != save || (dirs == 2 && ((c1 != nullptr) != save || (gates1 != nullptr) != save)))
    return cudaErrorInvalidValue;
  ClusterFwdArgs a{};
  a.dir[0] = {xw0, w0, h0, c0, gates0, reverse0};
  a.dir[1] = dirs == 2 ? ClusterFwdDirection{xw1, w1, h1, c1, gates1, reverse1} : a.dir[0];
  a.lengths = lengths;
  a.batch = batch;
  a.seq = seq;
  const size_t smem = 4 * static_cast<size_t>(L.fwd_floats);
  const dim3 grid(kClusterSize, (batch + kTileRows - 1) / kTileRows, dirs);
  const auto s = static_cast<cudaStream_t>(stream);
  switch (row_groups(batch) + (save ? 4 : 0)) {
    case 1: return launch_cluster(lstm_fwd_cluster_kernel<false, 1>, grid, L.threads, smem, s, a, L);
    case 2: return launch_cluster(lstm_fwd_cluster_kernel<false, 2>, grid, L.threads, smem, s, a, L);
    case 3: return launch_cluster(lstm_fwd_cluster_kernel<false, 3>, grid, L.threads, smem, s, a, L);
    case 4: return launch_cluster(lstm_fwd_cluster_kernel<false, 4>, grid, L.threads, smem, s, a, L);
    case 5: return launch_cluster(lstm_fwd_cluster_kernel<true, 1>, grid, L.threads, smem, s, a, L);
    case 6: return launch_cluster(lstm_fwd_cluster_kernel<true, 2>, grid, L.threads, smem, s, a, L);
    case 7: return launch_cluster(lstm_fwd_cluster_kernel<true, 3>, grid, L.threads, smem, s, a, L);
    default: return launch_cluster(lstm_fwd_cluster_kernel<true, 4>, grid, L.threads, smem, s, a, L);
  }
}

// BPTT of one or two directions in one launch: gout_i (B, T, H), the saved
// gates_i (B, T, 4H) and c_i (B, T, H), w_hh_i (H, 4H) → dxw_i (B, T, 4H).
extern "C" int lstm_bwd_cluster(const float* gout0, const float* gout1, const float* gates0, const float* gates1,
                                const float* c0, const float* c1, const float* w0, const float* w1,
                                const int* lengths, float* dxw0, float* dxw1, int dirs, int reverse0, int reverse1,
                                int batch, int seq, int hidden, void* stream) {
  ClusterLayout L;
  const int err = cluster_shape_check(batch, seq, hidden, dirs, &L);
  if (err != cudaSuccess) return err;
  ClusterBwdArgs a{};
  a.dir[0] = {gout0, gates0, c0, w0, dxw0, reverse0};
  a.dir[1] = dirs == 2 ? ClusterBwdDirection{gout1, gates1, c1, w1, dxw1, reverse1} : a.dir[0];
  a.lengths = lengths;
  a.batch = batch;
  a.seq = seq;
  const size_t smem = 4 * static_cast<size_t>(L.bwd_floats);
  const dim3 grid(kClusterSize, (batch + kTileRows - 1) / kTileRows, dirs);
  const auto s = static_cast<cudaStream_t>(stream);
  switch (row_groups(batch)) {
    case 1: return launch_cluster(lstm_bwd_cluster_kernel<1>, grid, L.threads, smem, s, a, L);
    case 2: return launch_cluster(lstm_bwd_cluster_kernel<2>, grid, L.threads, smem, s, a, L);
    case 3: return launch_cluster(lstm_bwd_cluster_kernel<3>, grid, L.threads, smem, s, a, L);
    default: return launch_cluster(lstm_bwd_cluster_kernel<4>, grid, L.threads, smem, s, a, L);
  }
}

// Times one cluster barrier for the recurrences' serial floor: two clusters
// of 16 CTAs of `threads` threads (a BiLSTM's two directions at B <= 16),
// each CTA with the forward's shared memory at H = 320, so one CTA an SM as
// in the recurrences, each running `iters` barriers.
extern "C" int lstm_cluster_barrier_probe(int iters, int threads, void* stream) {
  if (iters < 0 || threads < 32 || threads > kClusterMaxThreads) return cudaErrorInvalidValue;
  const size_t smem = 4 * static_cast<size_t>(cluster_layout(320).fwd_floats);
  return launch_cluster(lstm_cluster_barrier_kernel, dim3(kClusterSize, 1, 2), threads, smem,
                        static_cast<cudaStream_t>(stream), iters);
}

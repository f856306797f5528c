// The LSTM recurrences past the thread-block cluster (H > 385 on an H100:
// Conformer-L's H = 640), for sm_90a.
//
// lstm_fwd_grid replaces nn_conformer_for_speech_recognition_tpu/ops/pallas/
// lstm.py:_fwd_kernel (pallas_call :189) and lstm_bwd_grid the BPTT
// recurrence of _bwd_kernel (pallas_call :246) for every H that
// lstm.cu::lstm_cluster_plan refuses.  They compute what lstm.cu's cluster
// kernels compute, with the same semantics (its note has the equations):
// flax's i, f, g, o gate order; rows freeze at t >= length, so the reverse
// direction starts at each row's own len-1; on a padded step dxw is 0 and dh
// and dc pass through; dW_hh is not formed here but hoisted into
// lstm.cu::lstm_dwhh.  The training forward (kSave) also stores c and the
// post-activation gates (0 on padded steps).
//
// What bounds them: the chain of T dependent steps, each a (B x H) . (H x 4H)
// product (W_hh: 6.55 MB a direction at H = 640), so the latency of one step.
// Read from L2 at every step, W_hh would cost 6.55 MB of traffic a step;
// no one SM's shared memory (227 KB) holds it.
//
// The design: W_hh lives in shared memory across the card, read from device
// memory once a launch.  Each direction's W_hh is split by hidden unit over
// `ctas` CTAs, one CTA an SM (64 a direction at H = 640: 10 units and their
// 40 gate columns each, 100 KB of W_hh), and both directions run side by side
// in one cooperative launch (grid ctas x directions: 128 of the H100's 132
// SMs).  Every CTA of a launch must be resident at once, because the CTAs of
// a direction meet at a grid barrier every step: the launch is cooperative,
// and is refused (kNotCoResident), never run, when the occupancy does not
// hold the grid.  One barrier a step and direction: each CTA adds one to its
// direction's arrival counter in global memory (a fence, then an atomic add)
// and one thread spins on an acquire load until the counter reaches
// arrivals x ctas; the step's outputs that no other CTA reads (h, c and the
// gates, or dxw) are stored between the arrival and the wait.  The target
// grows monotonically, so nothing is reset in a launch; the two directions
// never wait on each other.  The wrapper hands in the counters zeroed.  L1
// is not coherent across SMs: everything another CTA wrote is read through
// L2 only, by cp.async.cg.
// - forward, each step: CTA k forms the gates of its 4U columns for the
//   tile's rows (<= 16) from the full h in its shared memory, float32 on the
//   CUDA cores (each of 256 threads four columns by the tile's rows over one
//   of kslices slices of K, the slices' partial sums added in slice order).
//   A broadcast 16-byte shared load costs the shared-memory path four
//   cycles, so with one or two columns a thread the product is bound by the
//   loads, not the FMAs; four columns a thread make one h load feed 16
//   FMAs.  Then the cell update of its units (c in registers; xw loaded a
//   step ahead); it writes its units' new h into a global exchange buffer
//   (double-buffered, [H][rows]: a CTA's units are contiguous), meets the
//   direction's barrier, and copies the whole h (16 x 640 floats, 40 KB)
//   back from L2.
// - backward, each step: CTA k forms the dgates of its columns from dh and dc
//   (registers; gout, the gates and c loaded a step ahead), writes them to
//   dxw, forms its partial dh_k = dgates[:, cols_k] . W_slice^T (rows x H;
//   each of H/4 threads four units, so one broadcast dgates load feeds 16
//   FMAs) and stores each unit's share into the exchange slot (owner, sender
//   k); after the barrier each CTA copies its units' slots of all senders
//   from L2 and adds them up in rank order 0..ctas-1.  No atomics touch
//   data: two launches give bit-equal dxw.  The same W slice serves, read by
//   rows: no transposed copy of W_hh is made.  The partials move rows x H
//   floats a CTA a step through L2 (2.6 MB a direction at H = 640, 16 rows);
//   all-gathering the dgates instead would read 4x as many bytes into every
//   CTA.
// Steps at which every row of the tile is past its length need no product and
// no barrier; every CTA sees the same lengths, so all skip the same steps.
// Batches over a tile's rows (16; fewer where W_hh's slice leaves no room,
// ops/cuda/lstm.py::grid_plan) run their tiles in turn inside the launch, the
// W slice loaded once.  The plan is the caller's; the launchers recompute the
// layout and refuse any other.  On an H100 (700 W) both directions at
// B=16, T=235, H=640 take 1.42 ms forward and 1.95 ms backward (6.0 and 8.3
// us a step, of which the grid barrier alone is 1.05), against a serial
// floor of 2.7 us a step; time any edit to these loops against the parent.

#include <cuda_runtime.h>

#include <algorithm>
#include <mutex>
#include <vector>

#include "tensor_core.cuh"

namespace {

using namespace tc;

// A CTA's threads, each in either product holding 64 sums, so that one shared-memory load feeds 4 (or,
// broadcast, 16) FMAs; __launch_bounds__ leaves them up to 255 registers
constexpr int kThreads = 256;
constexpr int kUnitsPerThread = 4;   // the backward's product: hidden units a thread
constexpr int kMaxHidden = kThreads * kUnitsPerThread;
constexpr int kMaxRows = 16;         // batch rows of a tile, a multiple of 4
constexpr int kLdDg = 20;            // floats per column of the backward's dgates: 16 rows and 4 of padding
constexpr int kNotCoResident = -3;   // the grid cannot be resident at once: the cooperative launch is refused

__device__ __forceinline__ float sigmoidf(float x) { return 1.f / (1.f + expf(-x)); }

// Shared-memory layout of one CTA, in floats from the start of dynamic shared
// memory (every section 16-byte aligned).  ops/cuda/lstm.py::grid_layout
// mirrors it.
struct GridLayout {
  int hidden, ctas, units, cols, rows;
  int ldb, kslices, kchunk;
  int f_h, f_red, fwd_floats;   // forward: W slice [hidden][cols] at 0, h [hidden][rows], partial gates
                                // [kslices][rows][cols]
  int b_dg, b_recv, bwd_floats; // backward: W slice [hidden][ldb] at 0, dgates [cols][kLdDg], partial dh
                                // [ctas senders][rows][units]
};

GridLayout grid_layout(int hidden, int ctas, int rows) {
  GridLayout L{};
  L.hidden = hidden;
  L.ctas = ctas;
  L.rows = rows;
  L.units = (hidden + ctas - 1) / ctas;
  L.cols = 4 * L.units;
  L.ldb = L.cols + 1;  // odd: the backward reads W by rows, lanes on consecutive rows, free of bank conflicts
  L.kslices = std::max(1, kThreads / L.units);  // the forward's product: a thread a (slice of K, column quad)
  L.kchunk = (hidden + L.kslices - 1) / L.kslices;
  L.f_h = hidden * L.cols;  // cols is a multiple of 4
  L.f_red = L.f_h + hidden * rows;
  L.fwd_floats = L.f_red + L.kslices * rows * L.cols;
  L.b_dg = (hidden * L.ldb + 3) & ~3;
  L.b_recv = L.b_dg + L.cols * kLdDg;
  L.bwd_floats = L.b_recv + ctas * rows * L.units;
  return L;
}

struct FwdDirection {
  const float* xw;
  const float* w_hh;
  float* h;
  float* c;      // training variant only
  float* gates;  // training variant only
  float* exch;   // [2][hidden][rows]
  unsigned* counter;
  int reverse;
};

struct FwdArgs {
  FwdDirection dir[2];
  const int* lengths;
  int batch, seq;
};

struct BwdDirection {
  const float* gout;
  const float* gates;
  const float* c;
  const float* w_hh;
  float* dxw;
  float* exch;  // [2][ctas owners][ctas senders][rows][units]
  unsigned* counter;
  int reverse;
};

struct BwdArgs {
  BwdDirection dir[2];
  const int* lengths;
  int batch, seq;
};

// the longest row of this tile: steps at or past it are padding for every row
__device__ __forceinline__ int tile_max_length(const int* __restrict__ lengths, int b0, int rows) {
  int m = 0;
  for (int r = 0; r < rows; ++r) m = max(m, lengths[b0 + r]);
  return m;
}

// One barrier of the CTAs of one direction, in two halves, every thread
// calling both: grid_arrive adds this CTA's one to the direction's counter,
// grid_wait waits until the counter reaches `target` (arrivals so far x the
// direction's CTAs); work between the two (stores no other CTA reads) hides
// the barrier's latency.  The fence makes every write this CTA made before the
// arrival visible at GPU scope before the arrival counts; the acquire load
// orders the reads after the wait.  A wait of kSpinLimit loads (seconds,
// where a step takes microseconds) can only be a CTA that never arrives: the
// kernel traps, and the launch fails, rather than hang the card.
constexpr unsigned kSpinLimit = 1u << 25;

__device__ __forceinline__ void grid_arrive(unsigned* counter) {
  __syncthreads();
  if (threadIdx.x == 0) {
    __threadfence();
    atomicAdd(counter, 1u);
  }
}

__device__ __forceinline__ void grid_wait(const unsigned* counter, unsigned target) {
  if (threadIdx.x == 0) {
    unsigned seen, spins = 0;
    do {
      asm volatile("ld.acquire.gpu.global.u32 %0, [%1];\n" : "=r"(seen) : "l"(counter) : "memory");
      if (++spins == kSpinLimit) __trap();
    } while (seen < target);
  }
  __syncthreads();
}

// n floats (a multiple of 4, both ends 16-byte aligned) from global src to
// shared dst through L2 (cp.async.cg: never a stale L1 line), by every thread
__device__ __forceinline__ void copy_through_l2(float* dst, const float* src, int n) {
  for (int i = 4 * threadIdx.x; i < n; i += 4 * kThreads) cp_async16(dst + i, src + i, true);
  cp_async_commit();
  cp_async_wait<0>();
  __syncthreads();
}

// kSave: the training variant (also c_t and the gates).  kRG: groups of 4
// batch rows in a tile; rows past the batch hold 0.
template <bool kSave, int kRG>
__global__ void __launch_bounds__(kThreads, 1) lstm_fwd_grid_kernel(const FwdArgs a, const GridLayout L) {
  extern __shared__ __align__(16) float smem[];
  constexpr int R = 4 * kRG;
  const FwdDirection d = blockIdx.y ? a.dir[1] : a.dir[0];
  const int rank = blockIdx.x, H = L.hidden, U = L.units, cols = L.cols, H4 = 4 * H, seq = a.seq;
  const int u0 = rank * U, nu = max(0, min(U, H - u0));
  const int tid = threadIdx.x;
  float* w = smem;               // [H][cols]: w_hh's rows on this CTA's columns
  float* hsh = smem + L.f_h;     // [H][R]: h_prev by hidden unit, R rows each
  float* red = smem + L.f_red;   // [kslices][R][cols]

  // local column g U + u holds global column g H + u0 + u (0 past the last unit)
  for (int i = tid; i < H * cols; i += kThreads) {
    const int k = i / cols, lc = i - k * cols, g = lc / U, u = lc - g * U;
    w[i] = u < nu ? d.w_hh[static_cast<size_t>(k) * H4 + g * H + u0 + u] : 0.f;
  }
  // the cell update and the exchange: thread (row cr, unit cu), units fastest
  const int cr = tid / U, cu = tid - cr * U;
  const bool slot = tid < R * U && cu < nu;
  const int ps = tid / U, pc = tid - ps * U;  // the product: thread (slice ps of K, column quad pc)
  const int k_begin = ps * L.kchunk, k_end = min(H, k_begin + L.kchunk);
  float* exch = d.exch;  // this step's half of the double buffer; the other is H * R floats away
  unsigned arrivals = 0;
  int par = 0;

  for (int b0 = 0; b0 < a.batch; b0 += R) {
    const int rows = min(R, a.batch - b0);
    const bool cell = slot && cr < rows;
    const int len = cell ? a.lengths[b0 + cr] : 0;
    const size_t row0 = cell ? static_cast<size_t>(b0 + cr) * seq : 0;
    const int max_len = tile_max_length(a.lengths, b0, rows);
    __syncthreads();  // the W slice is in; the last tile's reads of hsh are done
    for (int i = tid; i < H * R; i += kThreads) hsh[i] = 0.f;  // h before the first step
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
    __syncthreads();
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
        float acc[R][4] = {};
#pragma unroll 2
        for (int k = k_begin; k < k_end; ++k) {
          const float4 wk = *reinterpret_cast<const float4*>(w + k * cols + 4 * pc);
          const float4* hk = reinterpret_cast<const float4*>(hsh + k * R);
#pragma unroll
          for (int q = 0; q < kRG; ++q) {
            const float4 v = hk[q];
            const float hv[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
            for (int i = 0; i < 4; ++i) {
              float* a = acc[4 * q + i];
              a[0] = fmaf(hv[i], wk.x, a[0]);
              a[1] = fmaf(hv[i], wk.y, a[1]);
              a[2] = fmaf(hv[i], wk.z, a[2]);
              a[3] = fmaf(hv[i], wk.w, a[3]);
            }
          }
        }
        float4* dst = reinterpret_cast<float4*>(red + ps * R * cols) + pc;
#pragma unroll
        for (int r = 0; r < R; ++r) dst[r * U] = make_float4(acc[r][0], acc[r][1], acc[r][2], acc[r][3]);
      }
      __syncthreads();
      float act[4] = {};  // the post-activation gates, 0 on a padded step
      if (on) {
#pragma unroll
        for (int g = 0; g < 4; ++g) {  // the slices' partial sums in slice order, then xw
          const float* p = red + cr * cols + g * U + cu;
          float s = p[0];
          for (int sl = 1; sl < L.kslices; ++sl) s += p[sl * R * cols];
          act[g] = x[g] + s;
        }
        act[0] = sigmoidf(act[0]);
        act[1] = sigmoidf(act[1]);
        act[2] = tanhf(act[2]);
        act[3] = sigmoidf(act[3]);
        c = act[1] * c + act[0] * act[2];
        h = act[3] * tanhf(c);
      }
      if (slot) exch[(u0 + cu) * R + cr] = h;  // rows past the batch send their 0
      grid_arrive(d.counter);
      if (cell) {  // the outputs, which no other CTA reads, while the barrier fills
        d.h[row * H + u0 + cu] = h;
        if constexpr (kSave) {
          d.c[row * H + u0 + cu] = c;
          float* gt = d.gates + row * H4 + u0 + cu;
#pragma unroll
          for (int g = 0; g < 4; ++g) gt[g * H] = act[g];
        }
      }
      grid_wait(d.counter, ++arrivals * gridDim.x);
      copy_through_l2(hsh, exch, H * R);
      exch = d.exch + (par ^= 1) * H * R;
    }
  }
}

template <int kRG>
__global__ void __launch_bounds__(kThreads, 1) lstm_bwd_grid_kernel(const BwdArgs a, const GridLayout L) {
  extern __shared__ __align__(16) float smem[];
  constexpr int R = 4 * kRG;
  const BwdDirection d = blockIdx.y ? a.dir[1] : a.dir[0];
  const int rank = blockIdx.x, N = gridDim.x, H = L.hidden, U = L.units, cols = L.cols, H4 = 4 * H, seq = a.seq;
  const int u0 = rank * U, nu = max(0, min(U, H - u0));
  const int tid = threadIdx.x;
  const int slot = R * U;         // one sender's partials for one owner: [R rows][U]
  float* w = smem;                // [H][ldb]
  float* dg = smem + L.b_dg;      // [cols][kLdDg]: this step's dgates by local column, R rows each
  float* recv = smem + L.b_recv;  // [N senders][R][U]: the partial dh of this CTA's units

  for (int i = tid; i < H * cols; i += kThreads) {
    const int k = i / cols, lc = i - k * cols, g = lc / U, u = lc - g * U;
    w[k * L.ldb + lc] = u < nu ? d.w_hh[static_cast<size_t>(k) * H4 + g * H + u0 + u] : 0.f;
  }
  const int cr = tid / U, cu = tid - cr * U;
  const bool owns = tid < R * U && cu < nu;
  // the product: thread t < stride sums hidden units t + j stride, j < kUnitsPerThread (below H), over this
  // CTA's columns
  const int stride = (H + kUnitsPerThread - 1) / kUnitsPerThread;
  const size_t per_parity = static_cast<size_t>(N) * N * slot;
  unsigned arrivals = 0;
  int par = 0;

  for (int b0 = 0; b0 < a.batch; b0 += R) {
    const int rows = min(R, a.batch - b0);
    const bool cell = owns && cr < rows;
    const int len = cell ? a.lengths[b0 + cr] : 0;
    const size_t row0 = cell ? static_cast<size_t>(b0 + cr) * seq : 0;
    const int max_len = tile_max_length(a.lengths, b0, rows);
    __syncthreads();  // the W slice is in; the last tile's product has read dg
    for (int i = tid; i < cols * kLdDg; i += kThreads) dg[i] = 0.f;
    // a step's operands (gout, the gates, c_t and c at the previous step in sequence order), loaded one step
    // ahead: their latency hides behind a whole step
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
    bool pending = false;  // the last step's partials wait in the exchange
    load_step(0, v_next);
    __syncthreads();
    for (int step = 0; step < seq; ++step) {
      const int t = d.reverse ? step : seq - 1 - step;
      const size_t row = row0 + t;
      const bool live = t < max_len;  // uniform across the direction's CTAs
      const bool on = cell && t < len;
#pragma unroll
      for (int i = 0; i < 7; ++i) v[i] = v_next[i];
      load_step(step + 1, v_next);
      const float go = v[0], ct = v[5], cp = v[6];
      if (pending) {  // dh = the N senders' partials for (cr, cu), added in rank order
        copy_through_l2(recv, d.exch + (par ^ 1) * per_parity + static_cast<size_t>(rank) * N * slot, N * slot);
        if (cell) {
          const float* p = recv + tid;  // tid = cr * U + cu
          float s = p[0];
          for (int k = 1; k < N; ++k) s += p[k * slot];
          dh = s + carry;
        }
      }
      float dgv[4] = {};  // this step's dgates (i, f, g, o) of (cr, cu): 0 on a padded step
      if (cell) {
        const float dh_tot = dh + go;
        if (on) {
          const float ig = v[1], fg = v[2], gg = v[3], og = v[4];
          const float th = tanhf(ct);
          const float dct = dc + dh_tot * og * (1.f - th * th);
          dgv[0] = dct * gg * ig * (1.f - ig);
          dgv[1] = dct * cp * fg * (1.f - fg);
          dgv[2] = dct * ig * (1.f - gg * gg);
          dgv[3] = dh_tot * th * og * (1.f - og);
          dc = dct * fg;
          carry = 0.f;
        } else {  // h_t = h_{t-1} and c_t = c_{t-1}: the cotangents pass through
          carry = dh_tot;
        }
#pragma unroll
        for (int g = 0; g < 4; ++g) dg[(g * U + cu) * kLdDg + cr] = dgv[g];
        dh = dh_tot;  // kept where no product follows (past the tile's longest row)
      }
      // dxw, which no other CTA reads: stored while the barrier fills, or at once where no barrier follows
      auto store_dxw = [&] {
        if (cell) {
          float* dx = d.dxw + row * H4 + u0 + cu;
#pragma unroll
          for (int g = 0; g < 4; ++g) dx[g * H] = dgv[g];
        }
      };
      pending = live;
      if (!live) {
        store_dxw();
        continue;
      }
      __syncthreads();
      // partial dh[rows][n] = sum over this CTA's columns of dgates . w_hh[n][col], into the slot (owner of n, rank)
      if (tid < stride) {
        float acc[kUnitsPerThread][R] = {};
        const float* wr[kUnitsPerThread];
#pragma unroll
        for (int j = 0; j < kUnitsPerThread; ++j) wr[j] = w + min(tid + j * stride, H - 1) * L.ldb;
#pragma unroll 2
        for (int lc = 0; lc < cols; ++lc) {
          float wv[kUnitsPerThread];
#pragma unroll
          for (int j = 0; j < kUnitsPerThread; ++j) wv[j] = wr[j][lc];
          const float4* dv = reinterpret_cast<const float4*>(dg + lc * kLdDg);
#pragma unroll
          for (int q = 0; q < kRG; ++q) {
            const float4 y = dv[q];
#pragma unroll
            for (int j = 0; j < kUnitsPerThread; ++j) {
              acc[j][4 * q] = fmaf(y.x, wv[j], acc[j][4 * q]);
              acc[j][4 * q + 1] = fmaf(y.y, wv[j], acc[j][4 * q + 1]);
              acc[j][4 * q + 2] = fmaf(y.z, wv[j], acc[j][4 * q + 2]);
              acc[j][4 * q + 3] = fmaf(y.w, wv[j], acc[j][4 * q + 3]);
            }
          }
        }
        float* const exch = d.exch + par * per_parity;
#pragma unroll
        for (int j = 0; j < kUnitsPerThread; ++j) {
          const int n = tid + j * stride, owner = n / U;
          if (n < H) {
            float* dst = exch + (static_cast<size_t>(owner) * N + rank) * slot + (n - owner * U);
#pragma unroll
            for (int r = 0; r < R; ++r) dst[r * U] = acc[j][r];
          }
        }
      }
      grid_arrive(d.counter);
      store_dxw();
      grid_wait(d.counter, ++arrivals * N);
      par ^= 1;
    }
  }
}

// `iters` barriers of each direction's CTAs and nothing else: what one barrier
// of the grid recurrences' step costs (lstm_grid_barrier_probe)
__global__ void __launch_bounds__(kThreads, 1) lstm_grid_barrier_kernel(unsigned* counters, int iters) {
  unsigned* counter = counters + blockIdx.y;
  for (int i = 1; i <= iters; ++i) {
    grid_arrive(counter);
    grid_wait(counter, static_cast<unsigned>(i) * gridDim.x);
  }
}

// 0, a CUDA error, or kNotCoResident: the kernel's dynamic shared memory
// attribute (set once per device and kernel, to all a block may have) and
// whether `ctas` blocks of kThreads threads and `smem` bytes can all be
// resident at once on the current device, which a cooperative launch needs.
int prepare_grid_kernel(const void* fn, size_t smem, int ctas) {
  struct Prepared {
    int device;
    const void* fn;
  };
  static std::mutex mutex;
  static std::vector<Prepared> done;
  int device = 0, optin = 0, coop = 0, sms = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, device);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&coop, cudaDevAttrCooperativeLaunch, device);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (err != cudaSuccess) return err;
  {
    std::lock_guard<std::mutex> lock(mutex);
    bool found = false;
    for (const Prepared& p : done) found = found || (p.device == device && p.fn == fn);
    if (!found) {
      err = cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize, optin);
      if (err != cudaSuccess) return err;
      done.push_back({device, fn});
    }
  }
  if (static_cast<long long>(smem) > optin || !coop) return kNotCoResident;
  int per_sm = 0;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, fn, kThreads, smem);
  if (err != cudaSuccess) return err;
  return static_cast<long long>(per_sm) * sms >= ctas ? 0 : kNotCoResident;
}

// Prepares `kernel` and launches it cooperatively on `grid`; returns the
// launch's error, or kNotCoResident without launching.
template <typename... Params, typename... Args>
int launch_grid(void (*kernel)(Params...), dim3 grid, size_t smem, cudaStream_t stream, const Args&... args) {
  const int status = prepare_grid_kernel(reinterpret_cast<const void*>(kernel), smem, grid.x * grid.y);
  if (status != 0) return status;
  cudaLaunchAttribute attr;
  attr.id = cudaLaunchAttributeCooperative;
  attr.val.cooperative = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = grid;
  cfg.blockDim = dim3(kThreads, 1, 1);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cfg.attrs = &attr;
  cfg.numAttrs = 1;
  const cudaError_t err = cudaLaunchKernelEx(&cfg, kernel, args...);
  return err != cudaSuccess ? static_cast<int>(err) : static_cast<int>(cudaGetLastError());
}

// The layout for this call, if it is the plan's (ctas, units, rows and the
// shared bytes a CTA, the larger of the forward's and the backward's) and
// the kernels take it.
int grid_check(int batch, int seq, int hidden, int dirs, int ctas, int units, int rows, int smem_bytes,
               GridLayout* L) {
  if (batch < 1 || seq < 1 || hidden < 1 || hidden > kMaxHidden || dirs < 1 || dirs > 2 || ctas < 1 ||
      ctas > 65535 || rows < 4 || rows > kMaxRows || rows % 4)
    return cudaErrorInvalidValue;
  *L = grid_layout(hidden, ctas, rows);
  const long long bytes = 4LL * std::max(L->fwd_floats, L->bwd_floats);
  if (L->units != units || bytes != smem_bytes || rows * L->units > kThreads)
    return cudaErrorInvalidValue;
  return cudaSuccess;
}

}  // namespace

extern "C" {

// One or two directions (dirs) in one cooperative launch of grid ctas x dirs;
// direction i reads xw_i (B, T, 4H), w_hh_i (H, 4H) and writes h_i (B, T, H),
// and with c0 and gates0 not null (the training variant; then c1 and gates1
// too, for two directions) c_i (B, T, H) and gates_i (B, T, 4H).  exch:
// exch_floats floats of scratch, which must be dirs x 2 x H x rows, what the
// kernel writes; counters: dirs zeroed unsigned ints.  ctas, units, rows and
// smem_bytes are ops/cuda/lstm.py::grid_plan's.  Returns kNotCoResident (-3),
// launching nothing, if the grid cannot be resident.
int lstm_fwd_grid(const float* xw0, const float* xw1, const float* w0, const float* w1, const int* lengths,
                  float* h0, float* h1, float* c0, float* c1, float* gates0, float* gates1, float* exch,
                  unsigned* counters, int dirs, int reverse0, int reverse1, int batch, int seq, int hidden,
                  int ctas, int units, int rows, int smem_bytes, int exch_floats, void* stream) {
  GridLayout L;
  const int err = grid_check(batch, seq, hidden, dirs, ctas, units, rows, smem_bytes, &L);
  if (err != cudaSuccess) return err;
  const bool save = c0 != nullptr;
  if ((gates0 != nullptr) != save || (dirs == 2 && ((c1 != nullptr) != save || (gates1 != nullptr) != save)))
    return cudaErrorInvalidValue;
  const size_t per_dir = 2 * static_cast<size_t>(hidden) * rows;
  if (static_cast<size_t>(exch_floats) != dirs * per_dir) return cudaErrorInvalidValue;
  FwdArgs a{};
  a.dir[0] = {xw0, w0, h0, c0, gates0, exch, counters, reverse0};
  a.dir[1] = dirs == 2 ? FwdDirection{xw1, w1, h1, c1, gates1, exch + per_dir, counters + 1, reverse1} : a.dir[0];
  a.lengths = lengths;
  a.batch = batch;
  a.seq = seq;
  const size_t smem = 4 * static_cast<size_t>(L.fwd_floats);
  const dim3 grid(ctas, dirs, 1);
  const auto s = static_cast<cudaStream_t>(stream);
  switch (rows / 4 + (save ? 4 : 0)) {
    case 1: return launch_grid(lstm_fwd_grid_kernel<false, 1>, grid, smem, s, a, L);
    case 2: return launch_grid(lstm_fwd_grid_kernel<false, 2>, grid, smem, s, a, L);
    case 3: return launch_grid(lstm_fwd_grid_kernel<false, 3>, grid, smem, s, a, L);
    case 4: return launch_grid(lstm_fwd_grid_kernel<false, 4>, grid, smem, s, a, L);
    case 5: return launch_grid(lstm_fwd_grid_kernel<true, 1>, grid, smem, s, a, L);
    case 6: return launch_grid(lstm_fwd_grid_kernel<true, 2>, grid, smem, s, a, L);
    case 7: return launch_grid(lstm_fwd_grid_kernel<true, 3>, grid, smem, s, a, L);
    default: return launch_grid(lstm_fwd_grid_kernel<true, 4>, grid, smem, s, a, L);
  }
}

// BPTT of one or two directions in one cooperative launch: gout_i (B, T, H),
// the saved gates_i (B, T, 4H) and c_i (B, T, H), w_hh_i (H, 4H) → dxw_i (B, T,
// 4H).  exch: exch_floats floats of scratch, which must be dirs x 2 x ctas x
// ctas x rows x units; counters, plan and return as lstm_fwd_grid's.
int lstm_bwd_grid(const float* gout0, const float* gout1, const float* gates0, const float* gates1, const float* c0,
                  const float* c1, const float* w0, const float* w1, const int* lengths, float* dxw0, float* dxw1,
                  float* exch, unsigned* counters, int dirs, int reverse0, int reverse1, int batch, int seq,
                  int hidden, int ctas, int units, int rows, int smem_bytes, int exch_floats, void* stream) {
  GridLayout L;
  const int err = grid_check(batch, seq, hidden, dirs, ctas, units, rows, smem_bytes, &L);
  if (err != cudaSuccess) return err;
  const size_t per_dir = 2 * static_cast<size_t>(ctas) * ctas * rows * L.units;
  if (static_cast<size_t>(exch_floats) != dirs * per_dir) return cudaErrorInvalidValue;
  BwdArgs a{};
  a.dir[0] = {gout0, gates0, c0, w0, dxw0, exch, counters, reverse0};
  a.dir[1] = dirs == 2 ? BwdDirection{gout1, gates1, c1, w1, dxw1, exch + per_dir, counters + 1, reverse1} : a.dir[0];
  a.lengths = lengths;
  a.batch = batch;
  a.seq = seq;
  const size_t smem = 4 * static_cast<size_t>(L.bwd_floats);
  const dim3 grid(ctas, dirs, 1);
  const auto s = static_cast<cudaStream_t>(stream);
  switch (rows / 4) {
    case 1: return launch_grid(lstm_bwd_grid_kernel<1>, grid, smem, s, a, L);
    case 2: return launch_grid(lstm_bwd_grid_kernel<2>, grid, smem, s, a, L);
    case 3: return launch_grid(lstm_bwd_grid_kernel<3>, grid, smem, s, a, L);
    default: return launch_grid(lstm_bwd_grid_kernel<4>, grid, smem, s, a, L);
  }
}

// Registers and local (spill) bytes a thread of one grid kernel's build:
// kernel 0 the inference forward, 1 the training forward, 2 the backward;
// row_groups 1..4 (host only; no launch).
int lstm_grid_kernel_attributes(int kernel, int row_groups, int* registers, int* local_bytes) {
  const void* fns[3][4] = {
      {reinterpret_cast<const void*>(lstm_fwd_grid_kernel<false, 1>),
       reinterpret_cast<const void*>(lstm_fwd_grid_kernel<false, 2>),
       reinterpret_cast<const void*>(lstm_fwd_grid_kernel<false, 3>),
       reinterpret_cast<const void*>(lstm_fwd_grid_kernel<false, 4>)},
      {reinterpret_cast<const void*>(lstm_fwd_grid_kernel<true, 1>),
       reinterpret_cast<const void*>(lstm_fwd_grid_kernel<true, 2>),
       reinterpret_cast<const void*>(lstm_fwd_grid_kernel<true, 3>),
       reinterpret_cast<const void*>(lstm_fwd_grid_kernel<true, 4>)},
      {reinterpret_cast<const void*>(lstm_bwd_grid_kernel<1>), reinterpret_cast<const void*>(lstm_bwd_grid_kernel<2>),
       reinterpret_cast<const void*>(lstm_bwd_grid_kernel<3>), reinterpret_cast<const void*>(lstm_bwd_grid_kernel<4>)},
  };
  if (kernel < 0 || kernel > 2 || row_groups < 1 || row_groups > 4) return cudaErrorInvalidValue;
  cudaFuncAttributes attr;
  const cudaError_t err = cudaFuncGetAttributes(&attr, fns[kernel][row_groups - 1]);
  if (err != cudaSuccess) return err;
  *registers = attr.numRegs;
  *local_bytes = static_cast<int>(attr.localSizeBytes);
  return cudaSuccess;
}

// Times one grid barrier for the grid route's serial floor: `ctas` CTAs of
// kThreads threads for each of `dirs` directions, each CTA with `smem_bytes`
// of shared memory (the forward's, so one CTA an SM as in the recurrences),
// each running `iters` barriers on its direction's counter (counters: dirs
// zeroed unsigned ints).  Cooperative, refused as the recurrences are.
int lstm_grid_barrier_probe(int iters, int ctas, int dirs, int smem_bytes, unsigned* counters, void* stream) {
  if (iters < 0 || ctas < 1 || dirs < 1 || dirs > 2 || smem_bytes < 0) return cudaErrorInvalidValue;
  return launch_grid(lstm_grid_barrier_kernel, dim3(ctas, dirs, 1), static_cast<size_t>(smem_bytes),
                     static_cast<cudaStream_t>(stream), counters, iters);
}

}  // extern "C"

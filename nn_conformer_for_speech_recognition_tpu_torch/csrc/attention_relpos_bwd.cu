// Rel-pos (Transformer-XL) flash attention backward for sm_90a.
//
// Replaces nn_conformer_for_speech_recognition_tpu/ops/pallas/attention.py:
// _flash_relpos_bwd_dq_kernel, _flash_relpos_bwd_dkv_kernel and
// _flash_relpos_bwd_dband_kernel, with the tile recompute they share
// (_bwd_recompute).  Nothing of size T x T is stored: every kernel rebuilds
// its 32 x 32 tile of probabilities from the forward's logsumexp,
//   s[i][j]  = ((qu_i . k_j) + (qv_i . p[j - i + T - 1])) * scale
//   prob     = exp(s - lse_i), exactly 0 where j >= length[b]
//   ds[i][j] = prob * ((dO_i . v_j) - delta_i) * scale,  delta_i = sum_d dO_i O_i
// and then forms
//   dq  kernel: dqu_i = sum_j ds[i][j] k_j,  dqv_i = sum_j ds[i][j] p[j - i + T - 1]
//   dkv kernel: dk_j  = sum_i ds[i][j] qu_i, dv_j  = sum_i prob[i][j] dO_i
//   dband kernel: dp[l] = sum_b sum_i ds[b][i][i + l - (T - 1)] qv[b][i]
// Query rows are never masked; keys at or beyond the length, and tile rows
// beyond T, carry no weight.  Layout: qu, qv, k, v, dO and the four
// gradients (B, T, H, dh), p and dp (2T-1, H, dh), lse and delta (B, H, T)
// float32, all contiguous.
//
// Every kernel runs 256 threads on a 32 x 32 tile: for the scores eight
// threads share a tile row and own four columns each; for the products a
// thread owns one output row and dh / 8 of its columns, accumulating in
// float32 registers.  The rel-pos row is read by index from a band in shared
// memory, in place of the TPU kernels' lane-roll skew and unskew.
//
// The table gradient sums over the batch and over every query tile.  It is
// kept deterministic: a block of the dband kernel owns 32 table rows of one
// head and one batch row, slides a 63-row window of k and v along the
// diagonal as it walks the query tiles in order, and writes a float32
// partial; a second kernel adds the batch rows' partials in order and casts.
//
// Bound on the H100: float32 FMAs on the CUDA cores, fed from shared memory.
//
// Routes: float32 inputs run all three kernels here.  bfloat16 inputs go
// to the tensor-core kernels of attention_relpos_bwd_tc.cu
// (bwd_dq_tc_kernel, bwd_dkv_tc_kernel, bwd_dband_tc_kernel), from the same
// entry points: the bfloat16 instantiations of this file's kernels are not
// compiled.

#include <cmath>

#include "attention_relpos.cuh"

namespace {

using namespace relpos;

constexpr int kTile = 32;           // kBlockQ == kBlockK
constexpr int kDsLd = kTile + 1;    // row stride of the ds and prob tiles

enum Kind { kDq, kDkv, kDband };

template <int KIND, int DH>
constexpr size_t smem_bytes() {
  constexpr int LD = DH + 1;
  // dq:    qu, qv, dO | k, v | band (63) | ds
  // dkv:   k, v | qu, qv, dO | band (63) | prob, ds | lse, delta
  // dband: band (32) | qu, qv, dO | k, v windows (63 each) | ds | lse, delta
  constexpr int rows = KIND == kDband ? 4 * kTile + 2 * kBand : 5 * kTile + kBand;
  constexpr int tiles = KIND == kDkv ? 2 : 1;
  return sizeof(float) * (rows * LD + tiles * kTile * kDsLd + 2 * kTile);
}

// One thread's four entries of the recomputed tile: for its row and the
// columns sub, sub + 8, sub + 16, sub + 24, the three dot products of length
// DH.  krow(c), prow(c) give the shared-memory rows of k / v and of the
// rel-pos band that column c pairs with.
template <int DH, typename KRow, typename PRow>
__device__ __forceinline__ void tile_dots(const float* qa, const float* qb, const float* ga,
                                          const float* s_k, const float* s_v, const float* s_p,
                                          int sub, KRow krow, PRow prow, float* score, float* dprob) {
  constexpr int LD = DH + 1;
#pragma unroll
  for (int c = 0; c < kTile / 8; ++c) {
    const int col = sub + 8 * c;
    const float* kr = s_k + krow(col) * LD;
    const float* vr = s_v + krow(col) * LD;
    const float* band = s_p + prow(col) * LD;
    float ac = 0.f, bd = 0.f, dp = 0.f;
#pragma unroll 16
    for (int d = 0; d < DH; ++d) {
      ac = fmaf(qa[d], kr[d], ac);
      bd = fmaf(qb[d], band[d], bd);
      dp = fmaf(ga[d], vr[d], dp);
    }
    score[c] = ac + bd;
    dprob[c] = dp;
  }
}

template <typename T, int DH>
__global__ void __launch_bounds__(kThreads)
bwd_dq_kernel(const T* __restrict__ qu, const T* __restrict__ qv, const T* __restrict__ k,
              const T* __restrict__ v, const T* __restrict__ p, const int* __restrict__ lengths,
              const T* __restrict__ g, const float* __restrict__ lse,
              const float* __restrict__ delta, T* __restrict__ dqu, T* __restrict__ dqv, int seq,
              int heads, float scale) {
  constexpr int LD = DH + 1;
  constexpr int kPerThread = DH / 8;
  extern __shared__ float smem[];
  float* s_qu = smem;
  float* s_qv = s_qu + kTile * LD;
  float* s_g = s_qv + kTile * LD;
  float* s_k = s_g + kTile * LD;
  float* s_v = s_k + kTile * LD;
  float* s_p = s_v + kTile * LD;
  float* s_ds = s_p + kBand * LD;

  const int i0 = blockIdx.x * kTile;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int tid = threadIdx.x;
  const int row = tid >> 3;
  const int sub = tid & 7;
  const int len = min(lengths[b], seq);
  const int n_rel = 2 * seq - 1;
  const size_t time_stride = static_cast<size_t>(heads) * DH;
  const size_t base = static_cast<size_t>(b) * seq * time_stride + static_cast<size_t>(h) * DH;

  load_rows<T, DH>(s_qu, qu + base, i0, kTile, seq, time_stride, tid);
  load_rows<T, DH>(s_qv, qv + base, i0, kTile, seq, time_stride, tid);
  load_rows<T, DH>(s_g, g + base, i0, kTile, seq, time_stride, tid);

  const int i = i0 + row;
  const bool row_ok = i < seq;
  const size_t stat = (static_cast<size_t>(b) * heads + h) * seq + i;
  const float lse_i = row_ok ? lse[stat] : 0.f;
  const float delta_i = row_ok ? delta[stat] : 0.f;

  float acc_u[kPerThread], acc_v[kPerThread];
#pragma unroll
  for (int e = 0; e < kPerThread; ++e) acc_u[e] = acc_v[e] = 0.f;

  // key tiles wholly at or beyond the length have ds = 0: the walk ends there
  for (int j0 = 0; j0 < len; j0 += kTile) {
    __syncthreads();  // the previous tile's reads are done (and, first, nothing)
    load_rows<T, DH>(s_k, k + base, j0, kTile, seq, time_stride, tid);
    load_rows<T, DH>(s_v, v + base, j0, kTile, seq, time_stride, tid);
    load_band<T, DH>(s_p, p, j0 - (i0 + kTile - 1) + seq - 1, kBand, n_rel, heads, h, tid);
    __syncthreads();

    float score[kTile / 8], dprob[kTile / 8];
    tile_dots<DH>(s_qu + row * LD, s_qv + row * LD, s_g + row * LD, s_k, s_v, s_p, sub,
                  [](int col) { return col; }, [row](int col) { return col - row + kTile - 1; },
                  score, dprob);
#pragma unroll
    for (int c = 0; c < kTile / 8; ++c) {
      const int col = sub + 8 * c;
      float ds = 0.f;
      if (row_ok && j0 + col < len) {
        ds = expf(score[c] * scale - lse_i) * (dprob[c] - delta_i) * scale;
      }
      s_ds[row * kDsLd + col] = ds;
    }
    __syncwarp();  // a row's ds comes from the 8 lanes of this warp

    for (int jj = 0; jj < kTile; ++jj) {
      const float ds = s_ds[row * kDsLd + jj];
      const float* kr = s_k + jj * LD + sub;
      const float* band = s_p + (jj - row + kTile - 1) * LD + sub;
#pragma unroll
      for (int e = 0; e < kPerThread; ++e) {
        acc_u[e] = fmaf(ds, kr[8 * e], acc_u[e]);
        acc_v[e] = fmaf(ds, band[8 * e], acc_v[e]);
      }
    }
  }

  if (row_ok) {
    const size_t off = base + i * time_stride + sub;
#pragma unroll
    for (int e = 0; e < kPerThread; ++e) {
      dqu[off + 8 * e] = from_float<T>(acc_u[e]);
      dqv[off + 8 * e] = from_float<T>(acc_v[e]);
    }
  }
}

template <typename T, int DH>
__global__ void __launch_bounds__(kThreads)
bwd_dkv_kernel(const T* __restrict__ qu, const T* __restrict__ qv, const T* __restrict__ k,
               const T* __restrict__ v, const T* __restrict__ p, const int* __restrict__ lengths,
               const T* __restrict__ g, const float* __restrict__ lse,
               const float* __restrict__ delta, T* __restrict__ dk, T* __restrict__ dv, int seq,
               int heads, float scale) {
  constexpr int LD = DH + 1;
  constexpr int kPerThread = DH / 8;
  extern __shared__ float smem[];
  float* s_k = smem;
  float* s_v = s_k + kTile * LD;
  float* s_qu = s_v + kTile * LD;
  float* s_qv = s_qu + kTile * LD;
  float* s_g = s_qv + kTile * LD;
  float* s_p = s_g + kTile * LD;
  float* s_prob = s_p + kBand * LD;
  float* s_ds = s_prob + kTile * kDsLd;
  float* s_lse = s_ds + kTile * kDsLd;
  float* s_delta = s_lse + kTile;

  const int j0 = blockIdx.x * kTile;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int tid = threadIdx.x;
  const int row = tid >> 3;  // query row for the scores, key row for the products
  const int sub = tid & 7;
  const int len = min(lengths[b], seq);
  const int n_rel = 2 * seq - 1;
  const size_t time_stride = static_cast<size_t>(heads) * DH;
  const size_t base = static_cast<size_t>(b) * seq * time_stride + static_cast<size_t>(h) * DH;
  const size_t stat_base = (static_cast<size_t>(b) * heads + h) * seq;

  float acc_k[kPerThread], acc_v[kPerThread];
#pragma unroll
  for (int e = 0; e < kPerThread; ++e) acc_k[e] = acc_v[e] = 0.f;

  // a key tile wholly at or beyond the length has prob = ds = 0: zeros out
  if (j0 < len) {
    load_rows<T, DH>(s_k, k + base, j0, kTile, seq, time_stride, tid);
    load_rows<T, DH>(s_v, v + base, j0, kTile, seq, time_stride, tid);
    for (int i0 = 0; i0 < seq; i0 += kTile) {
      __syncthreads();  // the previous tile's reads are done
      load_rows<T, DH>(s_qu, qu + base, i0, kTile, seq, time_stride, tid);
      load_rows<T, DH>(s_qv, qv + base, i0, kTile, seq, time_stride, tid);
      load_rows<T, DH>(s_g, g + base, i0, kTile, seq, time_stride, tid);
      load_band<T, DH>(s_p, p, j0 - (i0 + kTile - 1) + seq - 1, kBand, n_rel, heads, h, tid);
      if (tid < kTile) {
        const bool ok = i0 + tid < seq;
        s_lse[tid] = ok ? lse[stat_base + i0 + tid] : 0.f;
        s_delta[tid] = ok ? delta[stat_base + i0 + tid] : 0.f;
      }
      __syncthreads();

      float score[kTile / 8], dprob[kTile / 8];
      tile_dots<DH>(s_qu + row * LD, s_qv + row * LD, s_g + row * LD, s_k, s_v, s_p, sub,
                    [](int col) { return col; }, [row](int col) { return col - row + kTile - 1; },
                    score, dprob);
      const bool row_ok = i0 + row < seq;
#pragma unroll
      for (int c = 0; c < kTile / 8; ++c) {
        const int col = sub + 8 * c;
        float prob = 0.f;
        if (row_ok && j0 + col < len) prob = expf(score[c] * scale - s_lse[row]);
        s_prob[row * kDsLd + col] = prob;
        s_ds[row * kDsLd + col] = prob * (dprob[c] - s_delta[row]) * scale;
      }
      __syncthreads();  // a key column's entries come from every warp

      for (int ii = 0; ii < kTile; ++ii) {
        const float prob = s_prob[ii * kDsLd + row];
        const float ds = s_ds[ii * kDsLd + row];
        const float* gr = s_g + ii * LD + sub;
        const float* qr = s_qu + ii * LD + sub;
#pragma unroll
        for (int e = 0; e < kPerThread; ++e) {
          acc_v[e] = fmaf(prob, gr[8 * e], acc_v[e]);
          acc_k[e] = fmaf(ds, qr[8 * e], acc_k[e]);
        }
      }
    }
  }

  const int j = j0 + row;
  if (j < seq) {
    const size_t off = base + j * time_stride + sub;
#pragma unroll
    for (int e = 0; e < kPerThread; ++e) {
      dk[off + 8 * e] = from_float<T>(acc_k[e]);
      dv[off + 8 * e] = from_float<T>(acc_v[e]);
    }
  }
}

template <typename T, int DH>
__global__ void __launch_bounds__(kThreads)
bwd_dband_kernel(const T* __restrict__ qu, const T* __restrict__ qv, const T* __restrict__ k,
                 const T* __restrict__ v, const T* __restrict__ p, const int* __restrict__ lengths,
                 const T* __restrict__ g, const float* __restrict__ lse,
                 const float* __restrict__ delta, float* __restrict__ partial, int seq, int heads,
                 float scale) {
  constexpr int LD = DH + 1;
  constexpr int kPerThread = DH / 8;
  extern __shared__ float smem[];
  float* s_p = smem;  // the block's 32 table rows
  float* s_qu = s_p + kTile * LD;
  float* s_qv = s_qu + kTile * LD;
  float* s_g = s_qv + kTile * LD;
  float* s_k = s_g + kTile * LD;  // 63-row windows of k and v along the diagonal
  float* s_v = s_k + kBand * LD;
  float* s_ds = s_v + kBand * LD;
  float* s_lse = s_ds + kTile * kDsLd;
  float* s_delta = s_lse + kTile;

  const int l0 = blockIdx.x * kTile;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int tid = threadIdx.x;
  const int row = tid >> 3;  // query row for the scores, table row for the product
  const int sub = tid & 7;
  const int len = min(lengths[b], seq);
  const int n_rel = 2 * seq - 1;
  const size_t time_stride = static_cast<size_t>(heads) * DH;
  const size_t base = static_cast<size_t>(b) * seq * time_stride + static_cast<size_t>(h) * DH;
  const size_t stat_base = (static_cast<size_t>(b) * heads + h) * seq;

  load_band<T, DH>(s_p, p, l0, kTile, n_rel, heads, h, tid);

  float acc[kPerThread];
#pragma unroll
  for (int e = 0; e < kPerThread; ++e) acc[e] = 0.f;

  for (int i0 = 0; i0 < seq; i0 += kTile) {
    // query row i0 + r and table row l0 + c meet key j_lo + r + c
    const int j_lo = i0 + l0 - (seq - 1);
    if (j_lo + kBand - 1 < 0 || j_lo >= len) continue;  // no valid key in the window
    __syncthreads();  // the previous tile's reads are done
    load_rows<T, DH>(s_qu, qu + base, i0, kTile, seq, time_stride, tid);
    load_rows<T, DH>(s_qv, qv + base, i0, kTile, seq, time_stride, tid);
    load_rows<T, DH>(s_g, g + base, i0, kTile, seq, time_stride, tid);
    load_rows<T, DH>(s_k, k + base, j_lo, kBand, seq, time_stride, tid);
    load_rows<T, DH>(s_v, v + base, j_lo, kBand, seq, time_stride, tid);
    if (tid < kTile) {
      const bool ok = i0 + tid < seq;
      s_lse[tid] = ok ? lse[stat_base + i0 + tid] : 0.f;
      s_delta[tid] = ok ? delta[stat_base + i0 + tid] : 0.f;
    }
    __syncthreads();

    float score[kTile / 8], dprob[kTile / 8];
    tile_dots<DH>(s_qu + row * LD, s_qv + row * LD, s_g + row * LD, s_k, s_v, s_p, sub,
                  [row](int col) { return row + col; }, [](int col) { return col; }, score, dprob);
    const bool row_ok = i0 + row < seq;
#pragma unroll
    for (int c = 0; c < kTile / 8; ++c) {
      const int col = sub + 8 * c;
      const int j = j_lo + row + col;
      float ds = 0.f;
      if (row_ok && j >= 0 && j < len && l0 + col < n_rel) {
        ds = expf(score[c] * scale - s_lse[row]) * (dprob[c] - s_delta[row]) * scale;
      }
      s_ds[row * kDsLd + col] = ds;
    }
    __syncthreads();  // a table row's entries come from every warp

    for (int ii = 0; ii < kTile; ++ii) {
      const float ds = s_ds[ii * kDsLd + row];
      const float* qr = s_qv + ii * LD + sub;
#pragma unroll
      for (int e = 0; e < kPerThread; ++e) acc[e] = fmaf(ds, qr[8 * e], acc[e]);
    }
  }

  const int l = l0 + row;
  if (l < n_rel) {
    float* out = partial + ((static_cast<size_t>(b) * n_rel + l) * heads + h) * DH + sub;
#pragma unroll
    for (int e = 0; e < kPerThread; ++e) out[8 * e] = acc[e];
  }
}

template <int KIND, typename T, int DH>
auto kernel_of() {
  if constexpr (KIND == kDq) {
    return bwd_dq_kernel<T, DH>;
  } else if constexpr (KIND == kDkv) {
    return bwd_dkv_kernel<T, DH>;
  } else {
    return bwd_dband_kernel<T, DH>;
  }
}

template <int KIND, typename T, int DH>
cudaError_t launch(const BwdArgs& a) {
  constexpr size_t smem = smem_bytes<KIND, DH>();
  auto kernel = kernel_of<KIND, T, DH>();
  static bool configured = false;
  if (!configured) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (err != cudaSuccess) return err;
    configured = true;
  }
  const T* qu = static_cast<const T*>(a.qu);
  const T* qv = static_cast<const T*>(a.qv);
  const T* k = static_cast<const T*>(a.k);
  const T* v = static_cast<const T*>(a.v);
  const T* p = static_cast<const T*>(a.p);
  const T* g = static_cast<const T*>(a.g);
  if constexpr (KIND == kDband) {
    const int n_rel = 2 * a.seq - 1;
    float* partial = static_cast<float*>(a.out1);
    const dim3 grid((n_rel + kTile - 1) / kTile, a.heads, a.batch);
    kernel<<<grid, kThreads, smem, a.stream>>>(qu, qv, k, v, p, a.lengths, g, a.lse, a.delta,
                                               partial, a.seq, a.heads, a.scale);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return err;
    return launch_dband_reduce<T>(partial, static_cast<T*>(a.out0), a.batch,
                                  static_cast<size_t>(n_rel) * a.heads * DH, a.stream);
  } else {
    const dim3 grid((a.seq + kTile - 1) / kTile, a.heads, a.batch);
    kernel<<<grid, kThreads, smem, a.stream>>>(qu, qv, k, v, p, a.lengths, g, a.lse, a.delta,
                                               static_cast<T*>(a.out0), static_cast<T*>(a.out1),
                                               a.seq, a.heads, a.scale);
  }
  return cudaGetLastError();
}

template <int KIND, typename T>
cudaError_t dispatch_dim(int head_dim, const BwdArgs& a) {
  switch (head_dim) {
    case 16: return launch<KIND, T, 16>(a);
    case 32: return launch<KIND, T, 32>(a);
    case 64: return launch<KIND, T, 64>(a);
    case 128: return launch<KIND, T, 128>(a);
    default: return cudaErrorInvalidValue;
  }
}

template <int KIND>
int dispatch(const void* qu, const void* qv, const void* k, const void* v, const void* p,
             const void* lengths, const void* g, const void* lse, const void* delta, void* out0,
             void* out1, int batch, int seq, int heads, int head_dim, float scale, int is_bf16,
             void* stream) {
  const BwdArgs a{qu, qv, k, v, p, static_cast<const int*>(lengths), g,
                  static_cast<const float*>(lse), static_cast<const float*>(delta), out0, out1,
                  batch, seq, heads, scale, static_cast<cudaStream_t>(stream)};
  if (!is_bf16) return dispatch_dim<KIND, float>(head_dim, a);
  if constexpr (KIND == kDq) {
    return bwd_dq_tc(head_dim, a);
  } else if constexpr (KIND == kDkv) {
    return bwd_dkv_tc(head_dim, a);
  } else {
    return bwd_dband_tc(head_dim, a);
  }
}

}  // namespace

#define RELPOS_BWD_ARGS                                                                          \
  const void *qu, const void *qv, const void *k, const void *v, const void *p,                   \
      const void *lengths, const void *g, const void *lse, const void *delta, void *out0,        \
      void *out1, int batch, int seq, int heads, int head_dim, float scale, int is_bf16,         \
      void *stream
#define RELPOS_BWD_PASS                                                                          \
  qu, qv, k, v, p, lengths, g, lse, delta, out0, out1, batch, seq, heads, head_dim, scale,       \
      is_bf16, stream

// out0, out1: dqu, dqv
extern "C" int attention_relpos_bwd_dq(RELPOS_BWD_ARGS) { return dispatch<kDq>(RELPOS_BWD_PASS); }
// out0, out1: dk, dv
extern "C" int attention_relpos_bwd_dkv(RELPOS_BWD_ARGS) { return dispatch<kDkv>(RELPOS_BWD_PASS); }
// out0: dp (2T-1, H, dh); out1: float32 scratch (B, 2T-1, H, dh) for the partials
extern "C" int attention_relpos_bwd_dband(RELPOS_BWD_ARGS) {
  return dispatch<kDband>(RELPOS_BWD_PASS);
}

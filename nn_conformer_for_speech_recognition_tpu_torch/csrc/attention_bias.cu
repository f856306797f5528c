// Flash attention forward with an additive bias input, for sm_90a.
//
// Replaces nn_conformer_for_speech_recognition_tpu/ops/pallas/attention.py:
// _flash_kernel (the bias-input variant behind `flash_attention`).
//   s[i][j] = ((qu_i . k_j) + bias[b][h][i][j]) * scale   (the scale multiplies the bias too)
//   s[i][j] = -1e30 where j >= length[b]
//   out_i   = softmax_j(s[i]) @ v
// Layout: qu, k, v, out (B, T, H, dh) and bias (B, H, T, T), contiguous; the
// bias is float32 or has the inputs' type.  No padded or transposed copy is
// made: tiles are read by index and the ragged edge is masked here.  Both
// kernels walk a row's key tiles up to its length and no further: a key at
// or beyond the length has weight exp(-1e30 - m) = 0 exactly once a valid
// key has set the running max, so the tiles that hold only such keys change
// nothing (a length of 0 walks all of them and gives the mean of v, as the
// plain version does).  Running max, normaliser and the output accumulator
// stay in float32; the probabilities are rounded to v's type before the
// value product, where the TPU kernel casts them, and summed unrounded into
// the normaliser, with the l == 0 -> 1 guard.  Every query row is computed,
// valid or not: only keys are masked.
//
// bfloat16 inputs (attention_bias_tc_kernel), on the tensor cores with
// mma.sync m16n8k16 (bf16 in, float32 sums; not wgmma): a block of 4 warps
// takes 64 query rows, 16 a warp, and holds their qu fragments in registers
// for the whole key walk.  Tiles of 64 keys of k and v stay bf16 in shared
// memory, rows padded by 16 bytes so that ldmatrix reads are free of bank
// conflicts, and arrive by cp.async through a two-stage ring: tile j + 1 is
// in flight during tile j's products.  The bias goes from device memory
// straight to the positions of the score accumulator, one tile ahead, and
// is the accumulator's start: S = bias + qu.k^T on the tensor cores, then
// scale, mask and the online softmax on the fragments (quad shuffles for
// the row max and sum), in base 2.  P is rounded to bf16 in registers and
// is the A operand of the P.v product (v through ldmatrix.trans): it never
// goes through shared memory.  A row's blocks walk its key tiles alone: with
// ragged lengths the full rows' blocks set the time, but a walk split over
// two blocks and merged by a second kernel measured slower on the H100 (at
// ~180 registers a thread two blocks fit an SM, so the doubled grid ran in
// two waves).  Bound on the H100: the (B, H, T, T) bias is most of the
// bytes (T/dh times qu, k, v and out together).
//
// float32 inputs (attention_bias_kernel) keep the CUDA cores: TF32 would
// miss the float32 bar.  One block of 256 threads per (32-row query tile,
// head, batch row), eight threads a query row; each 32-key tile brings k, v
// and the (32, 32) bias tile into shared memory with coalesced loads, the
// bias tile landing in the buffer that then holds the probabilities.
// Bound: float32 FMAs fed from shared memory.

#include <cmath>

#include "attention_relpos.cuh"
#include "tensor_core.cuh"

namespace {

using namespace relpos;

constexpr int kProbLd = kBlockK + 1;

template <int DH>
constexpr size_t smem_bytes() {
  // qu tile, k and v tiles (rows padded to DH + 1 floats against bank
  // conflicts), and the bias / probability tile
  return sizeof(float) * ((kBlockQ + 2 * kBlockK) * (DH + 1) + kBlockQ * kProbLd);
}

// dst[r][c] = bias[i0 + r][j0 + c] of one (batch row, head), zero outside
// the (seq, seq) matrix; a warp reads 32 neighbouring columns of one row.
template <typename TB>
__device__ __forceinline__ void load_bias_tile(float* dst, const TB* __restrict__ bias_bh, int i0,
                                               int j0, int seq, int tid) {
  for (int idx = tid; idx < kBlockQ * kBlockK; idx += kThreads) {
    const int r = idx / kBlockK;
    const int c = idx - r * kBlockK;
    const int i = i0 + r;
    const int j = j0 + c;
    dst[r * kProbLd + c] =
        (i < seq && j < seq) ? to_float(bias_bh[static_cast<size_t>(i) * seq + j]) : 0.f;
  }
}

template <typename T, typename TB, int DH>
__global__ void __launch_bounds__(kThreads)
attention_bias_kernel(const T* __restrict__ qu, const T* __restrict__ k, const T* __restrict__ v,
                      const TB* __restrict__ bias, const int* __restrict__ lengths,
                      T* __restrict__ out, int seq, int heads, float scale) {
  constexpr int LD = DH + 1;
  constexpr int kPerThread = DH / 8;
  extern __shared__ float smem[];
  float* s_qu = smem;
  float* s_k = s_qu + kBlockQ * LD;
  float* s_v = s_k + kBlockK * LD;
  float* s_prob = s_v + kBlockK * LD;  // [kBlockQ][kProbLd]: the bias tile, then the probabilities

  const int i0 = blockIdx.x * kBlockQ;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int tid = threadIdx.x;
  const int row = tid >> 3;
  const int sub = tid & 7;
  const int len = lengths[b];
  const int kv_end = (len <= 0 || len > seq) ? seq : len;
  const size_t time_stride = static_cast<size_t>(heads) * DH;
  const size_t batch_base = static_cast<size_t>(b) * seq * time_stride + static_cast<size_t>(h) * DH;
  const TB* bias_bh = bias + (static_cast<size_t>(b) * heads + h) * seq * seq;

  load_rows<T, DH>(s_qu, qu + batch_base, i0, kBlockQ, seq, time_stride, tid);

  float acc[kPerThread];
#pragma unroll
  for (int e = 0; e < kPerThread; ++e) acc[e] = 0.f;
  float m_i = kMaskValue;
  float l_i = 0.f;

  for (int j0 = 0; j0 < kv_end; j0 += kBlockK) {
    __syncthreads();  // the previous tile's k, v and probability reads are done
    load_rows<T, DH>(s_k, k + batch_base, j0, kBlockK, seq, time_stride, tid);
    load_rows<T, DH>(s_v, v + batch_base, j0, kBlockK, seq, time_stride, tid);
    load_bias_tile<TB>(s_prob, bias_bh, i0, j0, seq, tid);
    __syncthreads();

    float s[kBlockK / 8];
    float m_cur = -INFINITY;
#pragma unroll
    for (int c = 0; c < kBlockK / 8; ++c) {
      const int col = sub + 8 * c;
      const int j = j0 + col;
      const float* qa = s_qu + row * LD;
      const float* kr = s_k + col * LD;
      float ac = 0.f;
#pragma unroll 16
      for (int d = 0; d < DH; ++d) ac = fmaf(qa[d], kr[d], ac);
      float sc = (ac + s_prob[row * kProbLd + col]) * scale;
      if (j >= seq) {
        sc = -INFINITY;  // beyond the tensor: no weight at all
      } else if (j >= len) {
        sc = kMaskValue;
      }
      s[c] = sc;
      m_cur = fmaxf(m_cur, sc);
    }
#pragma unroll
    for (int off = 4; off > 0; off >>= 1) m_cur = fmaxf(m_cur, __shfl_xor_sync(0xffffffffu, m_cur, off));
    const float m_new = fmaxf(m_i, m_cur);
    const float alpha = expf(m_i - m_new);
    float psum = 0.f;
#pragma unroll
    for (int c = 0; c < kBlockK / 8; ++c) {
      const float pc = expf(s[c] - m_new);
      // this thread read the bias at this very entry, and no other thread does
      s_prob[row * kProbLd + sub + 8 * c] = to_float(from_float<T>(pc));
      psum += pc;
    }
#pragma unroll
    for (int off = 4; off > 0; off >>= 1) psum += __shfl_xor_sync(0xffffffffu, psum, off);
    l_i = alpha * l_i + psum;
    m_i = m_new;
    __syncwarp();  // the row's probabilities come from the 8 lanes of this warp

#pragma unroll
    for (int e = 0; e < kPerThread; ++e) acc[e] *= alpha;
    for (int jj = 0; jj < kBlockK; ++jj) {
      const float pj = s_prob[row * kProbLd + jj];
      const float* vr = s_v + jj * LD + sub;
#pragma unroll
      for (int e = 0; e < kPerThread; ++e) acc[e] = fmaf(pj, vr[8 * e], acc[e]);
    }
  }

  const int i = i0 + row;
  if (i < seq) {
    const float inv = (l_i == 0.f) ? 1.f : 1.f / l_i;
    T* o = out + batch_base + i * time_stride + sub;
#pragma unroll
    for (int e = 0; e < kPerThread; ++e) o[8 * e] = from_float<T>(acc[e] * inv);
  }
}

constexpr int kTcRows = 64;  // query rows a block: 4 warps of 16
constexpr int kTcKeys = 64;  // keys a tile
constexpr int kTcThreads = 128;

template <int DH>
constexpr size_t tc_smem_bytes() {
  // two stages of the k and v tiles, bf16 rows of DH + 8
  return 2 * 2 * kTcKeys * (DH + 8) * sizeof(__nv_bfloat16);
}

__device__ __forceinline__ float load_bias(const float* p) { return __ldg(p); }
__device__ __forceinline__ float load_bias(const __nv_bfloat16* p) {
  return __uint_as_float(static_cast<unsigned>(__ldg(reinterpret_cast<const unsigned short*>(p))) << 16);
}

template <typename TB, int DH>
__global__ void __launch_bounds__(kTcThreads)
attention_bias_tc_kernel(const __nv_bfloat16* __restrict__ qu, const __nv_bfloat16* __restrict__ k,
                         const __nv_bfloat16* __restrict__ v, const TB* __restrict__ bias,
                         const int* __restrict__ lengths, __nv_bfloat16* __restrict__ out, int seq,
                         int heads, float scale) {
  constexpr int LD = DH + 8;           // a shared row: 16 bytes of padding
  constexpr int KC = DH / 16;          // 16-wide chunks of the head dim (the QK^T depth)
  constexpr int NT = kTcKeys / 8;      // 8-key tiles of the scores
  constexpr int DT = DH / 8;           // 8-wide tiles of the output
  constexpr int kChunks = DH / 8;      // 16-byte chunks a k or v row
  constexpr int kCopies = kTcKeys * kChunks / kTcThreads;
  extern __shared__ __align__(16) __nv_bfloat16 kv_smem[];  // [stage][k, v][kTcKeys][LD]

  const int i0 = blockIdx.x * kTcRows;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, q = lane & 3;
  const int len = lengths[b];
  const int kv_end = (len <= 0 || len > seq) ? seq : len;
  const int tiles = (kv_end + kTcKeys - 1) / kTcKeys;
  const size_t time_stride = static_cast<size_t>(heads) * DH;
  const size_t base = static_cast<size_t>(b) * seq * time_stride + static_cast<size_t>(h) * DH;
  // this thread's two query rows; a row past the sequence computes on row
  // seq - 1's bias and a zero query, and is not stored
  const int row0 = i0 + warp * 16 + g, row1 = row0 + 8;
  const bool in0 = row0 < seq, in1 = row1 < seq;
  const TB* bias0 = bias + ((static_cast<size_t>(b) * heads + h) * seq + (in0 ? row0 : seq - 1)) * seq + 2 * q;
  const TB* bias1 = bias + ((static_cast<size_t>(b) * heads + h) * seq + (in1 ? row1 : seq - 1)) * seq + 2 * q;

  // qu fragments of the warp's 16 rows, held for the whole walk (zero past the sequence)
  unsigned qf[KC][4];
  {
    const unsigned* q0 = reinterpret_cast<const unsigned*>(qu + base + (in0 ? row0 : 0) * time_stride);
    const unsigned* q1 = reinterpret_cast<const unsigned*>(qu + base + (in1 ? row1 : 0) * time_stride);
#pragma unroll
    for (int kc = 0; kc < KC; ++kc) {
      qf[kc][0] = in0 ? q0[kc * 8 + q] : 0u;
      qf[kc][1] = in1 ? q1[kc * 8 + q] : 0u;
      qf[kc][2] = in0 ? q0[kc * 8 + 4 + q] : 0u;
      qf[kc][3] = in1 ? q1[kc * 8 + 4 + q] : 0u;
    }
  }

  auto load_kv = [&](int tile) {  // keys past the sequence are zero-filled
    __nv_bfloat16* ks = kv_smem + (tile & 1) * 2 * kTcKeys * LD;
    __nv_bfloat16* vs = ks + kTcKeys * LD;
#pragma unroll
    for (int i = 0; i < kCopies; ++i) {
      const int idx = tid + i * kTcThreads;
      const int r = idx / kChunks, c = (idx % kChunks) * 8;
      const int j = tile * kTcKeys + r;
      const bool valid = j < seq;
      const size_t off = base + static_cast<size_t>(valid ? j : 0) * time_stride + c;
      tc::cp_async16(ks + r * LD + c, k + off, valid);
      tc::cp_async16(vs + r * LD + c, v + off, valid);
    }
  };
  // the bias at this thread's score positions of a key tile: keys
  // tile * 64 + nt * 8 + 2q and + 1; past the sequence (the last tile only)
  // the read stays at key seq - 1, and the score is masked anyway
  auto load_bias_tile = [&](int tile, float (&dst)[NT][4]) {
    const int j0 = tile * kTcKeys;
    if (j0 + kTcKeys <= seq) {
#pragma unroll
      for (int nt = 0; nt < NT; ++nt) {
        dst[nt][0] = load_bias(bias0 + j0 + nt * 8);
        dst[nt][1] = load_bias(bias0 + j0 + nt * 8 + 1);
        dst[nt][2] = load_bias(bias1 + j0 + nt * 8);
        dst[nt][3] = load_bias(bias1 + j0 + nt * 8 + 1);
      }
    } else {
      const int last = seq - 1 - 2 * q;  // bias0/1 point at key 2q
#pragma unroll
      for (int nt = 0; nt < NT; ++nt) {
        const int j = min(j0 + nt * 8, last), j1 = min(j0 + nt * 8 + 1, last);
        dst[nt][0] = load_bias(bias0 + j);
        dst[nt][1] = load_bias(bias0 + j1);
        dst[nt][2] = load_bias(bias1 + j);
        dst[nt][3] = load_bias(bias1 + j1);
      }
    }
  };

  const float scale2 = scale * 1.4426950408889634f;  // scores in base 2: exp(x) = exp2(x log2 e)
  float o[DT][4] = {};
  float m0 = -INFINITY, m1 = -INFINITY;  // running max of rows row0 and row1 (base 2)
  float l0 = 0.f, l1 = 0.f;              // this thread's share of their normalisers
  float bias_next[NT][4];
  load_kv(0);
  tc::cp_async_commit();
  load_bias_tile(0, bias_next);

  for (int tile = 0; tile < tiles; ++tile) {
    float s[NT][4];
#pragma unroll
    for (int nt = 0; nt < NT; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[nt][e] = bias_next[nt][e];  // the bias starts the sum
    if (tile + 1 < tiles) {
      load_kv(tile + 1);
      load_bias_tile(tile + 1, bias_next);
    }
    tc::cp_async_commit();  // an empty group on the last tile keeps the count
    tc::cp_async_wait_one();
    __syncthreads();  // this tile's k and v, from every thread, have landed
    const __nv_bfloat16* ks = kv_smem + (tile & 1) * 2 * kTcKeys * LD;
    const __nv_bfloat16* vs = ks + kTcKeys * LD;
    const int mat = lane >> 3, mrow = lane & 7;  // ldmatrix: the matrix and row this lane addresses

    // S += qu . k^T: k rows (keys) as the column-major B operand
#pragma unroll
    for (int kc = 0; kc < KC; ++kc)
#pragma unroll
      for (int np = 0; np < NT / 2; ++np) {
        unsigned r[4];
        tc::ldmatrix_x4(r, ks + (np * 16 + (mat >> 1) * 8 + mrow) * LD + kc * 16 + (mat & 1) * 8);
        tc::mma_bf16(s[2 * np], qf[kc], r[0], r[1]);
        tc::mma_bf16(s[2 * np + 1], qf[kc], r[2], r[3]);
      }

    // scale, mask, online softmax (a row's 64 scores lie in the 4 lanes of a quad)
    float mx0 = -INFINITY, mx1 = -INFINITY;
#pragma unroll
    for (int nt = 0; nt < NT; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int j = tile * kTcKeys + nt * 8 + 2 * q + (e & 1);
        float x = s[nt][e] * scale2;
        if (j >= seq) {
          x = -INFINITY;  // beyond the tensor: no weight at all
        } else if (j >= len) {
          x = kMaskValue;
        }
        s[nt][e] = x;
        if (e < 2) {
          mx0 = fmaxf(mx0, x);
        } else {
          mx1 = fmaxf(mx1, x);
        }
      }
#pragma unroll
    for (int off = 1; off < 4; off <<= 1) {
      mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, off));
      mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, off));
    }
    const float mn0 = fmaxf(m0, mx0), mn1 = fmaxf(m1, mx1);  // finite: every tile holds a key < seq
    const float alpha0 = exp2f(m0 - mn0), alpha1 = exp2f(m1 - mn1);
    m0 = mn0;
    m1 = mn1;
    float ps0 = 0.f, ps1 = 0.f;
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) {
      s[nt][0] = exp2f(s[nt][0] - mn0);
      s[nt][1] = exp2f(s[nt][1] - mn0);
      s[nt][2] = exp2f(s[nt][2] - mn1);
      s[nt][3] = exp2f(s[nt][3] - mn1);
      ps0 += s[nt][0] + s[nt][1];
      ps1 += s[nt][2] + s[nt][3];
    }
    l0 = l0 * alpha0 + ps0;  // unrounded probabilities
    l1 = l1 * alpha1 + ps1;
#pragma unroll
    for (int dt = 0; dt < DT; ++dt) {
      o[dt][0] *= alpha0;
      o[dt][1] *= alpha0;
      o[dt][2] *= alpha1;
      o[dt][3] *= alpha1;
    }

    // O += P . v: P rounded to bf16 in registers as the A operand (score tiles
    // 2c and 2c + 1 are its 16 keys), v rows through ldmatrix.trans
#pragma unroll
    for (int c = 0; c < kTcKeys / 16; ++c) {
      const unsigned pa[4] = {tc::pack_bf16(s[2 * c][0], s[2 * c][1]), tc::pack_bf16(s[2 * c][2], s[2 * c][3]),
                              tc::pack_bf16(s[2 * c + 1][0], s[2 * c + 1][1]),
                              tc::pack_bf16(s[2 * c + 1][2], s[2 * c + 1][3])};
#pragma unroll
      for (int dp = 0; dp < DT / 2; ++dp) {
        unsigned r[4];
        tc::ldmatrix_x4_trans(r, vs + (c * 16 + (mat & 1) * 8 + mrow) * LD + dp * 16 + (mat >> 1) * 8);
        tc::mma_bf16(o[2 * dp], pa, r[0], r[1]);
        tc::mma_bf16(o[2 * dp + 1], pa, r[2], r[3]);
      }
    }
    __syncthreads();  // this stage's k and v are read before the next copies into it
  }

#pragma unroll
  for (int off = 1; off < 4; off <<= 1) {
    l0 += __shfl_xor_sync(0xffffffffu, l0, off);
    l1 += __shfl_xor_sync(0xffffffffu, l1, off);
  }
  const float inv0 = (l0 == 0.f) ? 1.f : 1.f / l0;
  const float inv1 = (l1 == 0.f) ? 1.f : 1.f / l1;
  if (in0) {
    unsigned* o0 = reinterpret_cast<unsigned*>(out + base + static_cast<size_t>(row0) * time_stride);
#pragma unroll
    for (int dt = 0; dt < DT; ++dt) o0[dt * 4 + q] = tc::pack_bf16(o[dt][0] * inv0, o[dt][1] * inv0);
  }
  if (in1) {
    unsigned* o1 = reinterpret_cast<unsigned*>(out + base + static_cast<size_t>(row1) * time_stride);
#pragma unroll
    for (int dt = 0; dt < DT; ++dt) o1[dt * 4 + q] = tc::pack_bf16(o[dt][2] * inv1, o[dt][3] * inv1);
  }
}

struct Args {
  const void *qu, *k, *v, *bias;
  const int* lengths;
  void* out;
  int batch, seq, heads;
  float scale;
  cudaStream_t stream;
};

template <typename T, typename TB, int DH>
cudaError_t launch(const Args& a) {
  constexpr size_t smem = smem_bytes<DH>();
  static bool configured = false;
  if (!configured) {
    const cudaError_t err =
        cudaFuncSetAttribute(attention_bias_kernel<T, TB, DH>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (err != cudaSuccess) return err;
    configured = true;
  }
  const dim3 grid((a.seq + kBlockQ - 1) / kBlockQ, a.heads, a.batch);
  attention_bias_kernel<T, TB, DH><<<grid, kThreads, smem, a.stream>>>(
      static_cast<const T*>(a.qu), static_cast<const T*>(a.k), static_cast<const T*>(a.v),
      static_cast<const TB*>(a.bias), a.lengths, static_cast<T*>(a.out), a.seq, a.heads, a.scale);
  return cudaGetLastError();
}

template <typename TB, int DH>
cudaError_t launch_tc(const Args& a) {
  constexpr size_t smem = tc_smem_bytes<DH>();
  static bool configured = false;
  if (!configured) {
    const cudaError_t err =
        cudaFuncSetAttribute(attention_bias_tc_kernel<TB, DH>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (err != cudaSuccess) return err;
    configured = true;
  }
  const dim3 grid((a.seq + kTcRows - 1) / kTcRows, a.heads, a.batch);
  attention_bias_tc_kernel<TB, DH><<<grid, kTcThreads, smem, a.stream>>>(
      static_cast<const __nv_bfloat16*>(a.qu), static_cast<const __nv_bfloat16*>(a.k),
      static_cast<const __nv_bfloat16*>(a.v), static_cast<const TB*>(a.bias), a.lengths,
      static_cast<__nv_bfloat16*>(a.out), a.seq, a.heads, a.scale);
  return cudaGetLastError();
}

cudaError_t dispatch_f32(int head_dim, const Args& a) {
  switch (head_dim) {
    case 16: return launch<float, float, 16>(a);
    case 32: return launch<float, float, 32>(a);
    case 64: return launch<float, float, 64>(a);
    case 128: return launch<float, float, 128>(a);
    default: return cudaErrorInvalidValue;
  }
}

template <typename TB>
cudaError_t dispatch_bf16(int head_dim, const Args& a) {
  switch (head_dim) {
    case 16: return launch_tc<TB, 16>(a);
    case 32: return launch_tc<TB, 32>(a);
    case 64: return launch_tc<TB, 64>(a);
    case 128: return launch_tc<TB, 128>(a);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// bias_is_bf16 may be 0 with is_bf16 = 1 (a float32 bias beside bfloat16
// inputs); a bfloat16 bias beside float32 inputs is refused.  bfloat16
// inputs must lie on 16-byte boundaries (the wrapper sees to it).
extern "C" int attention_bias_fwd(const void* qu, const void* k, const void* v, const void* bias,
                                  const void* lengths, void* out, int batch, int seq, int heads,
                                  int head_dim, float scale, int is_bf16, int bias_is_bf16,
                                  void* stream) {
  const Args a{qu, k, v, bias, static_cast<const int*>(lengths), out,
               batch, seq, heads, scale, static_cast<cudaStream_t>(stream)};
  if (!is_bf16) {
    return bias_is_bf16 ? cudaErrorInvalidValue : dispatch_f32(head_dim, a);
  }
  return bias_is_bf16 ? dispatch_bf16<__nv_bfloat16>(head_dim, a) : dispatch_bf16<float>(head_dim, a);
}

// Flash attention forward with an additive bias input, for sm_90a.
//
// Replaces nn_conformer_for_speech_recognition_tpu/ops/pallas/attention.py:
// _flash_kernel (the bias-input variant behind `flash_attention`).
//   s[i][j] = ((qu_i . k_j) + bias[b][h][i][j]) * scale   (the scale multiplies the bias too)
//   s[i][j] = -1e30 where j >= length[b]
//   out_i   = softmax_j(s[i]) @ v
// Layout: qu, k, v, out (B, T, H, dh) and bias (B, H, T, T), contiguous; the
// bias is float32 or has the inputs' type.  No padded or transposed copy is
// made: tiles are read by index and the ragged edge is masked here.
//
// One block of 256 threads per (32-row query tile, head, batch row); eight
// threads share a query row.  The block walks the 32-key tiles up to the
// row's length and no further: a key at or beyond the length has weight
// exp(-1e30 - m) = 0 exactly once a valid key has set the running max, so
// the tiles that hold only such keys change nothing (a length of 0 walks
// all of them and gives the mean of v, as the plain version does).  Each
// tile brings k, v and the (32, 32) bias tile into shared memory with
// coalesced loads; the bias tile lands in the buffer that then holds the
// probabilities, each thread overwriting the entries it read.  Running max,
// normaliser and the output accumulator stay in float32 registers; the
// probabilities are rounded to v's type before the value product, where the
// TPU kernel casts them, and summed unrounded into the normaliser.
// Every query row is computed, valid or not: only keys are masked.
//
// Bound on the H100: the (B, H, T, T) bias is the traffic (T/dh times the
// size of qu, k, v and out together), but at these tile sizes the float32
// FMAs fed from shared memory on the CUDA cores take longer than the bytes.

#include <cmath>

#include "attention_relpos.cuh"

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

template <typename T, typename TB>
cudaError_t dispatch(int head_dim, const Args& a) {
  switch (head_dim) {
    case 16: return launch<T, TB, 16>(a);
    case 32: return launch<T, TB, 32>(a);
    case 64: return launch<T, TB, 64>(a);
    case 128: return launch<T, TB, 128>(a);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// bias_is_bf16 may be 0 with is_bf16 = 1 (a float32 bias beside bfloat16
// inputs); a bfloat16 bias beside float32 inputs is refused.
extern "C" int attention_bias_fwd(const void* qu, const void* k, const void* v, const void* bias,
                                  const void* lengths, void* out, int batch, int seq, int heads,
                                  int head_dim, float scale, int is_bf16, int bias_is_bf16,
                                  void* stream) {
  const Args a{qu, k, v, bias, static_cast<const int*>(lengths), out,
               batch, seq, heads, scale, static_cast<cudaStream_t>(stream)};
  if (!is_bf16) {
    return bias_is_bf16 ? cudaErrorInvalidValue : dispatch<float, float>(head_dim, a);
  }
  return bias_is_bf16 ? dispatch<__nv_bfloat16, __nv_bfloat16>(head_dim, a)
                      : dispatch<__nv_bfloat16, float>(head_dim, a);
}

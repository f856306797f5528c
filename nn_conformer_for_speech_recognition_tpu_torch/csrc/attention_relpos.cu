// Rel-pos (Transformer-XL) flash attention forward for sm_90a.
//
// Replaces nn_conformer_for_speech_recognition_tpu/ops/pallas/attention.py:
// _flash_relpos_kernel (forward, with or without the logsumexp output).
//   s[i][j] = ((qu_i . k_j) + (qv_i . p[j - i + T - 1])) * scale
//   s[i][j] = -1e30 where j >= length[b]
//   out_i   = softmax_j(s[i]) @ v
//   lse_i   = m_i + log(max(l_i, 1e-30))   (training variant only)
// Layout: qu, qv, k, v, out (B, T, H, dh), p (2T-1, H, dh) and lse
// (B, H, T) float32, contiguous.  The lse store is a template flag, so the
// inference instantiation writes nothing more.
//
// One block of 256 threads per (32-row query tile, head, batch row); eight
// threads share a query row.  Each 32-key tile loads k, v and the 63-row
// rel-pos band [r_lo, r_lo + 63) into shared memory, where
// r_lo = j0 - (i0 + 31) + T - 1, so p[j - i + T - 1] sits at band row
// (j - j0) - (i - i0) + 31: index arithmetic in place of the TPU's lane-roll
// skew.  Online softmax state (m, l) and the output accumulator stay in
// float32 registers.  Bound on the H100: CUDA-core float32 FMAs.
//
// Routes: float32 inputs run this kernel; bfloat16 inputs go to the
// tensor-core kernel of attention_relpos_tc.cu (attention_relpos_tc_kernel),
// from the same entry point: the bfloat16 instantiations of this kernel are
// not compiled.

#include <cmath>

#include "attention_relpos.cuh"

namespace {

using namespace relpos;

template <int DH>
constexpr size_t smem_bytes() {
  // qu, qv tiles, k, v tiles, rel-pos band (rows padded to DH + 1 floats
  // against bank conflicts), and the probability tile
  return sizeof(float) * ((2 * kBlockQ + 2 * kBlockK + kBand) * (DH + 1) + kBlockQ * (kBlockK + 1));
}

template <typename T, int DH, bool LSE>
__global__ void __launch_bounds__(kThreads)
attention_relpos_kernel(const T* __restrict__ qu, const T* __restrict__ qv,
                        const T* __restrict__ k, const T* __restrict__ v,
                        const T* __restrict__ p, const int* __restrict__ lengths,
                        T* __restrict__ out, float* __restrict__ lse, int seq, int heads,
                        float scale) {
  constexpr int LD = DH + 1;
  constexpr int kPerThread = DH / 8;
  extern __shared__ float smem[];
  float* s_qu = smem;
  float* s_qv = s_qu + kBlockQ * LD;
  float* s_k = s_qv + kBlockQ * LD;
  float* s_v = s_k + kBlockK * LD;
  float* s_p = s_v + kBlockK * LD;
  float* s_prob = s_p + kBand * LD;  // [kBlockQ][kBlockK + 1]

  const int i0 = blockIdx.x * kBlockQ;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int tid = threadIdx.x;
  const int row = tid >> 3;
  const int sub = tid & 7;
  const int len = lengths[b];
  const size_t time_stride = static_cast<size_t>(heads) * DH;
  const size_t batch_base = static_cast<size_t>(b) * seq * time_stride + static_cast<size_t>(h) * DH;

  load_rows<T, DH>(s_qu, qu + batch_base, i0, kBlockQ, seq, time_stride, tid);
  load_rows<T, DH>(s_qv, qv + batch_base, i0, kBlockQ, seq, time_stride, tid);

  float acc[kPerThread];
#pragma unroll
  for (int e = 0; e < kPerThread; ++e) acc[e] = 0.f;
  float m_i = kMaskValue;
  float l_i = 0.f;
  const int n_rel = 2 * seq - 1;

  for (int j0 = 0; j0 < seq; j0 += kBlockK) {
    __syncthreads();  // the previous tile's k, v, band and prob reads are done
    load_rows<T, DH>(s_k, k + batch_base, j0, kBlockK, seq, time_stride, tid);
    load_rows<T, DH>(s_v, v + batch_base, j0, kBlockK, seq, time_stride, tid);
    load_band<T, DH>(s_p, p, j0 - (i0 + kBlockQ - 1) + seq - 1, kBand, n_rel, heads, h, tid);
    __syncthreads();

    float s[kBlockK / 8];
    float m_cur = -INFINITY;
#pragma unroll
    for (int c = 0; c < kBlockK / 8; ++c) {
      const int col = sub + 8 * c;
      const int j = j0 + col;
      const float* qa = s_qu + row * LD;
      const float* qb = s_qv + row * LD;
      const float* kr = s_k + col * LD;
      const float* pr = s_p + (col - row + kBlockQ - 1) * LD;
      float ac = 0.f, bd = 0.f;
#pragma unroll 16
      for (int d = 0; d < DH; ++d) {
        ac = fmaf(qa[d], kr[d], ac);
        bd = fmaf(qb[d], pr[d], bd);
      }
      float sc = (ac + bd) * scale;
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
      s_prob[row * (kBlockK + 1) + sub + 8 * c] = pc;
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
      const float pj = s_prob[row * (kBlockK + 1) + jj];
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
    if (LSE && sub == 0) {
      lse[(static_cast<size_t>(b) * heads + h) * seq + i] = m_i + logf(fmaxf(l_i, 1e-30f));
    }
  }
}

template <typename T, int DH, bool LSE>
cudaError_t launch(const FwdArgs& a) {
  constexpr size_t smem = smem_bytes<DH>();
  static bool configured = false;
  if (!configured) {
    const cudaError_t err =
        cudaFuncSetAttribute(attention_relpos_kernel<T, DH, LSE>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (err != cudaSuccess) return err;
    configured = true;
  }
  const dim3 grid((a.seq + kBlockQ - 1) / kBlockQ, a.heads, a.batch);
  attention_relpos_kernel<T, DH, LSE><<<grid, kThreads, smem, a.stream>>>(
      static_cast<const T*>(a.qu), static_cast<const T*>(a.qv), static_cast<const T*>(a.k),
      static_cast<const T*>(a.v), static_cast<const T*>(a.p), a.lengths, static_cast<T*>(a.out),
      a.lse, a.seq, a.heads, a.scale);
  return cudaGetLastError();
}

template <typename T, int DH>
cudaError_t launch_variant(const FwdArgs& a) {
  return a.lse != nullptr ? launch<T, DH, true>(a) : launch<T, DH, false>(a);
}

cudaError_t dispatch_f32(int head_dim, const FwdArgs& a) {
  switch (head_dim) {
    case 16: return launch_variant<float, 16>(a);
    case 32: return launch_variant<float, 32>(a);
    case 64: return launch_variant<float, 64>(a);
    case 128: return launch_variant<float, 128>(a);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" int attention_relpos_fwd(const void* qu, const void* qv, const void* k, const void* v,
                                    const void* p, const void* lengths, void* out, void* lse,
                                    int batch, int seq, int heads, int head_dim, float scale,
                                    int is_bf16, void* stream) {
  const relpos::FwdArgs a{qu, qv, k, v, p, static_cast<const int*>(lengths), out, static_cast<float*>(lse),
                          batch, seq, heads, scale, static_cast<cudaStream_t>(stream)};
  return is_bf16 ? relpos::fwd_tc(head_dim, a) : dispatch_f32(head_dim, a);
}

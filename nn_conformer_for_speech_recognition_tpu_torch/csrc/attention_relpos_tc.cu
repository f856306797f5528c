// Rel-pos (Transformer-XL) flash attention forward for bfloat16 inputs, on
// the H100's tensor cores (mma.sync m16n8k16, bf16 operands, float32 sums;
// not wgmma).
//
// Replaces, for bfloat16, nn_conformer_for_speech_recognition_tpu/ops/
// pallas/attention.py:_flash_relpos_kernel (:281, pallas_call :416), with or
// without the logsumexp output.  Float32 inputs keep the CUDA-core kernel of
// attention_relpos.cu, which is also where the entry point lives.
//   s[i][j] = ((qu_i . k_j) + (qv_i . p[j - i + T - 1])) * scale
//   s[i][j] = -1e30 where j >= length[b]
//   out_i   = softmax_j(s[i]) @ v,  the probabilities rounded to bf16 before
//             the product (as the TPU kernel casts them to v's type), their
//             sum l_i unrounded, the l == 0 -> 1 guard
//   lse_i   = m_i + log(max(l_i, 1e-30)), natural log, float32 (B, H, T)
//             (the training variant only: a template flag)
//
// attention_relpos_tc_kernel: 4 warps of 16 query rows, 64 rows a block,
// grid (ceil(T / 64), H, B).  qu and qv of the block's rows are read once.
// Key tiles of 64 are walked up to the length: a key at or past it weighs
// exp(-1e30 - m) = 0 once a valid key has set the running max m, so the
// tiles that hold only such keys change nothing; a length of 0 walks every
// tile, each key then weighing exp(0): the mean of v, as the plain version
// gives.  A tile's k and v come through a two-stage cp.async ring, its
// 127-row band of p (rows j0 - i0 - 63 + T - 1 ...) as two 64-row chunks of
// a three-chunk ring (the next tile shares one chunk, so one new chunk a
// tile), each one tile ahead of the products.  The scores start as the
// rel-pos term read back skewed from the warp's buffer
// (relpos_tc::skewed_band_scores), then S += qu . k^T; scale, mask and the
// online softmax run on the fragments in base 2 (a row's 64 scores lie in
// the 4 lanes of a quad: quad shuffles for the max and the sum).  P is
// rounded to bf16 in registers and is the A operand of P . v (v through
// ldmatrix.trans): it never goes through shared memory.  Every query row is
// computed (only keys are masked); rows past T are not stored.
//
// Bound on the H100 (chip_smoke.py): 6 * dh operations per (query, valid
// key) pair and head at 989 TFLOP/s.  The kernel does more raw products
// than that (BD over 80 band rows a warp, all of a tile's keys up to the
// length); the bound counts the work, not this implementation.
//
// Budget at dh = 64: 105,472 bytes of dynamic shared memory (qu, qv 18,432;
// k, v in two stages 36,864; band ring 27,648; warp buffers 22,528), so two
// blocks fit an SM.  The compiler's report (-Xptxas -v) and the occupancy
// and spill readings from attention_relpos_fwd_tc_plan are in PERF.md.

#include <cmath>

#include "attention_relpos.cuh"
#include "attention_relpos_tc.cuh"

namespace {

using namespace relpos_tc;

template <int DH>
constexpr size_t fwd_smem() {
  // qu, qv | k, v two stages | band ring of 3 chunks | warp buffers
  return (2 + 4 + 3) * Tiles<DH>::kTileBytes + Tiles<DH>::kWarpBytes;
}

template <int DH, bool LSE>
__global__ void __launch_bounds__(kThreads)
attention_relpos_tc_kernel(const bf16* __restrict__ qu, const bf16* __restrict__ qv, const bf16* __restrict__ k,
                           const bf16* __restrict__ v, const bf16* __restrict__ p, const int* __restrict__ lengths,
                           bf16* __restrict__ out, float* __restrict__ lse, int seq, int heads, float scale) {
  using G = Tiles<DH>;
  constexpr int LD = G::LD, DT = G::DT, NT = kKeys / 8;
  extern __shared__ __align__(16) unsigned char smem[];
  bf16* s_q = reinterpret_cast<bf16*>(smem);  // qu, qv of the block's rows
  bf16* s_kv = s_q + 2 * G::kTile;            // [stage][k, v][kKeys][LD]
  bf16* s_band = s_kv + 4 * G::kTile;         // [chunk % 3][kKeys][LD]

  const int i0 = blockIdx.x * kRows, h = blockIdx.y, b = blockIdx.z;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, q = lane & 3;
  const int len = lengths[b];
  const int kv_end = (len <= 0 || len > seq) ? seq : len;
  const int tiles = (kv_end + kKeys - 1) / kKeys;
  const int n_rel = 2 * seq - 1;
  const size_t stride = static_cast<size_t>(heads) * DH;
  const size_t base = static_cast<size_t>(b) * seq * stride + static_cast<size_t>(h) * DH;
  const bf16* p_h = p + static_cast<size_t>(h) * DH;
  // band chunk c holds table rows rel_base + 64 c ...; key tile n meets chunks n and n + 1
  const int rel_base = seq - 1 - i0 - (kRows - 1);
  float* wbuf = reinterpret_cast<float*>(s_band + 3 * G::kTile) + warp * 16 * kWinLd;
  const bf16* qu_w = s_q + warp * 16 * LD;
  const bf16* qv_w = qu_w + G::kTile;
  const int win0 = kRows - 16 - 16 * warp;  // the warp's first band row of a tile's 128

  auto load_kv = [&](int tile) {
    bf16* dst = s_kv + (tile & 1) * 2 * G::kTile;
    copy_rows<DH>(dst, k + base, tile * kKeys, seq, stride, tid);
    copy_rows<DH>(dst + G::kTile, v + base, tile * kKeys, seq, stride, tid);
  };
  auto load_band = [&](int chunk) {
    copy_rows<DH>(s_band + (chunk % 3) * G::kTile, p_h, rel_base + chunk * kKeys, n_rel, stride, tid);
  };
  copy_rows<DH>(s_q, qu + base, i0, seq, stride, tid);
  copy_rows<DH>(s_q + G::kTile, qv + base, i0, seq, stride, tid);
  load_kv(0);
  load_band(0);
  load_band(1);
  tc::cp_async_commit();

  // scores in base 2 (exp(x) = exp2(x log2 e)); a masked key's -1e30 in the same units
  const float scale2 = scale * kLog2e, mask2 = relpos::kMaskValue * kLog2e;
  float o[DT][4] = {};
  float m0 = -INFINITY, m1 = -INFINITY;  // running max of the thread's rows g and g + 8 (base 2)
  float l0 = 0.f, l1 = 0.f;              // this thread's share of their normalisers
  for (int n = 0; n < tiles; ++n) {
    if (n + 1 < tiles) {
      load_kv(n + 1);
      load_band(n + 2);
    }
    tc::cp_async_commit();  // an empty group on the last tile keeps the count
    tc::cp_async_wait_one();
    __syncthreads();  // tile n's k, v and band, from every thread, have landed
    const bf16* ks = s_kv + (n & 1) * 2 * G::kTile;
    const bf16* vs = ks + G::kTile;
    const bf16* chunk0 = s_band + (n % 3) * G::kTile;
    const bf16* chunk1 = s_band + ((n + 1) % 3) * G::kTile;
    // the warp's band row c (0 <= c < 80): tile row win0 + c
    auto band_row = [&](int c) {
      const int r = win0 + c;
      return (r < kKeys ? chunk0 : chunk1) + (r & (kKeys - 1)) * LD;
    };

    // S = skew(qv . band^T) + qu . k^T
    float s[NT][4];
    skewed_band_scores<DH>(s, qv_w, band_row, wbuf, lane);
    mma_abt<DH>(s, qu_w, [&](int r) { return ks + r * LD; }, lane);

    // scale, mask, online softmax
    float mx0 = -INFINITY, mx1 = -INFINITY;
#pragma unroll
    for (int nt = 0; nt < NT; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int j = n * kKeys + nt * 8 + 2 * q + (e & 1);
        float x = s[nt][e] * scale2;
        if (j >= seq) {
          x = -INFINITY;  // beyond the tensor: no weight at all
        } else if (j >= len) {
          x = mask2;
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

    // O += P . v: P rounded to bf16 in registers as the A operand (score tiles 2c and 2c + 1 are its 16 keys)
#pragma unroll
    for (int c = 0; c < kKeys / 16; ++c) {
      const unsigned pa[4] = {tc::pack_bf16(s[2 * c][0], s[2 * c][1]), tc::pack_bf16(s[2 * c][2], s[2 * c][3]),
                              tc::pack_bf16(s[2 * c + 1][0], s[2 * c + 1][1]),
                              tc::pack_bf16(s[2 * c + 1][2], s[2 * c + 1][3])};
      mma_ab<DH>(o, pa, [&](int r) { return vs + (c * 16 + r) * LD; }, lane);
    }
    __syncthreads();  // this tile's stages are read before the next copies into them
  }

#pragma unroll
  for (int off = 1; off < 4; off <<= 1) {
    l0 += __shfl_xor_sync(0xffffffffu, l0, off);
    l1 += __shfl_xor_sync(0xffffffffu, l1, off);
  }
  const int row0 = i0 + warp * 16 + g, row1 = row0 + 8;
  const size_t stat = (static_cast<size_t>(b) * heads + h) * seq;
  if (row0 < seq) {
    const float inv = (l0 == 0.f) ? 1.f : 1.f / l0;
    unsigned* o0 = reinterpret_cast<unsigned*>(out + base + static_cast<size_t>(row0) * stride);
#pragma unroll
    for (int dt = 0; dt < DT; ++dt) o0[dt * 4 + q] = tc::pack_bf16(o[dt][0] * inv, o[dt][1] * inv);
    if (LSE && q == 0) lse[stat + row0] = m0 * kLn2 + logf(fmaxf(l0, 1e-30f));
  }
  if (row1 < seq) {
    const float inv = (l1 == 0.f) ? 1.f : 1.f / l1;
    unsigned* o1 = reinterpret_cast<unsigned*>(out + base + static_cast<size_t>(row1) * stride);
#pragma unroll
    for (int dt = 0; dt < DT; ++dt) o1[dt * 4 + q] = tc::pack_bf16(o[dt][2] * inv, o[dt][3] * inv);
    if (LSE && q == 0) lse[stat + row1] = m1 * kLn2 + logf(fmaxf(l1, 1e-30f));
  }
}

// the kernel's shared-memory opt-in, once
template <int DH, bool LSE>
cudaError_t configure() {
  static const cudaError_t status = opt_in(attention_relpos_tc_kernel<DH, LSE>, fwd_smem<DH>());
  return status;
}

template <int DH, bool LSE>
cudaError_t launch(const relpos::FwdArgs& a) {
  const cudaError_t err = configure<DH, LSE>();
  if (err != cudaSuccess) return err;
  const dim3 grid((a.seq + kRows - 1) / kRows, a.heads, a.batch);
  attention_relpos_tc_kernel<DH, LSE><<<grid, kThreads, fwd_smem<DH>(), a.stream>>>(
      static_cast<const bf16*>(a.qu), static_cast<const bf16*>(a.qv), static_cast<const bf16*>(a.k),
      static_cast<const bf16*>(a.v), static_cast<const bf16*>(a.p), a.lengths, static_cast<bf16*>(a.out), a.lse,
      a.seq, a.heads, a.scale);
  return cudaGetLastError();
}

template <int DH>
cudaError_t launch_variant(const relpos::FwdArgs& a) {
  return a.lse != nullptr ? launch<DH, true>(a) : launch<DH, false>(a);
}

template <int DH, bool LSE>
cudaError_t plan(int* blocks_per_sm, int* registers, int* local_bytes, int* smem_bytes) {
  const cudaError_t err = configure<DH, LSE>();
  if (err != cudaSuccess) return err;
  return plan_of(attention_relpos_tc_kernel<DH, LSE>, fwd_smem<DH>(), blocks_per_sm, registers, local_bytes,
                 smem_bytes);
}

template <int DH>
cudaError_t plan_variant(int with_lse, int* blocks_per_sm, int* registers, int* local_bytes, int* smem_bytes) {
  return with_lse ? plan<DH, true>(blocks_per_sm, registers, local_bytes, smem_bytes)
                  : plan<DH, false>(blocks_per_sm, registers, local_bytes, smem_bytes);
}

}  // namespace

namespace relpos {

cudaError_t fwd_tc(int head_dim, const FwdArgs& a) {
  switch (head_dim) {
    case 16: return launch_variant<16>(a);
    case 32: return launch_variant<32>(a);
    case 64: return launch_variant<64>(a);
    case 128: return launch_variant<128>(a);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace relpos

// with_lse 0: the inference variant, 1: the training one.  Host only: the
// blocks an SM holds at once (the occupancy calculator, after the kernel's
// shared-memory opt-in), registers a thread, local memory a thread
// (non-zero: spills or a stack frame) and dynamic shared memory a block.
extern "C" int attention_relpos_fwd_tc_plan(int with_lse, int head_dim, int* blocks_per_sm, int* registers,
                                            int* local_bytes, int* smem_bytes) {
  switch (head_dim) {
    case 16: return plan_variant<16>(with_lse, blocks_per_sm, registers, local_bytes, smem_bytes);
    case 32: return plan_variant<32>(with_lse, blocks_per_sm, registers, local_bytes, smem_bytes);
    case 64: return plan_variant<64>(with_lse, blocks_per_sm, registers, local_bytes, smem_bytes);
    case 128: return plan_variant<128>(with_lse, blocks_per_sm, registers, local_bytes, smem_bytes);
    default: return cudaErrorInvalidValue;
  }
}

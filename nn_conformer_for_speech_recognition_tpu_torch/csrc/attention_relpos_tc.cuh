// Shared by the rel-pos attention kernels on the tensor cores
// (attention_relpos_tc.cu: the forward; attention_relpos_bwd_tc.cu: dq, dkv
// and dband), bfloat16 inputs only: tile sizes, the 16-byte copies of
// (64, DH) tiles into padded shared rows, the mma.sync products over them,
// the per-warp float32 buffer that turns the rel-pos product into the
// scores' skew, and the host-side shared-memory opt-in and plan.
//
// Every kernel runs 4 warps of 16 rows (128 threads).  Tiles are bf16 in
// shared memory with rows padded by 16 bytes (conflict-free ldmatrix).  A
// warp's 16 query rows meet 79 rows of the 127-row band of the rel-pos
// table that a (64 query, 64 key) tile needs; it forms BD = qv . band^T over
// 80 of them, stores BD to its buffer (16 rows x 80, row stride 88 floats:
// the float2 stores are conflict-free, the shifted reads at most 2-way) and
// reads it back skewed: s[i][j] starts as BD[i][j - i + 15].

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "tensor_core.cuh"

namespace relpos_tc {

using bf16 = __nv_bfloat16;

constexpr int kRows = 64;             // query rows of a tile (a forward or dq block, a dkv or dband step)
constexpr int kKeys = 64;             // keys of a tile; a ring chunk of band or key rows
constexpr int kThreads = 128;         // 4 warps of 16 rows
constexpr int kWin = kKeys + 16;      // a warp's 16 rows meet 79 band rows: 80
constexpr int kWinLd = kWin + 8;      // float row stride of the per-warp buffer (88 = 24 mod 32)
constexpr int kShift = kWin - kKeys - 1;  // s[i][j] meets window column j - i + 15
constexpr float kLog2e = 1.4426950408889634f;
constexpr float kLn2 = 0.6931471805599453f;

template <int DH>
struct Tiles {
  static constexpr int LD = DH + 8;  // bf16 row stride: 16 bytes of padding
  static constexpr int DT = DH / 8;   // 8-wide tiles of an output row
  static constexpr int kTile = kRows * LD;
  static constexpr size_t kTileBytes = kTile * sizeof(bf16);
  static constexpr size_t kWarpBytes = 4 * 16 * kWinLd * sizeof(float);  // the four warps' buffers
};

// dst[r] = src[t0 + r] for the 64 rows r, zero where t0 + r lies outside
// [0, n); `base` points at row 0, rows `stride` elements apart.
template <int DH>
__device__ __forceinline__ void copy_rows(bf16* dst, const bf16* __restrict__ base, int t0, int n, size_t stride,
                                          int tid) {
  constexpr int LD = DH + 8, kChunks = DH / 8;
#pragma unroll
  for (int c = 0; c < kRows * kChunks / kThreads; ++c) {
    const int idx = tid + c * kThreads;
    const int r = idx / kChunks, col = (idx % kChunks) * 8;
    const int t = t0 + r;
    const bool valid = t >= 0 && t < n;
    tc::cp_async16(dst + r * LD + col, base + static_cast<size_t>(valid ? t : 0) * stride + col, valid);
  }
}

// acc (16 x 8·NT) += A (16 rows of `a_rows`, DH deep) . B^T, B's rows (the
// n index) given by `b_row(n)`: S = qu . k^T and its kind
template <int DH, int NT, typename BRow>
__device__ __forceinline__ void mma_abt(float (&acc)[NT][4], const bf16* a_rows, BRow b_row, int lane) {
  constexpr int LD = DH + 8;
  const int mat = lane >> 3, mrow = lane & 7;
#pragma unroll
  for (int kc = 0; kc < DH / 16; ++kc) {
    unsigned a[4];
    tc::ldmatrix_x4(a, a_rows + ((mat & 1) * 8 + mrow) * LD + kc * 16 + (mat >> 1) * 8);
#pragma unroll
    for (int np = 0; np < NT / 2; ++np) {
      unsigned r[4];
      tc::ldmatrix_x4(r, b_row(np * 16 + (mat >> 1) * 8 + mrow) + kc * 16 + (mat & 1) * 8);
      tc::mma_bf16(acc[2 * np], a, r[0], r[1]);
      tc::mma_bf16(acc[2 * np + 1], a, r[2], r[3]);
    }
  }
}

// acc (16 x DH) += a (16 x 16, A fragment) . B, B's rows (the k index,
// 16 of them) given by `b_row(k)`, read through ldmatrix.trans
template <int DH, typename BRow>
__device__ __forceinline__ void mma_ab(float (&acc)[DH / 8][4], const unsigned (&a)[4], BRow b_row, int lane) {
  const int mat = lane >> 3, mrow = lane & 7;
#pragma unroll
  for (int dp = 0; dp < DH / 16; ++dp) {
    unsigned r[4];
    tc::ldmatrix_x4_trans(r, b_row((mat & 1) * 8 + mrow) + dp * 16 + (mat >> 1) * 8);
    tc::mma_bf16(acc[2 * dp], a, r[0], r[1]);
    tc::mma_bf16(acc[2 * dp + 1], a, r[2], r[3]);
  }
}

// the accumulator (16 x 8·NT) to the warp's float32 buffer, row-major
template <int NT>
__device__ __forceinline__ void store_acc(float* buf, const float (&acc)[NT][4], int g, int q) {
#pragma unroll
  for (int nt = 0; nt < NT; ++nt) {
    *reinterpret_cast<float2*>(buf + g * kWinLd + nt * 8 + 2 * q) = make_float2(acc[nt][0], acc[nt][1]);
    *reinterpret_cast<float2*>(buf + (g + 8) * kWinLd + nt * 8 + 2 * q) = make_float2(acc[nt][2], acc[nt][3]);
  }
}

// The scores of a warp's 16 query rows against a 64-key tile, started as the
// rel-pos term: BD = qv . band^T over the warp's 80 band rows (`band_row(c)`,
// 0 <= c < 80) goes through the warp's buffer and comes back skewed,
// s[i][j] = BD[i][j - i + 15].  The buffer is free again on return, after a
// __syncwarp.
template <int DH, typename BandRow>
__device__ __forceinline__ void skewed_band_scores(float (&s)[kKeys / 8][4], const bf16* qv_w, BandRow band_row,
                                                   float* wbuf, int lane) {
  const int g = lane >> 2, q = lane & 3;
  {
    float bd[kWin / 8][4] = {};
    mma_abt<DH>(bd, qv_w, band_row, lane);
    store_acc(wbuf, bd, g, q);
  }
  __syncwarp();
#pragma unroll
  for (int nt = 0; nt < kKeys / 8; ++nt) {
    const int c = nt * 8 + 2 * q + kShift;
    s[nt][0] = wbuf[g * kWinLd + c - g];
    s[nt][1] = wbuf[g * kWinLd + c + 1 - g];
    s[nt][2] = wbuf[(g + 8) * kWinLd + c - g - 8];
    s[nt][3] = wbuf[(g + 8) * kWinLd + c + 1 - g - 8];
  }
  __syncwarp();
}

// Opts `kernel` in to `smem` bytes of dynamic shared memory (past 48 KB)
// and to the largest shared-memory carveout, so that two blocks can share an
// SM.  Each instantiation calls it once and keeps the result.
template <typename Kernel>
cudaError_t opt_in(Kernel kernel, size_t smem) {
  const cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  return cudaFuncSetAttribute(kernel, cudaFuncAttributePreferredSharedMemoryCarveout, cudaSharedmemCarveoutMaxShared);
}

// What the card makes of `kernel` after its opt-in: the blocks an SM holds
// at once (the occupancy calculator), registers a thread, local memory a
// thread (non-zero: spills or a stack frame) and dynamic shared memory a block.
template <typename Kernel>
cudaError_t plan_of(Kernel kernel, size_t smem, int* blocks_per_sm, int* registers, int* local_bytes,
                    int* smem_bytes) {
  cudaFuncAttributes attr;
  const cudaError_t err = cudaFuncGetAttributes(&attr, kernel);
  if (err != cudaSuccess) return err;
  *registers = attr.numRegs;
  *local_bytes = static_cast<int>(attr.localSizeBytes);
  *smem_bytes = static_cast<int>(smem);
  return cudaOccupancyMaxActiveBlocksPerMultiprocessor(blocks_per_sm, kernel, kThreads, smem);
}

}  // namespace relpos_tc

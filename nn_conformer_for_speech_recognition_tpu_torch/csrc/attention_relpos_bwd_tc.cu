// Rel-pos attention backward, dq and dband kernels for bfloat16 inputs, on
// the H100's tensor cores (mma.sync m16n8k16, bf16 operands, float32 sums;
// not wgmma).
//
// Replace, for bfloat16, nn_conformer_for_speech_recognition_tpu/ops/pallas/
// attention.py:_flash_relpos_bwd_dq_kernel (:530) and
// _flash_relpos_bwd_dband_kernel (:590), with the tile recompute they share
// (_bwd_recompute).  Float32 inputs keep the CUDA-core kernels of
// attention_relpos_bwd.cu, which is also where the entry points and the dkv
// kernel live.  Per (query i, key j), as there:
//   s  = (qu_i . k_j + qv_i . p[j - i + T - 1]) * scale
//   P  = exp(s - lse_i), exactly 0 where j >= length[b]
//   ds = P * (dO_i . v_j - delta_i) * scale
//   dq:    dqu_i = sum_j ds k_j,    dqv_i = sum_j ds p[j - i + T - 1]
//   dband: dp[l] = sum_b sum_i ds[b][i][i + l - (T - 1)] qv[b][i]
// ds is formed in float32 and rounded once to bf16, the A operand of every
// product that follows; the sums stay float32 and are rounded once at the
// store (dband: float32 partials per batch row, summed in order by
// dband_reduce_kernel, so dp is the same bits from launch to launch).
//
// Both kernels: 4 warps of 16 rows, 128 threads.  Tiles are bf16 in shared
// memory with rows padded by 16 bytes (conflict-free ldmatrix), brought by
// 16-byte cp.async with zero-fill outside the tensors, one tile ahead of
// the products.  P is formed in base 2 (exp2 of s * scale * log2 e minus
// lse * log2 e).  The TPU kernels' lane-roll _skew and _unskew become an
// index into a per-warp float32 buffer (16 rows x 80, row stride 88 floats:
// the float2 stores are conflict-free, the shifted reads at most 2-way).
//
// bwd_dq_tc_kernel: query-major, 64 query rows a block, grid
// (ceil(T / 64), H, B).  qu, qv and dO of the block's rows are read once;
// key tiles of 64 are walked up to the row's length.  A tile's k and v come
// through a two-stage ring, its 127-row band of p (rows j0 - i0 - 63 + T - 1
// ...) as two 64-row chunks of a three-chunk ring (the next tile shares one
// chunk, so one new chunk a tile).  A warp's 16 rows meet 79 band rows: it
// forms BD = qv . band^T over those 80 rows, stores BD and reads it back
// skewed into the score accumulator (s[i][j] starts as BD[i][j - i + 15]),
// adds qu . k^T and forms dP = dO . v^T, then P and ds.  dqu += ds . k takes
// ds straight from the registers as the A operand (k through
// ldmatrix.trans); dqv += unskew(ds) . band writes ds skewed (bf16) into the
// same per-warp buffer (row i: column c holds ds[i][c + i - 15], zero
// outside the tile) and reads it back with ldmatrix as a 16 x 80 A operand
// against the band (ldmatrix.trans).
//
// bwd_dband_tc_kernel: diagonal-major, a block owns 64 table rows
// [l0, l0 + 64) of one head and one batch row, grid (ceil((2T - 1) / 64),
// H, B), and walks the query tiles in order, skipping those whose 127-key
// window j = i0 + l0 - (T - 1) ... lies wholly outside [0, length).  The
// windows of successive tiles overlap by 64 keys, so k and v come as 64-row
// chunks through a three-chunk ring, one new chunk a tile.  Per tile a warp
// takes 16 query rows: AC = qu . k_window^T and dPw = dO . v_window^T over
// its 80 keys, each stored and read back gathered into (i, l) coordinates
// (s[i][l] = AC[i][i + l]); BD = qv . p_block^T adds to the scores with no
// skew, the table rows being the block's own.  ds (bf16) goes to shared
// memory as (i, l); then warp w accumulates rows [16w, 16w + 16) of
// dband += ds^T . qv, ds and qv both through ldmatrix.trans.
//
// Bound on the H100 (chip_smoke.py): 10 * dh (dq) and 8 * dh (dband)
// operations per (query, valid key) pair and head at 989 TFLOP/s.  These
// kernels do more raw products than that count (BD over 80 band rows a
// warp, AC and dPw over 80-key windows, all of a tile's keys up to the
// length); the bound counts the work, not this implementation.
//
// Budget at dh = 64: dq 114,688 and dband 115,200 bytes of dynamic shared
// memory, so two blocks fit an SM (228 KB, 1 KB reserved a block); the
// registers (~150 a thread by design: two 16 x 64 float32 accumulators of
// dq, the 16 x 64 scores and dP, not the operand fragments, which are read
// from shared memory at each use) do not limit that.  The compiler's
// report (-Xptxas -v) and the occupancy and spill readings from
// attention_relpos_bwd_tc_plan are in PERF.md.

#include "attention_relpos.cuh"
#include "tensor_core.cuh"

namespace {

using bf16 = __nv_bfloat16;

constexpr int kRows = 64;             // query rows of a dq block and of a dband tile; table rows of a dband block
constexpr int kKeys = 64;             // keys of a dq tile; a ring chunk of band or key rows
constexpr int kThreadsTc = 128;       // 4 warps of 16 rows
constexpr int kWin = kKeys + 16;      // a warp's 16 rows meet 79 band rows (dq) or keys (dband): 80
constexpr int kWinLd = kWin + 8;      // float row stride of the per-warp buffer (88 = 24 mod 32)
constexpr int kDsWinLd = kWin + 8;    // bf16 row stride of dq's skewed ds in the same buffer (176 bytes)
constexpr int kDsLd = kRows + 8;      // bf16 row stride of dband's (i, l) ds tile (144 bytes)
constexpr int kShift = kWin - kKeys - 1;  // dq: s[i][j] meets window column j - i + 15
constexpr float kLog2e = 1.4426950408889634f;

template <int DH>
struct Tiles {
  static constexpr int LD = DH + 8;  // bf16 row stride: 16 bytes of padding
  static constexpr int DT = DH / 8;   // 8-wide tiles of an output row
  static constexpr int kTile = kRows * LD;
  // per-warp float32 buffers, then (dband) lse and delta of the query tile
  static constexpr size_t kWarpBytes = 4 * 16 * kWinLd * sizeof(float);
  // dq: qu, qv, dO | k, v two stages | band ring of 3 chunks | warp buffers
  static constexpr size_t kDqSmem = (3 + 4 + 3) * kTile * sizeof(bf16) + kWarpBytes;
  // dband: p block | qu, qv, dO | k, v ring of 3 chunks each | warp buffers | lse, delta
  static constexpr size_t kDbandSmem = (1 + 3 + 6) * kTile * sizeof(bf16) + kWarpBytes + 2 * kRows * sizeof(float);
};

// dst[r] = src[t0 + r] for the 64 rows r, zero where t0 + r lies outside
// [0, n); `base` points at row 0, rows `stride` elements apart.
template <int DH>
__device__ __forceinline__ void copy_rows(bf16* dst, const bf16* __restrict__ base, int t0, int n, size_t stride,
                                          int tid) {
  constexpr int LD = DH + 8, kChunks = DH / 8;
#pragma unroll
  for (int c = 0; c < kRows * kChunks / kThreadsTc; ++c) {
    const int idx = tid + c * kThreadsTc;
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

template <int DH>
__global__ void __launch_bounds__(kThreadsTc)
bwd_dq_tc_kernel(const bf16* __restrict__ qu, const bf16* __restrict__ qv, const bf16* __restrict__ k,
                 const bf16* __restrict__ v, const bf16* __restrict__ p, const int* __restrict__ lengths,
                 const bf16* __restrict__ dout, const float* __restrict__ lse, const float* __restrict__ delta,
                 bf16* __restrict__ dqu, bf16* __restrict__ dqv, int seq, int heads, float scale) {
  using G = Tiles<DH>;
  constexpr int LD = G::LD, DT = G::DT, NT = kKeys / 8;
  extern __shared__ __align__(16) unsigned char smem[];
  bf16* s_q = reinterpret_cast<bf16*>(smem);  // qu, qv, dO of the block's rows
  bf16* s_kv = s_q + 3 * G::kTile;            // [stage][k, v][kKeys][LD]
  bf16* s_band = s_kv + 4 * G::kTile;         // [chunk % 3][kKeys][LD]

  const int i0 = blockIdx.x * kRows, h = blockIdx.y, b = blockIdx.z;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, q = lane & 3;
  const int len = min(lengths[b], seq);
  const int tiles = len > 0 ? (len + kKeys - 1) / kKeys : 0;
  const int n_rel = 2 * seq - 1;
  const size_t stride = static_cast<size_t>(heads) * DH;
  const size_t base = static_cast<size_t>(b) * seq * stride + static_cast<size_t>(h) * DH;
  const bf16* p_h = p + static_cast<size_t>(h) * DH;
  // band chunk c holds table rows rel_base + 64 c ...; key tile n meets chunks n and n + 1
  const int rel_base = seq - 1 - i0 - (kRows - 1);
  float* wbuf = reinterpret_cast<float*>(s_band + 3 * G::kTile) + warp * 16 * kWinLd;
  bf16* dsk = reinterpret_cast<bf16*>(wbuf);  // [16][kDsWinLd], over the same bytes
  const bf16* qu_w = s_q + warp * 16 * LD;
  const bf16* qv_w = qu_w + G::kTile;
  const bf16* do_w = qv_w + G::kTile;
  const int win0 = kRows - 16 - 16 * warp;  // the warp's first band row of a tile's 128

  // this thread's rows of the accumulators: r0 and r0 + 8 of the warp's 16
  const int ia = i0 + warp * 16 + g, ib = ia + 8;
  const bool ok_a = ia < seq, ok_b = ib < seq;
  const size_t stat = (static_cast<size_t>(b) * heads + h) * seq;
  const float lse_a = ok_a ? lse[stat + ia] * kLog2e : 0.f, lse_b = ok_b ? lse[stat + ib] * kLog2e : 0.f;
  const float delta_a = ok_a ? delta[stat + ia] : 0.f, delta_b = ok_b ? delta[stat + ib] : 0.f;
  const float scale2 = scale * kLog2e;

  auto load_kv = [&](int tile) {
    bf16* dst = s_kv + (tile & 1) * 2 * G::kTile;
    copy_rows<DH>(dst, k + base, tile * kKeys, seq, stride, tid);
    copy_rows<DH>(dst + G::kTile, v + base, tile * kKeys, seq, stride, tid);
  };
  auto load_band = [&](int chunk) {
    copy_rows<DH>(s_band + (chunk % 3) * G::kTile, p_h, rel_base + chunk * kKeys, n_rel, stride, tid);
  };
  if (tiles > 0) {
    copy_rows<DH>(s_q, qu + base, i0, seq, stride, tid);
    copy_rows<DH>(s_q + G::kTile, qv + base, i0, seq, stride, tid);
    copy_rows<DH>(s_q + 2 * G::kTile, dout + base, i0, seq, stride, tid);
    load_kv(0);
    load_band(0);
    load_band(1);
  }
  tc::cp_async_commit();

  float acc_u[DT][4] = {}, acc_v[DT][4] = {};
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

    // BD = qv . band^T over the warp's 80 band rows, to the warp's buffer
    {
      float bd[kWin / 8][4] = {};
      mma_abt<DH>(bd, qv_w, band_row, lane);
      store_acc(wbuf, bd, g, q);
    }
    __syncwarp();
    // the scores start as BD skewed: s[i][j] = BD[i][j - i + 15], then += qu . k^T
    float s[NT][4];
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) {
      const int c = nt * 8 + 2 * q + kShift;
      s[nt][0] = wbuf[g * kWinLd + c - g];
      s[nt][1] = wbuf[g * kWinLd + c + 1 - g];
      s[nt][2] = wbuf[(g + 8) * kWinLd + c - g - 8];
      s[nt][3] = wbuf[(g + 8) * kWinLd + c + 1 - g - 8];
    }
    mma_abt<DH>(s, qu_w, [&](int r) { return ks + r * LD; }, lane);
    float dp[NT][4] = {};
    mma_abt<DH>(dp, do_w, [&](int r) { return vs + r * LD; }, lane);

    // P and ds in float32; s becomes ds
    const int j0 = n * kKeys;
#pragma unroll
    for (int nt = 0; nt < NT; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int j = j0 + nt * 8 + 2 * q + (e & 1);
        const bool hi = e >= 2;
        float x = 0.f;
        if ((hi ? ok_b : ok_a) && j < len) {
          const float prob = exp2f(s[nt][e] * scale2 - (hi ? lse_b : lse_a));
          x = prob * (dp[nt][e] - (hi ? delta_b : delta_a)) * scale;
        }
        s[nt][e] = x;
      }

    // dqu += ds . k: ds rounded to bf16 in registers as the A operand (score tiles 2c, 2c + 1)
    __syncwarp();  // every lane has read BD: its buffer takes the skewed ds next
#pragma unroll
    for (int c = 0; c < kKeys / 16; ++c) {
      const unsigned a[4] = {tc::pack_bf16(s[2 * c][0], s[2 * c][1]), tc::pack_bf16(s[2 * c][2], s[2 * c][3]),
                             tc::pack_bf16(s[2 * c + 1][0], s[2 * c + 1][1]),
                             tc::pack_bf16(s[2 * c + 1][2], s[2 * c + 1][3])};
      mma_ab<DH>(acc_u, a, [&](int r) { return ks + (c * 16 + r) * LD; }, lane);
    }
    // unskew: row i of the buffer holds ds[i][c + i - 15] at column c, zero where that key lies off the tile
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) {
      const int c = nt * 8 + 2 * q + kShift;
      dsk[g * kDsWinLd + c - g] = __float2bfloat16(s[nt][0]);
      dsk[g * kDsWinLd + c + 1 - g] = __float2bfloat16(s[nt][1]);
      dsk[(g + 8) * kDsWinLd + c - g - 8] = __float2bfloat16(s[nt][2]);
      dsk[(g + 8) * kDsWinLd + c + 1 - g - 8] = __float2bfloat16(s[nt][3]);
    }
    {
      const int row = lane >> 1, lead = kShift - row;  // row's zeros: columns [0, lead) and [lead + 64, 80)
#pragma unroll
      for (int z = 0; z < 8; ++z) {
        const int c = (lane & 1) * 8 + z;
        dsk[row * kDsWinLd + (c < lead ? c : c + kKeys)] = __float2bfloat16(0.f);
      }
    }
    __syncwarp();
    // dqv += unskew(ds) (16 x 80) . band (80 x DH)
    {
      const int mat = lane >> 3, mrow = lane & 7;
#pragma unroll
      for (int kc = 0; kc < kWin / 16; ++kc) {
        unsigned a[4];
        tc::ldmatrix_x4(a, dsk + ((mat & 1) * 8 + mrow) * kDsWinLd + kc * 16 + (mat >> 1) * 8);
        mma_ab<DH>(acc_v, a, [&](int r) { return band_row(kc * 16 + r); }, lane);
      }
    }
    __syncthreads();  // this tile's stages are read before the next copies into them
  }

  auto store = [&](bf16* out, const float (&acc)[DT][4]) {
    if (ok_a) {
      unsigned* o = reinterpret_cast<unsigned*>(out + base + static_cast<size_t>(ia) * stride);
#pragma unroll
      for (int dt = 0; dt < DT; ++dt) o[dt * 4 + q] = tc::pack_bf16(acc[dt][0], acc[dt][1]);
    }
    if (ok_b) {
      unsigned* o = reinterpret_cast<unsigned*>(out + base + static_cast<size_t>(ib) * stride);
#pragma unroll
      for (int dt = 0; dt < DT; ++dt) o[dt * 4 + q] = tc::pack_bf16(acc[dt][2], acc[dt][3]);
    }
  };
  store(dqu, acc_u);
  store(dqv, acc_v);
}

template <int DH>
__global__ void __launch_bounds__(kThreadsTc)
bwd_dband_tc_kernel(const bf16* __restrict__ qu, const bf16* __restrict__ qv, const bf16* __restrict__ k,
                    const bf16* __restrict__ v, const bf16* __restrict__ p, const int* __restrict__ lengths,
                    const bf16* __restrict__ dout, const float* __restrict__ lse,
                    const float* __restrict__ delta, float* __restrict__ partial, int seq, int heads,
                    float scale) {
  using G = Tiles<DH>;
  constexpr int LD = G::LD, DT = G::DT, NT = kRows / 8;
  extern __shared__ __align__(16) unsigned char smem[];
  bf16* s_p = reinterpret_cast<bf16*>(smem);  // the block's 64 table rows
  bf16* s_q = s_p + G::kTile;                 // qu, qv, dO of the query tile
  bf16* s_kv = s_q + 3 * G::kTile;            // [chunk % 3][k, v][kKeys][LD]
  float* s_warp = reinterpret_cast<float*>(s_kv + 6 * G::kTile);
  bf16* s_ds = reinterpret_cast<bf16*>(s_warp);  // [kRows (i)][kDsLd (l)], over the warp buffers
  float* s_stat = s_warp + 4 * 16 * kWinLd;     // lse (already times log2 e on use), delta

  const int l0 = blockIdx.x * kRows, h = blockIdx.y, b = blockIdx.z;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, q = lane & 3;
  const int len = min(lengths[b], seq);
  const int n_rel = 2 * seq - 1;
  const size_t stride = static_cast<size_t>(heads) * DH;
  const size_t base = static_cast<size_t>(b) * seq * stride + static_cast<size_t>(h) * DH;
  const size_t stat = (static_cast<size_t>(b) * heads + h) * seq;
  // query tile n meets keys key0 + 64 n + [0, 127): key chunk c is keys key0 + 64 c ..., tile n takes chunks n, n + 1
  const int key0 = l0 - (seq - 1);
  const int lead = -(key0 + 2 * kRows - 2);  // tiles before the first whose window reaches key 0
  const int n_first = lead > 0 ? (lead + kRows - 1) / kRows : 0;
  const int room = len - 1 - key0;  // the window of tile n starts below len while 64 n <= room
  const int n_last = (len <= 0 || room < 0) ? -1 : min(room / kRows, (seq - 1) / kRows);
  float* wbuf = s_warp + warp * 16 * kWinLd;
  const int rw = warp * 16;  // the warp's first query row of a tile, and first table row of the block

  auto load_chunk = [&](int c) {
    bf16* dst = s_kv + (c % 3) * 2 * G::kTile;
    copy_rows<DH>(dst, k + base, key0 + c * kKeys, seq, stride, tid);
    copy_rows<DH>(dst + G::kTile, v + base, key0 + c * kKeys, seq, stride, tid);
  };
  auto load_stats = [&](int n) {  // thread t < 64: lse of row t, else delta of row t - 64
    const int r = tid & (kRows - 1), i = n * kRows + r;
    const bool valid = i < seq;
    tc::cp_async4(s_stat + tid, (tid < kRows ? lse : delta) + stat + (valid ? i : 0), valid);
  };
  if (n_first <= n_last) {
    copy_rows<DH>(s_p, p + static_cast<size_t>(h) * DH, l0, n_rel, stride, tid);
    load_chunk(n_first);
    load_chunk(n_first + 1);
    copy_rows<DH>(s_q, qu + base, n_first * kRows, seq, stride, tid);
    copy_rows<DH>(s_q + G::kTile, qv + base, n_first * kRows, seq, stride, tid);
    copy_rows<DH>(s_q + 2 * G::kTile, dout + base, n_first * kRows, seq, stride, tid);
    load_stats(n_first);
  }
  tc::cp_async_commit();

  const float scale2 = scale * kLog2e;
  float acc[DT][4] = {};
  for (int n = n_first; n <= n_last; ++n) {
    if (n < n_last) load_chunk(n + 2);
    tc::cp_async_commit();
    tc::cp_async_wait_one();  // this tile's q rows, stats and both chunks have landed
    __syncthreads();
    const bf16* chunk0 = s_kv + (n % 3) * 2 * G::kTile;
    const bf16* chunk1 = s_kv + ((n + 1) % 3) * 2 * G::kTile;
    // window row w (0 <= w < 128) of k (kind 0) or v (kind 1)
    auto window_row = [&](int kind, int w) {
      return (w < kKeys ? chunk0 : chunk1) + kind * G::kTile + (w & (kKeys - 1)) * LD;
    };

    // AC = qu . k^T over the warp's 80 keys (window rows rw ...), gathered: s[i][l] = AC[i][i + l]
    float s[NT][4], dpv[NT][4];
    {
      float w[kWin / 8][4] = {};
      mma_abt<DH>(w, s_q + rw * LD, [&](int r) { return window_row(0, rw + r); }, lane);
      store_acc(wbuf, w, g, q);
    }
    __syncwarp();
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) {
      const int c = nt * 8 + 2 * q;
      s[nt][0] = wbuf[g * kWinLd + c + g];
      s[nt][1] = wbuf[g * kWinLd + c + 1 + g];
      s[nt][2] = wbuf[(g + 8) * kWinLd + c + g + 8];
      s[nt][3] = wbuf[(g + 8) * kWinLd + c + 1 + g + 8];
    }
    __syncwarp();
    // dPw = dO . v^T over the same keys, gathered the same way
    {
      float w[kWin / 8][4] = {};
      mma_abt<DH>(w, s_q + 2 * G::kTile + rw * LD, [&](int r) { return window_row(1, rw + r); }, lane);
      store_acc(wbuf, w, g, q);
    }
    __syncwarp();
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) {
      const int c = nt * 8 + 2 * q;
      dpv[nt][0] = wbuf[g * kWinLd + c + g];
      dpv[nt][1] = wbuf[g * kWinLd + c + 1 + g];
      dpv[nt][2] = wbuf[(g + 8) * kWinLd + c + g + 8];
      dpv[nt][3] = wbuf[(g + 8) * kWinLd + c + 1 + g + 8];
    }
    // BD = qv . p_block^T: the table rows are the block's, no skew
    mma_abt<DH>(s, s_q + G::kTile + rw * LD, [&](int r) { return s_p + r * LD; }, lane);

    // P and ds in float32; s becomes ds
    const int ra = rw + g, rb = ra + 8;  // tile rows
    const int i_a = n * kRows + ra, i_b = i_a + 8;
    const float lse_a = s_stat[ra] * kLog2e, lse_b = s_stat[rb] * kLog2e;
    const float delta_a = s_stat[kRows + ra], delta_b = s_stat[kRows + rb];
#pragma unroll
    for (int nt = 0; nt < NT; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const bool hi = e >= 2;
        const int j = key0 + n * kKeys + (hi ? rb : ra) + nt * 8 + 2 * q + (e & 1);
        float x = 0.f;
        if ((hi ? i_b : i_a) < seq && j >= 0 && j < len) {
          const float prob = exp2f(s[nt][e] * scale2 - (hi ? lse_b : lse_a));
          x = prob * (dpv[nt][e] - (hi ? delta_b : delta_a)) * scale;
        }
        s[nt][e] = x;
      }
    __syncthreads();  // every warp has read its buffer, qu, dO and the stats
    if (n < n_last) {
      copy_rows<DH>(s_q, qu + base, (n + 1) * kRows, seq, stride, tid);
      copy_rows<DH>(s_q + 2 * G::kTile, dout + base, (n + 1) * kRows, seq, stride, tid);
      load_stats(n + 1);
    }
    // ds (bf16) to shared memory as (i, l)
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) {
      const int c = nt * 8 + 2 * q;
      *reinterpret_cast<unsigned*>(s_ds + ra * kDsLd + c) = tc::pack_bf16(s[nt][0], s[nt][1]);
      *reinterpret_cast<unsigned*>(s_ds + rb * kDsLd + c) = tc::pack_bf16(s[nt][2], s[nt][3]);
    }
    __syncthreads();
    // dband rows [rw, rw + 16) += ds^T (16 l x 64 i) . qv (64 i x DH)
    {
      const int mat = lane >> 3, mrow = lane & 7;
      const bf16* qv_t = s_q + G::kTile;
#pragma unroll
      for (int kc = 0; kc < kRows / 16; ++kc) {
        unsigned a[4];
        tc::ldmatrix_x4_trans(a, s_ds + (kc * 16 + (mat >> 1) * 8 + mrow) * kDsLd + rw + (mat & 1) * 8);
        mma_ab<DH>(acc, a, [&](int r) { return qv_t + (kc * 16 + r) * LD; }, lane);
      }
    }
    __syncthreads();  // qv and ds are read before the next copies and buffers
    if (n < n_last) copy_rows<DH>(s_q + G::kTile, qv + base, (n + 1) * kRows, seq, stride, tid);
    tc::cp_async_commit();
  }

  const int la = l0 + rw + g, lb = la + 8;
  if (la < n_rel) {
    float* o = partial + ((static_cast<size_t>(b) * n_rel + la) * heads + h) * DH + 2 * q;
#pragma unroll
    for (int dt = 0; dt < DT; ++dt) *reinterpret_cast<float2*>(o + dt * 8) = make_float2(acc[dt][0], acc[dt][1]);
  }
  if (lb < n_rel) {
    float* o = partial + ((static_cast<size_t>(b) * n_rel + lb) * heads + h) * DH + 2 * q;
#pragma unroll
    for (int dt = 0; dt < DT; ++dt) *reinterpret_cast<float2*>(o + dt * 8) = make_float2(acc[dt][2], acc[dt][3]);
  }
}

enum TcKind { kTcDq = 0, kTcDband = 1 };

template <int KIND, int DH>
auto tc_kernel() {
  if constexpr (KIND == kTcDq) {
    return bwd_dq_tc_kernel<DH>;
  } else {
    return bwd_dband_tc_kernel<DH>;
  }
}

template <int KIND, int DH>
constexpr size_t tc_smem() {
  return KIND == kTcDq ? Tiles<DH>::kDqSmem : Tiles<DH>::kDbandSmem;
}

// Opts the kernel in to its shared memory (past 48 KB) and to the largest
// shared-memory carveout, so that two blocks can share an SM; once.
template <int KIND, int DH>
cudaError_t configure() {
  static cudaError_t status = [] {
    auto kernel = tc_kernel<KIND, DH>();
    cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                           static_cast<int>(tc_smem<KIND, DH>()));
    if (err != cudaSuccess) return err;
    return cudaFuncSetAttribute(kernel, cudaFuncAttributePreferredSharedMemoryCarveout,
                                cudaSharedmemCarveoutMaxShared);
  }();
  return status;
}

template <int KIND, int DH>
cudaError_t launch_tc(const relpos::BwdArgs& a) {
  const cudaError_t err = configure<KIND, DH>();
  if (err != cudaSuccess) return err;
  const bf16* qu = static_cast<const bf16*>(a.qu);
  const bf16* qv = static_cast<const bf16*>(a.qv);
  const bf16* k = static_cast<const bf16*>(a.k);
  const bf16* v = static_cast<const bf16*>(a.v);
  const bf16* p = static_cast<const bf16*>(a.p);
  const bf16* g = static_cast<const bf16*>(a.g);
  constexpr size_t smem = tc_smem<KIND, DH>();
  if constexpr (KIND == kTcDq) {
    const dim3 grid((a.seq + kRows - 1) / kRows, a.heads, a.batch);
    bwd_dq_tc_kernel<DH><<<grid, kThreadsTc, smem, a.stream>>>(
        qu, qv, k, v, p, a.lengths, g, a.lse, a.delta, static_cast<bf16*>(a.out0), static_cast<bf16*>(a.out1),
        a.seq, a.heads, a.scale);
    return cudaGetLastError();
  } else {
    const int n_rel = 2 * a.seq - 1;
    float* partial = static_cast<float*>(a.out1);
    const dim3 grid((n_rel + kRows - 1) / kRows, a.heads, a.batch);
    bwd_dband_tc_kernel<DH><<<grid, kThreadsTc, smem, a.stream>>>(
        qu, qv, k, v, p, a.lengths, g, a.lse, a.delta, partial, a.seq, a.heads, a.scale);
    const cudaError_t launched = cudaGetLastError();
    if (launched != cudaSuccess) return launched;
    return relpos::launch_dband_reduce<bf16>(partial, static_cast<bf16*>(a.out0), a.batch,
                                             static_cast<size_t>(n_rel) * a.heads * DH, a.stream);
  }
}

template <int KIND>
cudaError_t dispatch_tc(int head_dim, const relpos::BwdArgs& a) {
  switch (head_dim) {
    case 16: return launch_tc<KIND, 16>(a);
    case 32: return launch_tc<KIND, 32>(a);
    case 64: return launch_tc<KIND, 64>(a);
    case 128: return launch_tc<KIND, 128>(a);
    default: return cudaErrorInvalidValue;
  }
}

template <int KIND, int DH>
cudaError_t plan(int* blocks_per_sm, int* registers, int* local_bytes, int* smem_bytes) {
  cudaError_t err = configure<KIND, DH>();
  if (err != cudaSuccess) return err;
  auto kernel = tc_kernel<KIND, DH>();
  cudaFuncAttributes attr;
  err = cudaFuncGetAttributes(&attr, kernel);
  if (err != cudaSuccess) return err;
  *registers = attr.numRegs;
  *local_bytes = static_cast<int>(attr.localSizeBytes);
  *smem_bytes = static_cast<int>(tc_smem<KIND, DH>());
  return cudaOccupancyMaxActiveBlocksPerMultiprocessor(blocks_per_sm, kernel, kThreadsTc, tc_smem<KIND, DH>());
}

}  // namespace

namespace relpos {

cudaError_t bwd_dq_tc(int head_dim, const BwdArgs& a) { return dispatch_tc<kTcDq>(head_dim, a); }
cudaError_t bwd_dband_tc(int head_dim, const BwdArgs& a) { return dispatch_tc<kTcDband>(head_dim, a); }

}  // namespace relpos

// kind 0: dq, 1: dband.  Host only: the blocks an SM holds at once (the
// occupancy calculator, after the kernel's shared-memory opt-in), registers
// a thread, local memory a thread (non-zero: spills or a stack frame) and
// dynamic shared memory a block.
extern "C" int attention_relpos_bwd_tc_plan(int kind, int head_dim, int* blocks_per_sm, int* registers,
                                            int* local_bytes, int* smem_bytes) {
  const bool dq = kind == kTcDq;
  switch (head_dim) {
    case 16: return dq ? plan<kTcDq, 16>(blocks_per_sm, registers, local_bytes, smem_bytes)
                       : plan<kTcDband, 16>(blocks_per_sm, registers, local_bytes, smem_bytes);
    case 32: return dq ? plan<kTcDq, 32>(blocks_per_sm, registers, local_bytes, smem_bytes)
                       : plan<kTcDband, 32>(blocks_per_sm, registers, local_bytes, smem_bytes);
    case 64: return dq ? plan<kTcDq, 64>(blocks_per_sm, registers, local_bytes, smem_bytes)
                       : plan<kTcDband, 64>(blocks_per_sm, registers, local_bytes, smem_bytes);
    case 128: return dq ? plan<kTcDq, 128>(blocks_per_sm, registers, local_bytes, smem_bytes)
                        : plan<kTcDband, 128>(blocks_per_sm, registers, local_bytes, smem_bytes);
    default: return cudaErrorInvalidValue;
  }
}

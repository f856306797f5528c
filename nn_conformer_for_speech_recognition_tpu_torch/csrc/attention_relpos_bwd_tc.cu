// Rel-pos attention backward, dq, dkv and dband kernels for bfloat16
// inputs, on the H100's tensor cores (mma.sync m16n8k16, bf16 operands,
// float32 sums; not wgmma).
//
// Replace, for bfloat16, nn_conformer_for_speech_recognition_tpu/ops/pallas/
// attention.py:_flash_relpos_bwd_dq_kernel (:530),
// _flash_relpos_bwd_dkv_kernel (:559) and _flash_relpos_bwd_dband_kernel
// (:590), with the tile recompute they share (_bwd_recompute).  Float32
// inputs keep the CUDA-core kernels of attention_relpos_bwd.cu, which is
// also where the entry points live.  Per (query i, key j), as there:
//   s  = (qu_i . k_j + qv_i . p[j - i + T - 1]) * scale
//   P  = exp(s - lse_i), exactly 0 where j >= length[b] (and for query rows
//        past T, which the tiles hold as zeros)
//   ds = P * (dO_i . v_j - delta_i) * scale
//   dq:    dqu_i = sum_j ds k_j,    dqv_i = sum_j ds p[j - i + T - 1]
//   dkv:   dk_j  = sum_i ds qu_i,   dv_j  = sum_i P dO_i
//   dband: dp[l] = sum_b sum_i ds[b][i][i + l - (T - 1)] qv[b][i]
// P and ds are formed in float32 and rounded once to bf16, the A operand of
// every product that follows; the sums stay float32 and are rounded once at
// the store (dband: float32 partials per batch row, summed in order by
// dband_reduce_kernel, so dp is the same bits from launch to launch).
//
// Every kernel: 4 warps of 16 rows, 128 threads, the tiles and products of
// attention_relpos_tc.cuh, tiles brought by 16-byte cp.async with zero-fill
// outside the tensors, one tile ahead of the products.  P is formed in base
// 2 (exp2 of s * scale * log2 e minus lse * log2 e).  The TPU kernels'
// lane-roll _skew and _unskew become an index into the per-warp float32
// buffer.
//
// bwd_dq_tc_kernel: query-major, 64 query rows a block, grid
// (ceil(T / 64), H, B).  qu, qv and dO of the block's rows are read once;
// key tiles of 64 are walked up to the row's length.  A tile's k and v come
// through a two-stage ring, its 127-row band of p (rows j0 - i0 - 63 + T - 1
// ...) as two 64-row chunks of a three-chunk ring (the next tile shares one
// chunk, so one new chunk a tile).  A warp's 16 rows meet 79 band rows: it
// forms BD = qv . band^T over those 80 rows and reads it back skewed into
// the score accumulator (relpos_tc::skewed_band_scores), adds qu . k^T and
// forms dP = dO . v^T, then P and ds.  dqu += ds . k takes ds straight from
// the registers as the A operand (k through ldmatrix.trans); dqv +=
// unskew(ds) . band writes ds skewed (bf16) into the same per-warp buffer
// (row i: column c holds ds[i][c + i - 15], zero outside the tile) and
// reads it back with ldmatrix as a 16 x 80 A operand against the band
// (ldmatrix.trans).
//
// bwd_dkv_tc_kernel: key-major, a block owns 64 key rows [j0, j0 + 64) of
// one head and one batch row, grid (ceil(T / 64), H, B); a block at or past
// the length writes zeros.  It keeps its k and v in shared memory and walks
// every query tile in order.  Per tile each warp recomputes 16 query rows
// against the block's keys exactly as bwd_dq_tc_kernel does (BD skewed, +
// qu . k^T, dP = dO . v^T, then P and ds) and writes P and ds (bf16) as
// (i, j) rows into its own buffer, over the skew it has read; after a block
// barrier warp w accumulates key rows [16w, 16w + 16) of dv += P^T . dO and
// dk += ds^T . qu over the tile's 64 query rows, P^T and ds^T through
// ldmatrix.trans from the four warps' rows, dO and qu through
// ldmatrix.trans as B.  Successive query tiles' 127-row band windows overlap
// by 64 rows (walking down the table), so the band comes through a
// three-chunk ring, one new chunk a tile; qu and dO, which live to the end
// of a tile, through a two-stage ring; qv, read only by the scores, through
// one stage whose next copy is issued where it goes dead.
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
// Bound on the H100 (chip_smoke.py): 10 * dh (dq, dkv) and 8 * dh (dband)
// operations per (query, valid key) pair and head at 989 TFLOP/s.  These
// kernels do more raw products than that count (BD over 80 band rows a
// warp, AC and dPw over 80-key windows, all of a tile's keys up to the
// length; dkv all of a key tile's 64 keys and every query tile); the bound
// counts the work, not this implementation.
//
// Budget at dh = 64: dq and dkv 114,688 and dband 115,200 bytes of dynamic
// shared memory, so two blocks fit an SM (228 KB, 1 KB reserved a block);
// the registers (~150-200 a thread by design: two 16 x 64 float32
// accumulators of dq and dkv, the 16 x 64 scores and dP, not the operand
// fragments, which are read from shared memory at each use) do not limit
// that.  The compiler's report (-Xptxas -v) and the occupancy and spill
// readings from attention_relpos_bwd_tc_plan are in PERF.md.

#include "attention_relpos.cuh"
#include "attention_relpos_tc.cuh"

namespace {

using namespace relpos_tc;

constexpr int kDsWinLd = kWin + 8;  // bf16 row stride of dq's skewed ds in the warp's buffer (176 bytes)
constexpr int kDsLd = kRows + 8;    // bf16 row stride of dband's (i, l) ds tile and of dkv's P and ds rows (144 bytes)

// dynamic shared memory of each kernel, by head width
template <int DH>
struct Smem {
  using G = Tiles<DH>;
  // dq: qu, qv, dO | k, v two stages | band ring of 3 chunks | warp buffers
  static constexpr size_t kDq = (3 + 4 + 3) * G::kTileBytes + G::kWarpBytes;
  // dkv: k, v | qu, dO two stages | qv | band ring of 3 chunks | warp buffers (BD, then the warp's P and ds rows)
  static constexpr size_t kDkv = (2 + 4 + 1 + 3) * G::kTileBytes + G::kWarpBytes;
  // dband: p block | qu, qv, dO | k, v ring of 3 chunks each | warp buffers | lse, delta
  static constexpr size_t kDband = (1 + 3 + 6) * G::kTileBytes + G::kWarpBytes + 2 * kRows * sizeof(float);
};

template <int DH>
__global__ void __launch_bounds__(kThreads)
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

    // the scores start as BD skewed (s[i][j] = BD[i][j - i + 15]), then += qu . k^T
    float s[NT][4];
    skewed_band_scores<DH>(s, qv_w, band_row, wbuf, lane);
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
__global__ void __launch_bounds__(kThreads)
bwd_dkv_tc_kernel(const bf16* __restrict__ qu, const bf16* __restrict__ qv, const bf16* __restrict__ k,
                  const bf16* __restrict__ v, const bf16* __restrict__ p, const int* __restrict__ lengths,
                  const bf16* __restrict__ dout, const float* __restrict__ lse, const float* __restrict__ delta,
                  bf16* __restrict__ dk, bf16* __restrict__ dv, int seq, int heads, float scale) {
  using G = Tiles<DH>;
  constexpr int LD = G::LD, DT = G::DT, NT = kKeys / 8;
  extern __shared__ __align__(16) unsigned char smem[];
  bf16* s_k = reinterpret_cast<bf16*>(smem);  // the block's 64 keys: k, then v
  bf16* s_v = s_k + G::kTile;
  bf16* s_qd = s_v + G::kTile;         // [stage][qu, dO][kRows][LD]
  bf16* s_qv = s_qd + 4 * G::kTile;    // qv of the query tile
  bf16* s_band = s_qv + G::kTile;      // [chunk % 3][kKeys][LD]
  float* s_warp = reinterpret_cast<float*>(s_band + 3 * G::kTile);

  const int j0 = blockIdx.x * kKeys, h = blockIdx.y, b = blockIdx.z;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, q = lane & 3;
  const int len = min(lengths[b], seq);
  // keys at or past the length have P = ds = 0 for every query: such a block writes zeros
  const int tiles = j0 < len ? (seq + kRows - 1) / kRows : 0;
  const int n_rel = 2 * seq - 1;
  const size_t stride = static_cast<size_t>(heads) * DH;
  const size_t base = static_cast<size_t>(b) * seq * stride + static_cast<size_t>(h) * DH;
  const size_t stat = (static_cast<size_t>(b) * heads + h) * seq;
  const bf16* p_h = p + static_cast<size_t>(h) * DH;
  // query tile n meets table rows T - 1 + j0 - 63 - 64 n ... (127 of them): chunk c holds rows
  // T + j0 - 64 c ..., and tile n takes chunks n + 1 (its window's rows 0-63) and n (rows 64-127)
  const int chunk_top = seq + j0;
  float* wbuf = s_warp + warp * 16 * kWinLd;
  // over the same bytes once the scores are read: the warp's 16 rows of P and of ds, (i, j), bf16
  bf16* p_w = reinterpret_cast<bf16*>(wbuf);
  bf16* ds_w = p_w + 16 * kDsLd;
  const int win0 = kRows - 16 - 16 * warp;  // the warp's first band row of a tile's 128

  auto load_qd = [&](int n) {  // qu and dO of query tile n
    bf16* dst = s_qd + (n & 1) * 2 * G::kTile;
    copy_rows<DH>(dst, qu + base, n * kRows, seq, stride, tid);
    copy_rows<DH>(dst + G::kTile, dout + base, n * kRows, seq, stride, tid);
  };
  auto load_band = [&](int chunk) {
    copy_rows<DH>(s_band + (chunk % 3) * G::kTile, p_h, chunk_top - chunk * kKeys, n_rel, stride, tid);
  };
  if (tiles > 0) {
    copy_rows<DH>(s_k, k + base, j0, seq, stride, tid);
    copy_rows<DH>(s_v, v + base, j0, seq, stride, tid);
    load_qd(0);
    copy_rows<DH>(s_qv, qv + base, 0, seq, stride, tid);
    load_band(0);
    load_band(1);
  }
  tc::cp_async_commit();

  const float scale2 = scale * kLog2e;
  float acc_k[DT][4] = {}, acc_v[DT][4] = {};
  for (int n = 0; n < tiles; ++n) {
    if (n + 1 < tiles) {
      load_qd(n + 1);
      load_band(n + 2);
    }
    tc::cp_async_commit();  // an empty group on the last tile keeps the count
    // this thread's query rows of the tile, and their statistics (read now, used after the products)
    const int ia = n * kRows + warp * 16 + g, ib = ia + 8;
    const bool ok_a = ia < seq, ok_b = ib < seq;
    const float lse_a = ok_a ? lse[stat + ia] * kLog2e : 0.f, lse_b = ok_b ? lse[stat + ib] * kLog2e : 0.f;
    const float delta_a = ok_a ? delta[stat + ia] : 0.f, delta_b = ok_b ? delta[stat + ib] : 0.f;
    tc::cp_async_wait_one();
    __syncthreads();  // tile n's qu, dO, qv and band, from every thread, have landed
    const bf16* qu_s = s_qd + (n & 1) * 2 * G::kTile;
    const bf16* do_s = qu_s + G::kTile;
    const bf16* chunk_lo = s_band + ((n + 1) % 3) * G::kTile;
    const bf16* chunk_hi = s_band + (n % 3) * G::kTile;
    // the warp's band row c (0 <= c < 80): window row win0 + c
    auto band_row = [&](int c) {
      const int r = win0 + c;
      return (r < kKeys ? chunk_lo : chunk_hi) + (r & (kKeys - 1)) * LD;
    };

    // the warp's 16 query rows against the block's keys, as bwd_dq_tc_kernel forms them:
    // S = skew(qv . band^T) + qu . k^T, dP = dO . v^T
    float s[NT][4];
    skewed_band_scores<DH>(s, s_qv + warp * 16 * LD, band_row, wbuf, lane);
    mma_abt<DH>(s, qu_s + warp * 16 * LD, [&](int r) { return s_k + r * LD; }, lane);
    float dp[NT][4] = {};
    mma_abt<DH>(dp, do_s + warp * 16 * LD, [&](int r) { return s_v + r * LD; }, lane);

    // P and ds in float32, each rounded once to bf16 into the warp's rows (the buffer is free: the skew is read)
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) {
      float prob[4], ds[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int j = j0 + nt * 8 + 2 * q + (e & 1);
        const bool hi = e >= 2;
        prob[e] = 0.f;
        if ((hi ? ok_b : ok_a) && j < len) prob[e] = exp2f(s[nt][e] * scale2 - (hi ? lse_b : lse_a));
        ds[e] = prob[e] * (dp[nt][e] - (hi ? delta_b : delta_a)) * scale;
      }
      const int c = nt * 8 + 2 * q;
      *reinterpret_cast<unsigned*>(p_w + g * kDsLd + c) = tc::pack_bf16(prob[0], prob[1]);
      *reinterpret_cast<unsigned*>(p_w + (g + 8) * kDsLd + c) = tc::pack_bf16(prob[2], prob[3]);
      *reinterpret_cast<unsigned*>(ds_w + g * kDsLd + c) = tc::pack_bf16(ds[0], ds[1]);
      *reinterpret_cast<unsigned*>(ds_w + (g + 8) * kDsLd + c) = tc::pack_bf16(ds[2], ds[3]);
    }
    __syncthreads();  // every warp's P and ds rows are in; qv is read
    if (n + 1 < tiles) copy_rows<DH>(s_qv, qv + base, (n + 1) * kRows, seq, stride, tid);
    tc::cp_async_commit();

    // key rows [16 warp, 16 warp + 16): dv += P^T . dO and dk += ds^T . qu over the tile's 64 query
    // rows, P^T and ds^T through ldmatrix.trans from the (i, j) rows (query row i in warp i / 16's buffer)
    {
      const int mat = lane >> 3, mrow = lane & 7;
#pragma unroll
      for (int kc = 0; kc < kRows / 16; ++kc) {
        const bf16* rows = reinterpret_cast<const bf16*>(s_warp + kc * 16 * kWinLd);
        const bf16* at = rows + ((mat >> 1) * 8 + mrow) * kDsLd + warp * 16 + (mat & 1) * 8;
        unsigned a[4];
        tc::ldmatrix_x4_trans(a, at);
        mma_ab<DH>(acc_v, a, [&](int r) { return do_s + (kc * 16 + r) * LD; }, lane);
        tc::ldmatrix_x4_trans(a, at + 16 * kDsLd);
        mma_ab<DH>(acc_k, a, [&](int r) { return qu_s + (kc * 16 + r) * LD; }, lane);
      }
    }
    __syncthreads();  // P, ds, qu and dO of this tile are read before the buffers and the stage take the next
  }

  auto store = [&](bf16* out, const float (&acc)[DT][4]) {
    const int ja = j0 + warp * 16 + g, jb = ja + 8;
    if (ja < seq) {
      unsigned* o = reinterpret_cast<unsigned*>(out + base + static_cast<size_t>(ja) * stride);
#pragma unroll
      for (int dt = 0; dt < DT; ++dt) o[dt * 4 + q] = tc::pack_bf16(acc[dt][0], acc[dt][1]);
    }
    if (jb < seq) {
      unsigned* o = reinterpret_cast<unsigned*>(out + base + static_cast<size_t>(jb) * stride);
#pragma unroll
      for (int dt = 0; dt < DT; ++dt) o[dt * 4 + q] = tc::pack_bf16(acc[dt][2], acc[dt][3]);
    }
  };
  store(dk, acc_k);
  store(dv, acc_v);
}

template <int DH>
__global__ void __launch_bounds__(kThreads)
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

enum TcKind { kTcDq = 0, kTcDband = 1, kTcDkv = 2 };

template <int KIND, int DH>
auto tc_kernel() {
  if constexpr (KIND == kTcDq) {
    return bwd_dq_tc_kernel<DH>;
  } else if constexpr (KIND == kTcDkv) {
    return bwd_dkv_tc_kernel<DH>;
  } else {
    return bwd_dband_tc_kernel<DH>;
  }
}

template <int KIND, int DH>
constexpr size_t tc_smem() {
  return KIND == kTcDq ? Smem<DH>::kDq : KIND == kTcDkv ? Smem<DH>::kDkv : Smem<DH>::kDband;
}

// the kernel's shared-memory opt-in, once
template <int KIND, int DH>
cudaError_t configure() {
  static const cudaError_t status = opt_in(tc_kernel<KIND, DH>(), tc_smem<KIND, DH>());
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
  if constexpr (KIND == kTcDband) {
    const int n_rel = 2 * a.seq - 1;
    float* partial = static_cast<float*>(a.out1);
    const dim3 grid((n_rel + kRows - 1) / kRows, a.heads, a.batch);
    bwd_dband_tc_kernel<DH><<<grid, kThreads, smem, a.stream>>>(
        qu, qv, k, v, p, a.lengths, g, a.lse, a.delta, partial, a.seq, a.heads, a.scale);
    const cudaError_t launched = cudaGetLastError();
    if (launched != cudaSuccess) return launched;
    return relpos::launch_dband_reduce<bf16>(partial, static_cast<bf16*>(a.out0), a.batch,
                                             static_cast<size_t>(n_rel) * a.heads * DH, a.stream);
  } else {  // dq: a block a 64-row query tile; dkv: a block a 64-row key tile
    const dim3 grid((a.seq + kRows - 1) / kRows, a.heads, a.batch);
    auto kernel = tc_kernel<KIND, DH>();
    kernel<<<grid, kThreads, smem, a.stream>>>(
        qu, qv, k, v, p, a.lengths, g, a.lse, a.delta, static_cast<bf16*>(a.out0), static_cast<bf16*>(a.out1),
        a.seq, a.heads, a.scale);
    return cudaGetLastError();
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
  const cudaError_t err = configure<KIND, DH>();
  if (err != cudaSuccess) return err;
  return plan_of(tc_kernel<KIND, DH>(), tc_smem<KIND, DH>(), blocks_per_sm, registers, local_bytes, smem_bytes);
}

template <int KIND>
cudaError_t plan_kind(int head_dim, int* blocks_per_sm, int* registers, int* local_bytes, int* smem_bytes) {
  switch (head_dim) {
    case 16: return plan<KIND, 16>(blocks_per_sm, registers, local_bytes, smem_bytes);
    case 32: return plan<KIND, 32>(blocks_per_sm, registers, local_bytes, smem_bytes);
    case 64: return plan<KIND, 64>(blocks_per_sm, registers, local_bytes, smem_bytes);
    case 128: return plan<KIND, 128>(blocks_per_sm, registers, local_bytes, smem_bytes);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

namespace relpos {

cudaError_t bwd_dq_tc(int head_dim, const BwdArgs& a) { return dispatch_tc<kTcDq>(head_dim, a); }
cudaError_t bwd_dkv_tc(int head_dim, const BwdArgs& a) { return dispatch_tc<kTcDkv>(head_dim, a); }
cudaError_t bwd_dband_tc(int head_dim, const BwdArgs& a) { return dispatch_tc<kTcDband>(head_dim, a); }

}  // namespace relpos

// kind 0: dq, 1: dband, 2: dkv.  Host only: the blocks an SM holds at once
// (the occupancy calculator, after the kernel's shared-memory opt-in),
// registers a thread, local memory a thread (non-zero: spills or a stack
// frame) and dynamic shared memory a block.
extern "C" int attention_relpos_bwd_tc_plan(int kind, int head_dim, int* blocks_per_sm, int* registers,
                                            int* local_bytes, int* smem_bytes) {
  switch (kind) {
    case kTcDq: return plan_kind<kTcDq>(head_dim, blocks_per_sm, registers, local_bytes, smem_bytes);
    case kTcDband: return plan_kind<kTcDband>(head_dim, blocks_per_sm, registers, local_bytes, smem_bytes);
    case kTcDkv: return plan_kind<kTcDkv>(head_dim, blocks_per_sm, registers, local_bytes, smem_bytes);
    default: return cudaErrorInvalidValue;
  }
}

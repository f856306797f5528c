// SAME-padded depthwise 1-D convolution, channels-last, and its weight gradient, for sm_90a.
//
// depthwise_conv_kernel replaces nn_conformer_for_speech_recognition_tpu/ops/pallas/depthwise_conv.py:
// _dw_kernel (:50, pallas_call :79).  x (B, T, C), w (K, C) -> out (B, T, C):
//   out[b][t][c] = sum_i w[i][c] * x[b][t + i - pad_lo][c],  zeros outside [0, T)
// pad_lo and the tap order are arguments: the gradient with respect to x is this kernel on the incoming
// gradient with the taps reversed (reverse_taps) and pad_lo = K - 1 - (K - 1) / 2.
// depthwise_dw_kernel + depthwise_dw_reduce_kernel replace the jnp backward _dw_bwd (:107) for w:
//   dw[i][c] = sum_{b, t in [0, T)} x[b][t + i - pad_lo][c] * g[b][t][c]   (float32)
// Products and sums are float32 throughout; out is rounded once to x's type.
//
// Their bound on the H100 is bytes: at (16, 235, 512) bfloat16 the forward reads x and writes out once,
// 7.7 MB, ~2.3 us at 3.35 TB/s, against 2 * K operations an element on the float32 FMA units, ~1.9 us at
// K = 33; dw reads x and g once.  What holds them is the multiply-add loop at 16 warps an SM (the fixed
// builds' registers allow two 8-warp blocks): the copies run beside it.  The first version of this kernel
// spent one 4-byte shared load per FMA on a float32 copy of the halo; its dw was no kernel (an unfold of x to
// (B, T, C, K) float32, 254 MB a call, and an einsum).
//
// The design, both kernels:
// - a block is kSlab = 64 channels by row_groups warps along T; a thread owns a channel pair and kRows = 8
//   consecutive rows of a tile (the forward's outputs, dw's rows of g); a tile is row_groups * kRows rows of
//   one batch row.  The blocks of a slab walk its tiles with a stride (ops/cuda/depthwise_conv.py::
//   depthwise_plan picks the row groups and the blocks: about two 8-warp blocks an SM), so a block loads its
//   taps once and copies tile n + 1 while it computes tile n (two buffers);
// - a tile's halo of x, (tile + K rounded up to kRows) rows of its 64 channels (and for dw the tile's rows of
//   g), is staged in x's own type by 16-byte cp.async with zero fill outside [0, T) and past C (the vector
//   layout: C * element size a multiple of 16 and 16-byte aligned pointers); otherwise (C = 129, a view at an
//   odd offset) by element-wide loads (the scalar layout), the same arithmetic after staging;
// - at K = kFixedTaps (the configs' 33) the K taps of the pair (forward) or its 2K per-tap sums (dw) stay in
//   registers, and the thread walks its kRows + K - 1 window rows once: each 4-byte shared load of a channel
//   pair feeds up to 2 * kRows FMAs, in the twin's tap order.  Any other K takes the generic build: taps
//   (or per-tap sums) as float32 in shared memory and a ring of kRows window rows in registers;
// - the forward's outputs go back through the tile's buffer and out in 16-byte stores (the vector layout);
// - dw has no float atomics: each thread's per-tap sums run over its block's tiles, the block adds its row
//   groups' sums in order into one float32 (K, 64) partial, and depthwise_dw_reduce_kernel adds the blocks'
//   partials in block order.  Two launches give bit-equal dw.
// The launchers take the plan's layout (row groups, fixed or generic taps, vector or scalar, blocks a slab,
// shared bytes) and refuse any other than their own.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>
#include <type_traits>

#include "tensor_core.cuh"

namespace {

constexpr int kSlab = 64;                  // channels a block: one warp of channel pairs along C
constexpr int kPairs = kSlab / 2;          // threadIdx.x
constexpr int kRows = 8;                   // rows a thread: its outputs (forward) or its rows of g (dw)
constexpr int kMaxRowGroups = 8;           // threadIdx.y: a tile is row_groups * kRows rows
constexpr int kFixedTaps = 33;             // the K whose taps (or per-tap sums) stay in registers
constexpr int kMaxTaps = 288;              // the generic builds' cap: their layouts at one row group, float32
constexpr size_t kMaxShared = 227 * 1024;  // the shared memory a block may opt into on the H100

template <typename T>
struct Pair;
template <>
struct Pair<float> {
  using type = float2;
};
template <>
struct Pair<__nv_bfloat16> {
  using type = __nv_bfloat162;
};

__device__ __forceinline__ float to_float(float v) { return v; }
__device__ __forceinline__ float to_float(__nv_bfloat16 v) { return __bfloat162float(v); }
__device__ __forceinline__ float2 to_float2(float2 v) { return v; }
__device__ __forceinline__ float2 to_float2(__nv_bfloat162 v) { return __bfloat1622float2(v); }
__device__ __forceinline__ void put(float* p, float v) { *p = v; }
__device__ __forceinline__ void put(__nv_bfloat16* p, float v) { *p = __float2bfloat16(v); }
__device__ __forceinline__ void put2(float2* p, float2 v) { *p = v; }
__device__ __forceinline__ void put2(__nv_bfloat162* p, float2 v) { *p = __float22bfloat162_rn(v); }

__device__ __forceinline__ void fma2(float2& acc, float2 a, float2 b) {
  acc.x = fmaf(a.x, b.x, acc.x);
  acc.y = fmaf(a.y, b.y, acc.y);
}

__host__ __device__ constexpr int round_up(int a, int m) { return (a + m - 1) / m * m; }

// rows of the staged halo: the tile's rows and K rounded up to kRows (the generic window reads up to row
// tile + round_up(K) - 1; rows from tile + K - 1 on are zero)
__host__ __device__ constexpr int halo_rows(int row_groups, int k) { return row_groups * kRows + round_up(k, kRows); }

// The block's shared bytes: two halo buffers in x's type (the tile being read and the next one being copied),
// then, for the forward with generic taps, the taps as float32; for dw also two buffers of the tile's rows of
// g, and with generic taps each row group's per-tap sums as float32.  ops/cuda/depthwise_conv.py::shared_bytes
// is the same.
size_t shared_bytes(bool dw, int row_groups, int k, int elem, bool fixed) {
  const size_t kp = round_up(k, kRows), tile = static_cast<size_t>(row_groups) * kRows;
  const size_t halo = static_cast<size_t>(halo_rows(row_groups, k)) * kSlab * elem;
  if (dw) return 2 * (halo + tile * kSlab * elem) + (fixed ? 0 : row_groups * kp * kSlab * sizeof(float));
  return 2 * halo + (fixed ? 0 : kp * kSlab * sizeof(float));
}

// channels ch, ch + 1 of one row of p as float32; the vector layout reads both at once (C is even there),
// the scalar one each alone, zero past C
template <typename T, bool kVec>
__device__ __forceinline__ float2 load_pair(const T* p, int ch, int c) {
  if constexpr (kVec) {
    if (ch >= c) return make_float2(0.f, 0.f);
    return to_float2(*reinterpret_cast<const typename Pair<T>::type*>(p + ch));
  } else {
    return make_float2(ch < c ? to_float(p[ch]) : 0.f, ch + 1 < c ? to_float(p[ch + 1]) : 0.f);
  }
}

// Row r of buf holds row src0 + r of a batch row of x (its first row at row0) for the slab's 64 channels,
// zero where that row lies outside [0, T), where r >= real, or past C.  The vector layout copies 16 bytes a
// thread with cp.async (the caller commits and waits), the scalar one an element.
template <typename T, bool kVec>
__device__ __forceinline__ void stage_rows(T* buf, const T* x, size_t row0, int t, int c, int ch0, int src0,
                                           int rows, int real, int tid, int nthreads) {
  if constexpr (kVec) {
    constexpr int kChunk = 16 / sizeof(T), kChunks = kSlab / kChunk;
    for (int idx = tid; idx < rows * kChunks; idx += nthreads) {
      const int r = idx / kChunks, q = idx % kChunks;
      const int src = src0 + r, ch = ch0 + q * kChunk;
      const bool valid = r < real && src >= 0 && src < t && ch < c;
      tc::cp_async16(buf + r * kSlab + q * kChunk, valid ? x + (row0 + src) * c + ch : x, valid);
    }
  } else {
    for (int idx = tid; idx < rows * kSlab; idx += nthreads) {
      const int r = idx / kSlab, q = idx % kSlab;
      const int src = src0 + r, ch = ch0 + q;
      const bool valid = r < real && src >= 0 && src < t && ch < c;
      put(buf + idx, valid ? to_float(x[(row0 + src) * c + ch]) : 0.f);
    }
  }
}

// the copies of the next tile are committed as one group; the current tile's group (the one before) must be
// in, and every thread's copies and stores visible, before any thread reads it
template <bool kVec>
__device__ __forceinline__ void next_tile_issued_current_ready() {
  if constexpr (kVec) {
    tc::cp_async_commit();
    tc::cp_async_wait<1>();
  }
  __syncthreads();
}

// the channel pair of row r of a staged buffer
template <typename T>
__device__ __forceinline__ float2 row_pair(const T* buf, int r, int pair) {
  return to_float2(*reinterpret_cast<const typename Pair<T>::type*>(buf + r * kSlab + 2 * pair));
}

// Tile j of a slab: batch row j / tiles_per_row (its first row of B * T at row0), rows from t0.
struct Tile {
  size_t row0;
  int t0;
};

__device__ __forceinline__ Tile tile_at(int j, int tiles_per_row, int tile, int t) {
  return {static_cast<size_t>(j / tiles_per_row) * t, (j % tiles_per_row) * tile};
}

// grid (blocks of a slab, slabs of kSlab channels), block (kPairs, row_groups).  Block b of a slab takes the
// slab's tiles b, b + gridDim.x, ... (`tiles` in all, tiles_per_row to a batch row), copying tile n + 1 while
// it computes tile n; its taps are loaded once.
template <typename T, bool kVec, int kTaps>
__global__ void __launch_bounds__(kPairs * kMaxRowGroups, 2)
    depthwise_conv_kernel(const T* __restrict__ x, const T* __restrict__ w, T* __restrict__ out, int t, int c,
                          int k, int pad_lo, int reverse_taps, int tiles_per_row, int tiles) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int row_groups = blockDim.y, nthreads = kPairs * row_groups, tile = row_groups * kRows;
  const int hrows = halo_rows(row_groups, k), kp = round_up(k, kRows);
  T* halos = reinterpret_cast<T*>(smem);  // [2][hrows][kSlab]
  float* taps = reinterpret_cast<float*>(smem + 2 * static_cast<size_t>(hrows) * kSlab * sizeof(T));  // [kp][kSlab]
  const int pair = threadIdx.x, tid = threadIdx.y * kPairs + pair, base = threadIdx.y * kRows;
  const int ch0 = blockIdx.y * kSlab, ch = ch0 + 2 * pair;
  auto stage = [&](int j, int buf) {
    const Tile at = tile_at(j, tiles_per_row, tile, t);
    stage_rows<T, kVec>(halos + buf * hrows * kSlab, x, at.row0, t, c, ch0, at.t0 - pad_lo, hrows, tile + k - 1,
                        tid, nthreads);
  };

  int j = blockIdx.x;
  if (j < tiles) stage(j, 0);
  if constexpr (kVec) tc::cp_async_commit();
  float2 wr[kTaps > 0 ? kTaps : 1];
  if constexpr (kTaps > 0) {
#pragma unroll
    for (int i = 0; i < kTaps; ++i) wr[i] = load_pair<T, kVec>(w + static_cast<size_t>(reverse_taps ? kTaps - 1 - i : i) * c, ch, c);
  } else {
    for (int idx = tid; idx < kp * kSlab; idx += nthreads) {
      const int i = idx / kSlab, q = idx % kSlab;
      const int src = reverse_taps ? k - 1 - i : i;
      taps[idx] = i < k && ch0 + q < c ? to_float(w[static_cast<size_t>(src) * c + ch0 + q]) : 0.f;
    }
  }

  for (int n = 0; j < tiles; ++n, j += gridDim.x) {
    T* halo = halos + (n & 1) * hrows * kSlab;
    if (j + static_cast<int>(gridDim.x) < tiles) stage(j + gridDim.x, (n & 1) ^ 1);
    next_tile_issued_current_ready<kVec>();
    float2 acc[kRows];
#pragma unroll
    for (int r = 0; r < kRows; ++r) acc[r] = make_float2(0.f, 0.f);
    if constexpr (kTaps > 0) {
      // window row jj is output row base + r's tap jj - r
#pragma unroll
      for (int jj = 0; jj < kRows + kTaps - 1; ++jj) {
        const float2 v = row_pair(halo, base + jj, pair);
#pragma unroll
        for (int r = 0; r < kRows; ++r) {
          if (jj - r >= 0 && jj - r < kTaps) fma2(acc[r], wr[jj - r], v);
        }
      }
    } else {
      // ring of the window: slot s holds row base + m for the m = s (mod kRows) that tap i still needs
      float2 win[kRows];
#pragma unroll
      for (int r = 0; r < kRows; ++r) win[r] = row_pair(halo, base + r, pair);
      for (int i0 = 0; i0 < kp; i0 += kRows) {
#pragma unroll
        for (int ii = 0; ii < kRows; ++ii) {
          const int i = i0 + ii;
          if (i < k) {
            const float2 wi = *reinterpret_cast<const float2*>(taps + i * kSlab + 2 * pair);
#pragma unroll
            for (int r = 0; r < kRows; ++r) fma2(acc[r], wi, win[(r + ii) % kRows]);
          }
          win[ii] = row_pair(halo, base + i + kRows, pair);
        }
      }
    }

    const Tile at = tile_at(j, tiles_per_row, tile, t);
    if constexpr (kVec) {
      // through this tile's buffer (free once every thread is past it), then 16 bytes a thread
      __syncthreads();
      using P = typename Pair<T>::type;
#pragma unroll
      for (int r = 0; r < kRows; ++r) put2(reinterpret_cast<P*>(halo + (base + r) * kSlab + 2 * pair), acc[r]);
      __syncthreads();
      constexpr int kChunk = 16 / sizeof(T), kChunks = kSlab / kChunk;
      for (int idx = tid; idx < tile * kChunks; idx += nthreads) {
        const int r = idx / kChunks, q = idx % kChunks;
        const int row = at.t0 + r, cc = ch0 + q * kChunk;
        if (row < t && cc < c) {
          *reinterpret_cast<uint4*>(out + (at.row0 + row) * c + cc) =
              *reinterpret_cast<const uint4*>(halo + r * kSlab + q * kChunk);
        }
      }
    } else {
#pragma unroll
      for (int r = 0; r < kRows; ++r) {
        const int row = at.t0 + base + r;
        if (row >= t) break;
        T* dst = out + (at.row0 + row) * c;
        if (ch < c) put(dst + ch, acc[r].x);
        if (ch + 1 < c) put(dst + ch + 1, acc[r].y);
      }
    }
    __syncthreads();  // the next tile but one is copied into this buffer
  }
}

// The same grid, block and walk over the tiles as the forward; each thread's per-tap sums run over all of its
// block's tiles.  part[b * K * C + i * C + c] (b the block of its slab, c in the slab) is the block's float32
// sum over its rows of x[t + i - pad_lo] * g[t], its row groups' sums added in row-group order.
template <typename T, bool kVec, int kTaps>
__global__ void __launch_bounds__(kPairs * kMaxRowGroups, 2)
    depthwise_dw_kernel(const T* __restrict__ x, const T* __restrict__ g, float* __restrict__ part, int t, int c,
                        int k, int pad_lo, int tiles_per_row, int tiles) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int row_groups = blockDim.y, nthreads = kPairs * row_groups, tile = row_groups * kRows;
  const int hrows = halo_rows(row_groups, k), kp = round_up(k, kRows);
  // the two tiles' buffers; at the end they hold kRows taps of every row group's sums (row_groups * kRows * 256 B)
  const size_t buffers = 2 * static_cast<size_t>(hrows + tile) * kSlab * sizeof(T);
  T* halos = reinterpret_cast<T*>(smem);        // [2][hrows][kSlab]
  T* grows = halos + 2 * hrows * kSlab;         // [2][tile][kSlab]
  float* sums = reinterpret_cast<float*>(smem + buffers);  // generic taps: [row_groups][kp][kSlab]
  const int pair = threadIdx.x, tid = threadIdx.y * kPairs + pair, base = threadIdx.y * kRows;
  const int ch0 = blockIdx.y * kSlab;
  auto stage = [&](int j, int buf) {
    const Tile at = tile_at(j, tiles_per_row, tile, t);
    stage_rows<T, kVec>(halos + buf * hrows * kSlab, x, at.row0, t, c, ch0, at.t0 - pad_lo, hrows, tile + k - 1,
                        tid, nthreads);
    stage_rows<T, kVec>(grows + buf * tile * kSlab, g, at.row0, t, c, ch0, at.t0, tile, tile, tid, nthreads);
  };

  int j = blockIdx.x;
  if (j < tiles) stage(j, 0);
  if constexpr (kVec) tc::cp_async_commit();
  float2 s[kTaps > 0 ? kTaps : 1];
  float2* mine = reinterpret_cast<float2*>(sums + static_cast<size_t>(threadIdx.y) * kp * kSlab) + pair;
  if constexpr (kTaps > 0) {
#pragma unroll
    for (int i = 0; i < kTaps; ++i) s[i] = make_float2(0.f, 0.f);
  } else {
    for (int i = 0; i < kp; ++i) mine[i * kPairs] = make_float2(0.f, 0.f);  // this thread's own sums
  }

  for (int n = 0; j < tiles; ++n, j += gridDim.x) {
    const T* halo = halos + (n & 1) * hrows * kSlab;
    const T* gbuf = grows + (n & 1) * tile * kSlab;
    if (j + static_cast<int>(gridDim.x) < tiles) stage(j + gridDim.x, (n & 1) ^ 1);
    next_tile_issued_current_ready<kVec>();
    float2 gr[kRows];  // this thread's rows of g, zero past T
#pragma unroll
    for (int r = 0; r < kRows; ++r) gr[r] = row_pair(gbuf, base + r, pair);
    if constexpr (kTaps > 0) {
      // window row jj meets row base + r of g at tap jj - r
#pragma unroll
      for (int jj = 0; jj < kRows + kTaps - 1; ++jj) {
        const float2 v = row_pair(halo, base + jj, pair);
#pragma unroll
        for (int r = 0; r < kRows; ++r) {
          if (jj - r >= 0 && jj - r < kTaps) fma2(s[jj - r], v, gr[r]);
        }
      }
    } else {
      float2 win[kRows];
#pragma unroll
      for (int r = 0; r < kRows; ++r) win[r] = row_pair(halo, base + r, pair);
      for (int i0 = 0; i0 < kp; i0 += kRows) {
#pragma unroll
        for (int ii = 0; ii < kRows; ++ii) {
          const int i = i0 + ii;
          float2 si = mine[i * kPairs];  // the sums of taps past K are never read
#pragma unroll
          for (int r = 0; r < kRows; ++r) fma2(si, win[(r + ii) % kRows], gr[r]);
          mine[i * kPairs] = si;
          win[ii] = row_pair(halo, base + i + kRows, pair);
        }
      }
    }
    __syncthreads();  // the next tile but one is copied into these buffers
  }

  // the block's partial: its row groups' sums added in row-group order
  float* dst = part + static_cast<size_t>(blockIdx.x) * k * c;
  if constexpr (kTaps > 0) {
    // through the idle buffers, kChunk taps at a time (every layout's buffers hold kChunk taps of its row groups)
    if constexpr (kVec) tc::cp_async_wait<0>();
    constexpr int kChunk = kRows;
    float* red = reinterpret_cast<float*>(smem);  // [row_groups][kChunk][kSlab]
#pragma unroll
    for (int lo = 0; lo < kTaps; lo += kChunk) {
#pragma unroll
      for (int i = lo; i < lo + kChunk && i < kTaps; ++i) {
        reinterpret_cast<float2*>(red + (threadIdx.y * kChunk + i - lo) * kSlab)[pair] = s[i];
      }
      __syncthreads();
      const int taps = min(kChunk, kTaps - lo);
      for (int idx = tid; idx < taps * kSlab; idx += nthreads) {
        const int i = idx / kSlab, q = idx % kSlab;
        if (ch0 + q >= c) continue;
        float total = red[idx];
        for (int rg = 1; rg < row_groups; ++rg) total += red[(rg * kChunk + i) * kSlab + q];
        dst[static_cast<size_t>(lo + i) * c + ch0 + q] = total;
      }
      __syncthreads();
    }
  } else {
    for (int idx = tid; idx < k * kSlab; idx += nthreads) {
      const int i = idx / kSlab, q = idx % kSlab;
      if (ch0 + q >= c) continue;
      float total = sums[idx];
      for (int rg = 1; rg < row_groups; ++rg) total += sums[(static_cast<size_t>(rg) * kp + i) * kSlab + q];
      dst[static_cast<size_t>(i) * c + ch0 + q] = total;
    }
  }
}

// dw[e] = the partials of every block of a slab, added in block order (e over the K * C entries)
__global__ void depthwise_dw_reduce_kernel(const float* __restrict__ part, float* __restrict__ dw, int n, int blocks) {
  constexpr int kAhead = 8;  // partials loaded before they are added
  for (int e = blockIdx.x * blockDim.x + threadIdx.x; e < n; e += gridDim.x * blockDim.x) {
    float total = 0.f;
    int b = 0;
    for (; b + kAhead <= blocks; b += kAhead) {
      float v[kAhead];
#pragma unroll
      for (int u = 0; u < kAhead; ++u) v[u] = part[static_cast<size_t>(b + u) * n + e];
#pragma unroll
      for (int u = 0; u < kAhead; ++u) total += v[u];
    }
    for (; b < blocks; ++b) total += part[static_cast<size_t>(b) * n + e];
    dw[e] = total;
  }
}

int smem_optin() {
  static const int bytes = [] {
    int device = 0, value = 0;
    cudaGetDevice(&device);
    cudaDeviceGetAttribute(&value, cudaDevAttrMaxSharedMemoryPerBlockOptin, device);
    return value;
  }();
  return bytes;
}

// Sets a kernel's shared-memory opt-in once, to the device's maximum.
template <auto Kernel>
cudaError_t configure() {
  static const cudaError_t status =
      cudaFuncSetAttribute(Kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem_optin());
  return status;
}

bool aligned16(const void* p) { return reinterpret_cast<uintptr_t>(p) % 16 == 0; }

// What depthwise_plan hands a launch, checked: the shapes within the kernels' range, 1, 2, 4 or 8 row groups,
// the fixed taps only where K is that K, the vector layout only where C rows and every pointer allow 16-byte
// copies, between one block a slab and one a tile, and the plan's shared bytes those of this layout and
// within what a block may opt into.
bool layout_ok(bool dw, int batch, int t, int c, int k, int pad_lo, int elem, int row_groups, int fixed_taps,
               int vec, int blocks_per_slab, int smem, const void* a, const void* b, const void* d) {
  const bool shapes = batch >= 1 && batch <= 65535 && t >= 1 && c >= 1 && (c + kSlab - 1) / kSlab <= 65535 &&
                      k >= 1 && k <= kMaxTaps && pad_lo >= 0 && pad_lo < k;
  const bool groups = row_groups == 1 || row_groups == 2 || row_groups == 4 || row_groups == kMaxRowGroups;
  if (!shapes || !groups) return false;
  const long long tiles = static_cast<long long>(batch) * ((t + row_groups * kRows - 1) / (row_groups * kRows));
  const bool blocks = blocks_per_slab >= 1 && blocks_per_slab <= tiles && tiles <= 0x7fffffff;
  const bool taps = fixed_taps == 0 || (fixed_taps == kFixedTaps && k == kFixedTaps);
  const bool copies = !vec || (static_cast<size_t>(c) * elem % 16 == 0 && aligned16(a) && aligned16(b) && aligned16(d));
  const size_t layout = shared_bytes(dw, row_groups, k, elem, fixed_taps != 0);
  return blocks && taps && copies && static_cast<size_t>(smem) == layout && layout <= kMaxShared &&
         smem <= smem_optin();
}

int tiles_per_row(int t, int row_groups) { return (t + row_groups * kRows - 1) / (row_groups * kRows); }

template <typename T, bool kVec, int kTaps>
cudaError_t launch_fwd(const void* x, const void* w, void* out, int batch, int t, int c, int k, int pad_lo,
                       int reverse_taps, int row_groups, int blocks_per_slab, int smem, cudaStream_t stream) {
  const cudaError_t err = configure<depthwise_conv_kernel<T, kVec, kTaps>>();
  if (err != cudaSuccess) return err;
  const int per_row = tiles_per_row(t, row_groups);
  depthwise_conv_kernel<T, kVec, kTaps>
      <<<dim3(blocks_per_slab, (c + kSlab - 1) / kSlab), dim3(kPairs, row_groups), smem, stream>>>(
          static_cast<const T*>(x), static_cast<const T*>(w), static_cast<T*>(out), t, c, k, pad_lo, reverse_taps,
          per_row, batch * per_row);
  return cudaGetLastError();
}

template <typename T, bool kVec, int kTaps>
cudaError_t launch_dw(const void* x, const void* g, float* part, float* dw, int batch, int t, int c, int k,
                      int pad_lo, int row_groups, int blocks_per_slab, int smem, cudaStream_t stream) {
  const cudaError_t err = configure<depthwise_dw_kernel<T, kVec, kTaps>>();
  if (err != cudaSuccess) return err;
  const int per_row = tiles_per_row(t, row_groups);
  depthwise_dw_kernel<T, kVec, kTaps>
      <<<dim3(blocks_per_slab, (c + kSlab - 1) / kSlab), dim3(kPairs, row_groups), smem, stream>>>(
          static_cast<const T*>(x), static_cast<const T*>(g), part, t, c, k, pad_lo, per_row, batch * per_row);
  const cudaError_t first = cudaGetLastError();
  if (first != cudaSuccess) return first;
  const int n = k * c;
  depthwise_dw_reduce_kernel<<<(n + 255) / 256, 256, 0, stream>>>(part, dw, n, blocks_per_slab);
  return cudaGetLastError();
}

// f(std::integral_constant<bool, vec>, std::integral_constant<int, taps>) for the four builds of a type
template <class F>
cudaError_t by_layout(int vec, int fixed_taps, F&& f) {
  if (vec) {
    return fixed_taps ? f(std::integral_constant<bool, true>{}, std::integral_constant<int, kFixedTaps>{})
                      : f(std::integral_constant<bool, true>{}, std::integral_constant<int, 0>{});
  }
  return fixed_taps ? f(std::integral_constant<bool, false>{}, std::integral_constant<int, kFixedTaps>{})
                    : f(std::integral_constant<bool, false>{}, std::integral_constant<int, 0>{});
}

template <class Kernel>
cudaError_t attributes(Kernel* kernel, int* registers, int* local_bytes) {
  cudaFuncAttributes attr;
  const cudaError_t err = cudaFuncGetAttributes(&attr, kernel);
  if (err != cudaSuccess) return err;
  *registers = attr.numRegs;
  *local_bytes = static_cast<int>(attr.localSizeBytes);
  return cudaSuccess;
}

}  // namespace

// row_groups, fixed_taps, vec, blocks_per_slab and smem_bytes: ops/cuda/depthwise_conv.py::depthwise_plan
// (the forward's)
extern "C" int depthwise_conv_fwd(const void* x, const void* w, void* out, int batch, int t, int c, int k,
                                  int pad_lo, int reverse_taps, int is_bf16, int row_groups, int fixed_taps, int vec,
                                  int blocks_per_slab, int smem_bytes, void* stream) {
  const int elem = is_bf16 ? 2 : 4;
  if (!layout_ok(false, batch, t, c, k, pad_lo, elem, row_groups, fixed_taps, vec, blocks_per_slab, smem_bytes, x, w,
                 out)) {
    return cudaErrorInvalidValue;
  }
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  return by_layout(vec, fixed_taps, [&](auto v, auto taps) {
    if (is_bf16) {
      return launch_fwd<__nv_bfloat16, decltype(v)::value, decltype(taps)::value>(
          x, w, out, batch, t, c, k, pad_lo, reverse_taps, row_groups, blocks_per_slab, smem_bytes, s);
    }
    return launch_fwd<float, decltype(v)::value, decltype(taps)::value>(
        x, w, out, batch, t, c, k, pad_lo, reverse_taps, row_groups, blocks_per_slab, smem_bytes, s);
  });
}

// part: blocks_per_slab float32 (K, C) partials; dw: (K, C) float32.  row_groups, fixed_taps, vec,
// blocks_per_slab and smem_bytes: ops/cuda/depthwise_conv.py::depthwise_plan (dw's)
extern "C" int depthwise_conv_dw(const void* x, const void* g, float* part, float* dw, int batch, int t, int c,
                                 int k, int pad_lo, int is_bf16, int row_groups, int fixed_taps, int vec,
                                 int blocks_per_slab, int smem_bytes, void* stream) {
  const int elem = is_bf16 ? 2 : 4;
  if (!layout_ok(true, batch, t, c, k, pad_lo, elem, row_groups, fixed_taps, vec, blocks_per_slab, smem_bytes, x, g,
                 part) ||
      static_cast<long long>(k) * c > 0x7fffffff) {
    return cudaErrorInvalidValue;
  }
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  return by_layout(vec, fixed_taps, [&](auto v, auto taps) {
    if (is_bf16) {
      return launch_dw<__nv_bfloat16, decltype(v)::value, decltype(taps)::value>(
          x, g, part, dw, batch, t, c, k, pad_lo, row_groups, blocks_per_slab, smem_bytes, s);
    }
    return launch_dw<float, decltype(v)::value, decltype(taps)::value>(x, g, part, dw, batch, t, c, k, pad_lo,
                                                                        row_groups, blocks_per_slab, smem_bytes, s);
  });
}

// kernel (0 forward, 1 dw, 2 dw's reduce), is_bf16, vec, fixed_taps → registers a thread and local memory a
// thread (non-zero: spills or a stack frame) of that build (host only; no launch)
extern "C" int depthwise_kernel_attributes(int kernel, int is_bf16, int vec, int fixed_taps, int* registers,
                                           int* local_bytes) {
  if (kernel == 2) return attributes(depthwise_dw_reduce_kernel, registers, local_bytes);
  if (kernel != 0 && kernel != 1) return cudaErrorInvalidValue;
  return by_layout(vec, fixed_taps, [&](auto v, auto taps) {
    constexpr bool kVec = decltype(v)::value;
    constexpr int kTaps = decltype(taps)::value;
    if (kernel == 0) {
      return is_bf16 ? attributes(depthwise_conv_kernel<__nv_bfloat16, kVec, kTaps>, registers, local_bytes)
                     : attributes(depthwise_conv_kernel<float, kVec, kTaps>, registers, local_bytes);
    }
    return is_bf16 ? attributes(depthwise_dw_kernel<__nv_bfloat16, kVec, kTaps>, registers, local_bytes)
                   : attributes(depthwise_dw_kernel<float, kVec, kTaps>, registers, local_bytes);
  });
}

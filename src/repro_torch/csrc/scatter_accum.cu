// Server-side FedNL aggregation in payload space: dense sums of silo
// payloads' (value, index) pairs, without float atomics.
//
// scatter_accumulate replaces the TPU kernels scatter_accum_kernel and
// scatter_accum_tiled_kernel (src/repro/kernels/scatter_accum/kernel.py,
// bodies _scatter_accum_tile_kernel, _scatter_accum_tile_init_kernel,
// _scatter_accum_tiled_tile_kernel, _chunk_contribution, _mirror_vals):
// the (d0, d1) sum of n * k (value, row-major flat index) pairs; indices
// outside [0, d0 * d1), the -1 padding among them, are dropped;
// duplicates add; `symmetric` lands every off-diagonal pair at (r, c) and
// (c, r) and a diagonal pair once; `init` seeds the sum.
//
// block_scatter_accumulate replaces block_scatter_accum_kernel
// (_block_scatter_tile_kernel): per (block x block) output tile, the sum
// of all n silos' in-tile (value, flat index) pairs in the
// BlockSparsePayload layout (n, tiles, k); indices outside
// [0, block^2) are dropped.
//
// Determinism: every output cell adds the pairs that land on it in
// stream order (silo, then slot; a pair's mirror right after the pair),
// from 0 (or `init`). The result does not depend on the launch, and a
// silo whose values are all zero leaves every cell bit for bit as it was.
//
// Bound on the H100: bytes (pairs in, dense sum out).
//
// scatter_accumulate: one thread block per square of 32 x 32 output
// cells. The pairs of a dense FedNL Hessian diff scatter over the whole
// matrix, so the block streams all n * k pairs, in chunks of 1,024, one
// per thread, the next chunk's pairs loaded while the current one is
// placed. The pairs that land in the square are split by row into shared
// memory, in stream order within each row (warp ballots rank them, one
// block-wide exclusive scan places the rows); warp w then walks row w's
// entries and lane l adds those addressed to column l. A square on the
// diagonal receives thousands of pairs per call; split by row, each warp
// walks only its row's share of them.
//
// block_scatter_accumulate: a block-sparse payload's pairs are already
// grouped by tile, as contiguous runs of k per (silo, tile). One thread
// block owns one output tile — or, where block^2 cells of T exceed the
// shared-memory budget, one band of its rows — and holds its sum in
// shared memory. It reads the tile's n * k pairs once, as one stream in
// stream order (silo, then slot), in chunks of 2,048 positions (several
// silos a chunk when k is small), 16-byte loads where k allows, the next
// chunk's pairs loaded while the current chunk's are added; it writes
// the tile's rows with 16-byte stores. Chunks go in order, a barrier
// apart. Within a chunk whose cells are distinct every cell takes at
// most one add, so the adds run in parallel; a payload from the top-k
// kernels has distinct cells within a silo, so a refresh (k = 2,048, a
// silo a chunk) adds every chunk that way. Whether a chunk's cells are
// distinct is checked, not assumed: each in-range pair sets its cell's
// bit in a shared bitmap with atomicOr, and a pair that finds its bit
// already set marks the chunk. A marked chunk is added in stream order
// by one warp instead (per 32 positions, the pairs of one cell add in
// lane order), so repeated cells keep the stream order.

#include <cuda_runtime.h>

#include <cstdint>

#include "common.cuh"

namespace {

constexpr int kThreads = 1024;
constexpr int kSide = 32;

template <typename T>
__global__ void __launch_bounds__(kThreads)
accumulate_kernel(const T* __restrict__ vals, const int* __restrict__ idx,
                  const T* __restrict__ init, T* __restrict__ out, int n,
                  int k, int d0, int d1, int symmetric) {
  __shared__ short s_col[2][2 * kThreads];    // double-buffered by chunk
  __shared__ T s_val[2][2 * kThreads];
  __shared__ int row_start[2][kSide + 1];
  __shared__ int offsets[kSide * 32];         // [row][warp]
  __shared__ int red_i[32];

  // thread (warp w, lane l) owns cell (r0 + w, c0 + l) of the square
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const unsigned below = (1u << lane) - 1u;
  const int r0 = blockIdx.y * kSide, c0 = blockIdx.x * kSide;
  const int my_r = r0 + warp, my_c = c0 + lane;
  const bool mine = my_r < d0 && my_c < d1;
  T acc = (init != nullptr && mine)
              ? init[static_cast<long long>(my_r) * d1 + my_c] : T(0);

  // every pair of the stream may land in this square
  const long long npairs = static_cast<long long>(n) * k;
  const int limit = d0 * d1;
  int next_id = -1;
  T next_v = T(0);
  if (threadIdx.x < npairs) {
    next_id = idx[threadIdx.x];
    next_v = vals[threadIdx.x];
  }
  for (long long base = 0, chunk = 0; base < npairs;
       base += kThreads, ++chunk) {
    const int id = next_id;
    const T v = next_v;
    const long long p = base + kThreads + threadIdx.x;
    if (p < npairs) {                            // prefetch the next chunk
      next_id = idx[p];
      next_v = vals[p];
    } else {
      next_id = -1;
    }

    // the pair's cell in this square, and its mirror's: (row, col) or -1
    int row0 = -1, col0 = -1, row1 = -1, col1 = -1;
    if (id >= 0 && id < limit) {
      const int r = id / d1, c = id - r * d1;
      if (r >= r0 && r < r0 + kSide && c >= c0 && c < c0 + kSide) {
        row0 = r - r0;
        col0 = c - c0;
      }
      if (symmetric && r != c && c >= r0 && c < r0 + kSide && r >= c0 &&
          r < c0 + kSide && c < d0 && r < d1) {
        row1 = c - r0;                           // never row0: r != c
        col1 = r - c0;
      }
    }

    // split the chunk's entries by row, keeping stream (thread) order:
    // per warp and row, a count and each entry's rank among lower lanes
    offsets[lane * 32 + warp] = 0;
    __syncwarp();
    int rank0 = 0, rank1 = 0;
    unsigned todo0 = __ballot_sync(0xffffffffu, row0 >= 0);
    unsigned todo1 = __ballot_sync(0xffffffffu, row1 >= 0);
    while (todo0 | todo1) {                      // once per row present
      const int src = __ffs(todo0 ? todo0 : todo1) - 1;
      const int b = __shfl_sync(0xffffffffu, todo0 ? row0 : row1, src);
      const unsigned in0 = __ballot_sync(0xffffffffu, row0 == b);
      const unsigned in1 = __ballot_sync(0xffffffffu, row1 == b);
      const unsigned in_row = in0 | in1;
      if (row0 == b) rank0 = __popc(in_row & below);
      if (row1 == b) rank1 = __popc(in_row & below);
      if (lane == 0) offsets[b * 32 + warp] = __popc(in_row);
      todo0 &= ~in0;
      todo1 &= ~in1;
    }
    __syncthreads();
    int count;
    const int off = repro::block_exclusive_scan(offsets[threadIdx.x], &count,
                                                red_i);
    offsets[threadIdx.x] = off;                  // [row][warp] -> start
    const int buf = static_cast<int>(chunk & 1);
    if (lane == 0 && warp < kSide) row_start[buf][warp] = off;
    if (threadIdx.x == 0) row_start[buf][kSide] = count;
    __syncthreads();
    if (row0 >= 0) {
      const int pos = offsets[row0 * 32 + warp] + rank0;
      s_col[buf][pos] = static_cast<short>(col0);
      s_val[buf][pos] = v;
    }
    if (row1 >= 0) {
      const int pos = offsets[row1 * 32 + warp] + rank1;
      s_col[buf][pos] = static_cast<short>(col1);
      s_val[buf][pos] = v;
    }
    __syncthreads();
    // warp w adds row w's entries in stream order; the next chunk writes
    // the other buffers, and this chunk's only after the next one's scan
    const int end = row_start[buf][warp + 1];
    for (int j = row_start[buf][warp]; j < end; ++j)
      if (s_col[buf][j] == lane) acc += s_val[buf][j];
  }
  if (mine) out[static_cast<long long>(my_r) * d1 + my_c] = acc;
}


// -- block_scatter_accumulate ---------------------------------------------

constexpr int kTileThreads = 256;
constexpr int kPerThread = 8;                       // consecutive positions
constexpr int kSlots = kTileThreads * kPerThread;   // a chunk: 2,048 pairs
// shared bytes for the sum of one tile (or band): a 128 x 128 f64 tile
// fits whole, and so does an f32 tile up to block 221
constexpr int kAccBudget = 192 * 1024;

template <typename T>
struct Pairs {
  int cell[kPerThread];   // band-local cell, or -1 (out of range, padding)
  T v[kPerThread];
};

// The band-local cell of in-tile index id, or -1.
__device__ __forceinline__ int cell_of(int id, int lo, int cells) {
  const int c = id - lo;
  return id >= 0 && c >= 0 && c < cells ? c : -1;
}

// Stream positions q = s * k + slot of one tile, (silo s, slot) in the
// (n, tiles, k) layout: the pair's offset.
__device__ __forceinline__ size_t pair_offset(int q, int k, int nblk,
                                              int tile) {
  const int s = q / k;
  return (static_cast<size_t>(s) * nblk + tile) * k + (q - s * k);
}

// Positions base + 8 t .. + 7 of the tile's stream (n * k pairs, silo
// then slot). kVec: k % 4 == 0 and both arrays 16-byte aligned, so each
// half of the 8 lies in one silo's run and comes in 16-byte loads.
template <typename T, bool kVec>
__device__ __forceinline__ void load_pairs(Pairs<T>& p,
                                           const T* __restrict__ vals,
                                           const int* __restrict__ idx,
                                           int base, int npos, int k,
                                           int nblk, int tile, int lo,
                                           int cells) {
  const int q0 = base + kPerThread * static_cast<int>(threadIdx.x);
  if (kVec) {
#pragma unroll
    for (int h = 0; h < kPerThread / 4; ++h) {
      const int q = q0 + 4 * h;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        p.cell[4 * h + j] = -1;
        p.v[4 * h + j] = T(0);
      }
      if (q >= npos) continue;                  // npos % 4 == 0
      const size_t o = pair_offset(q, k, nblk, tile);
      const int4 ids = *reinterpret_cast<const int4*>(idx + o);
      T v4[4];
      if (sizeof(T) == 4) {
        const float4 x = *reinterpret_cast<const float4*>(vals + o);
        v4[0] = static_cast<T>(x.x); v4[1] = static_cast<T>(x.y);
        v4[2] = static_cast<T>(x.z); v4[3] = static_cast<T>(x.w);
      } else {
        const double2 x = reinterpret_cast<const double2*>(vals + o)[0];
        const double2 y = reinterpret_cast<const double2*>(vals + o)[1];
        v4[0] = static_cast<T>(x.x); v4[1] = static_cast<T>(x.y);
        v4[2] = static_cast<T>(y.x); v4[3] = static_cast<T>(y.y);
      }
      const int id4[4] = {ids.x, ids.y, ids.z, ids.w};
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        p.cell[4 * h + j] = cell_of(id4[j], lo, cells);
        p.v[4 * h + j] = v4[j];
      }
    }
  } else {
#pragma unroll
    for (int j = 0; j < kPerThread; ++j) {
      p.cell[j] = -1;
      p.v[j] = T(0);
      if (q0 + j < npos) {
        const size_t o = pair_offset(q0 + j, k, nblk, tile);
        p.cell[j] = cell_of(idx[o], lo, cells);
        p.v[j] = vals[o];
      }
    }
  }
}

template <typename T, bool kVec>
__global__ void __launch_bounds__(kTileThreads)
block_scatter_kernel(const T* __restrict__ vals, const int* __restrict__ idx,
                     T* __restrict__ out, int n, int nblk, int k, int block,
                     int gn, int band_rows, int nbands) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int tile = blockIdx.x / nbands, band = blockIdx.x - tile * nbands;
  const int row_lo = band * band_rows;
  const int rows = min(band_rows, block - row_lo);
  const int lo = row_lo * block, cells = rows * block;
  const int words = (cells + 31) >> 5;
  const int npos = n * k;                        // the tile's stream
  T* acc = reinterpret_cast<T*>(smem);
  // one bitmap of the band's cells per chunk parity
  unsigned* seen = reinterpret_cast<unsigned*>(
      smem + static_cast<size_t>(band_rows) * block * sizeof(T));
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;

  for (int w = threadIdx.x; w < cells * static_cast<int>(sizeof(T)) / 4;
       w += kTileThreads)
    reinterpret_cast<unsigned*>(acc)[w] = 0u;
  for (int w = threadIdx.x; w < 2 * words; w += kTileThreads) seen[w] = 0u;
  __syncthreads();

  // chunks of 2,048 consecutive stream positions, in order, a barrier
  // apart; the next chunk's pairs load while the current one is added
  Pairs<T> cur, nxt;
  if (npos > 0)
    load_pairs<T, kVec>(cur, vals, idx, 0, npos, k, nblk, tile, lo, cells);
  for (int base = 0, chunk = 0; base < npos; base += kSlots, ++chunk) {
    unsigned* bm = seen + (chunk & 1) * words;
    // 1. mark: does any in-range cell repeat within this chunk?
    unsigned dup = 0u;
#pragma unroll
    for (int j = 0; j < kPerThread; ++j) {
      const int c = cur.cell[j];
      if (c >= 0) {
        const unsigned bit = 1u << (c & 31);
        dup |= atomicOr(&bm[c >> 5], bit) & bit;
      }
    }
    if (base + kSlots < npos)
      load_pairs<T, kVec>(nxt, vals, idx, base + kSlots, npos, k, nblk, tile,
                          lo, cells);
    // the barrier also ends the previous chunk's adds; this chunk's
    // bitmap is cleared for the chunk after next
    const bool repeats = __syncthreads_or(dup != 0u);
    for (int w = threadIdx.x; w < words; w += kTileThreads) bm[w] = 0u;
    if (!repeats) {
      // 2. distinct cells: every pair adds, in parallel
#pragma unroll
      for (int j = 0; j < kPerThread; ++j)
        if (cur.cell[j] >= 0) acc[cur.cell[j]] += cur.v[j];
    } else if (warp == 0) {
      // 2'. repeated cells: warp 0 adds the chunk in stream order; per 32
      // positions, the lanes of one cell add one after another in lane
      // order
      const unsigned below = (1u << lane) - 1u;
      const int end = min(npos, base + kSlots);
      for (int q0 = base; q0 < end; q0 += 32) {
        int c = -1;
        T v = T(0);
        if (q0 + lane < end) {
          const size_t o = pair_offset(q0 + lane, k, nblk, tile);
          c = cell_of(idx[o], lo, cells);
          v = vals[o];
        }
        const unsigned peers = __match_any_sync(0xffffffffu, c);
        const int rank = __popc(peers & below);
        const int last = __reduce_max_sync(0xffffffffu, c >= 0 ? rank : 0);
        for (int r = 0; r <= last; ++r) {
          if (c >= 0 && rank == r) acc[c] += v;
          __syncwarp();
        }
      }
    }
    cur = nxt;
  }
  __syncthreads();

  // 3. the band's rows, each a contiguous run of block * sizeof(T) bytes
  const size_t n_cols = static_cast<size_t>(gn) * block;
  const size_t r0 = static_cast<size_t>(tile / gn) * block + row_lo;
  const size_t c0 = static_cast<size_t>(tile % gn) * block;
  if (kVec && (block * sizeof(T)) % 16 == 0) {
    const int units = block * static_cast<int>(sizeof(T)) / 16;  // per row
    for (int u = threadIdx.x; u < rows * units; u += kTileThreads) {
      const int r = u / units, cu = u - r * units;
      const uint4 x = reinterpret_cast<const uint4*>(acc + r * block)[cu];
      reinterpret_cast<uint4*>(out + (r0 + r) * n_cols + c0)[cu] = x;
    }
  } else {
    for (int e = threadIdx.x; e < cells; e += kTileThreads) {
      const int r = e / block, c = e - r * block;
      out[(r0 + r) * n_cols + c0 + c] = acc[e];
    }
  }
}

template <typename T>
int launch_block_scatter(const T* vals, const int* idx, T* out, int n,
                         int nblk, int k, int block, int gn,
                         cudaStream_t stream) {
  if (nblk <= 0 || block <= 0) return 0;
  if (gn <= 0 || nblk % gn != 0 || k < 0 || n < 0 ||
      static_cast<long long>(n) * k > 0x7fffffffLL)
    return static_cast<int>(cudaErrorInvalidValue);
  const long long row_bytes = static_cast<long long>(block) * sizeof(T);
  const long long max_rows = kAccBudget / row_bytes;
  if (max_rows < 1 || static_cast<long long>(block) * block > 0x7fffffffLL)
    return static_cast<int>(cudaErrorInvalidValue);
  const int nbands = static_cast<int>((block + max_rows - 1) / max_rows);
  const int band_rows = (block + nbands - 1) / nbands;
  const long long ctas = static_cast<long long>(nblk) * nbands;
  if (ctas > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  const int words = (band_rows * block + 31) / 32;
  const size_t smem = static_cast<size_t>(band_rows) * row_bytes +
                      2 * static_cast<size_t>(words) * 4;
  const bool vec = k % 4 == 0 && reinterpret_cast<uintptr_t>(vals) % 16 == 0 &&
                   reinterpret_cast<uintptr_t>(idx) % 16 == 0 &&
                   reinterpret_cast<uintptr_t>(out) % 16 == 0;
  auto kernel = vec ? block_scatter_kernel<T, true>
                    : block_scatter_kernel<T, false>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  kernel<<<static_cast<unsigned>(ctas), kTileThreads, smem, stream>>>(
      vals, idx, out, n, nblk, k, block, gn, band_rows, nbands);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_scatter(const T* vals, const int* idx, const T* init, T* out,
                   int n, int k, int d0, int d1, int symmetric,
                   cudaStream_t stream) {
  if (d0 == 0 || d1 == 0) return 0;
  const dim3 grid((d1 + kSide - 1) / kSide, (d0 + kSide - 1) / kSide);
  accumulate_kernel<T><<<grid, kThreads, 0, stream>>>(
      vals, idx, init, out, n, k, d0, d1, symmetric);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

int scatter_accumulate_f32(const float* vals, const int* idx, const float* init,
                           float* out, int n, int k, int d0, int d1,
                           int symmetric, cudaStream_t stream) {
  return launch_scatter(vals, idx, init, out, n, k, d0, d1, symmetric, stream);
}

int scatter_accumulate_f64(const double* vals, const int* idx,
                           const double* init, double* out, int n, int k,
                           int d0, int d1, int symmetric, cudaStream_t stream) {
  return launch_scatter(vals, idx, init, out, n, k, d0, d1, symmetric, stream);
}

int block_scatter_accumulate_f32(const float* vals, const int* idx, float* out,
                                 int n, int nblk, int k, int block, int gn,
                                 cudaStream_t stream) {
  return launch_block_scatter(vals, idx, out, n, nblk, k, block, gn, stream);
}

int block_scatter_accumulate_f64(const double* vals, const int* idx,
                                 double* out, int n, int nblk, int k,
                                 int block, int gn, cudaStream_t stream) {
  return launch_block_scatter(vals, idx, out, n, nblk, k, block, gn, stream);
}

}  // extern "C"

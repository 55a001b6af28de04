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
// Determinism: each output cell belongs to one thread, which adds the
// pairs that land on it in stream order (silo, then slot; a pair's
// mirror right after the pair). The result does not depend on the
// launch, and a silo whose values are all zero leaves every cell bit for
// bit as it was.
//
// Bound on the H100: bytes (pairs in, dense sum out); both sums are a
// few MB at most on FedNL's path, so in practice latency bounds them.
// Design: one thread block per square of TS x TS output cells (TS = 32,
// or the largest divisor of `block` up to 32, so a square never straddles
// two payload tiles). The block streams the pairs that can land in its
// square — all n * k for scatter_accumulate, the n * k of its one
// payload tile for block_scatter_accumulate — in chunks of 1,024, one per
// thread, the next chunk's pairs loaded while the current one is placed.
// The pairs that land in the square are split by row into shared memory,
// in stream order within each row (warp ballots rank them, one block-wide
// exclusive scan places the rows); warp w then walks row w's entries and
// lane l adds those addressed to column l. A square on the diagonal of a
// FedNL Hessian diff receives thousands of pairs per call; split by row,
// each warp walks only its row's share of them.

#include <cuda_runtime.h>

#include "common.cuh"

namespace {

constexpr int kThreads = 1024;
constexpr int kMaxSide = 32;

// Where a pair lands: global (row, col) of the dense sum, or row -1.
template <bool kBlockSparse>
__device__ __forceinline__ void locate(int id, int d1, int block, int tr,
                                       int tc, int limit, int* r, int* c) {
  if (id < 0 || id >= limit) { *r = -1; *c = -1; return; }
  if (kBlockSparse) {
    const int lr = id / block;
    *r = tr * block + lr;
    *c = tc * block + (id - lr * block);
  } else {
    *r = id / d1;
    *c = id - *r * d1;
  }
}

template <typename T, bool kBlockSparse>
__global__ void __launch_bounds__(kThreads)
accumulate_kernel(const T* __restrict__ vals, const int* __restrict__ idx,
                  const T* __restrict__ init, T* __restrict__ out, int n,
                  int k, int d0, int d1, int symmetric, int block, int nblk,
                  int side) {
  __shared__ short s_col[2][2 * kThreads];    // double-buffered by chunk
  __shared__ T s_val[2][2 * kThreads];
  __shared__ int row_start[2][kMaxSide + 1];
  __shared__ int offsets[kMaxSide * 32];      // [row][warp]
  __shared__ int red_i[32];

  // thread (warp w, lane l) owns cell (r0 + w, c0 + l) of the square
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const unsigned below = (1u << lane) - 1u;
  const int r0 = blockIdx.y * side, c0 = blockIdx.x * side;
  const int my_r = r0 + warp, my_c = c0 + lane;
  const bool mine = warp < side && lane < side && my_r < d0 && my_c < d1;
  T acc = (init != nullptr && mine)
              ? init[static_cast<long long>(my_r) * d1 + my_c] : T(0);

  // the pair stream feeding this square
  const long long npairs = static_cast<long long>(n) * k;
  int tile = 0, tr = 0, tc = 0, limit = d0 * d1;
  if (kBlockSparse) {
    tr = r0 / block;
    tc = c0 / block;
    tile = tr * (d1 / block) + tc;
    limit = block * block;
  }
  auto offset = [&](long long p) -> long long {
    if (!kBlockSparse) return p;
    const long long s = p / k;
    return (s * nblk + tile) * k + (p - s * k);
  };

  int next_id = -1;
  T next_v = T(0);
  if (threadIdx.x < npairs) {
    const long long o = offset(threadIdx.x);
    next_id = idx[o];
    next_v = vals[o];
  }
  for (long long base = 0, chunk = 0; base < npairs;
       base += kThreads, ++chunk) {
    const int id = next_id;
    const T v = next_v;
    const long long p = base + kThreads + threadIdx.x;
    if (p < npairs) {                            // prefetch the next chunk
      const long long o = offset(p);
      next_id = idx[o];
      next_v = vals[o];
    } else {
      next_id = -1;
    }

    // the pair's cell in this square, and its mirror's: (row, col) or -1
    int r, c, row0 = -1, col0 = -1, row1 = -1, col1 = -1;
    locate<kBlockSparse>(id, d1, block, tr, tc, limit, &r, &c);
    if (r >= 0) {
      if (r >= r0 && r < r0 + side && c >= c0 && c < c0 + side) {
        row0 = r - r0;
        col0 = c - c0;
      }
      if (symmetric && r != c && c >= r0 && c < r0 + side && r >= c0 &&
          r < c0 + side && c < d0 && r < d1) {
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
    if (lane == 0 && warp < kMaxSide) row_start[buf][warp] = off;
    if (threadIdx.x == 0) row_start[buf][kMaxSide] = count;
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
    if (warp < side) {
      const int end = row_start[buf][warp + 1];
      for (int j = row_start[buf][warp]; j < end; ++j)
        if (s_col[buf][j] == lane) acc += s_val[buf][j];
    }
  }
  if (mine) out[static_cast<long long>(my_r) * d1 + my_c] = acc;
}

template <typename T, bool kBlockSparse>
int launch(const T* vals, const int* idx, const T* init, T* out, int n, int k,
           int d0, int d1, int symmetric, int block, int nblk, int side,
           cudaStream_t stream) {
  if (d0 == 0 || d1 == 0) return 0;
  const dim3 grid((d1 + side - 1) / side, (d0 + side - 1) / side);
  accumulate_kernel<T, kBlockSparse><<<grid, kThreads, 0, stream>>>(
      vals, idx, init, out, n, k, d0, d1, symmetric, block, nblk, side);
  return static_cast<int>(cudaGetLastError());
}

// largest divisor of `block` that is at most kMaxSide
int square_side(int block) {
  for (int s = kMaxSide; s > 1; --s)
    if (block % s == 0) return s;
  return 1;
}

}  // namespace

extern "C" {

int scatter_accumulate_f32(const float* vals, const int* idx, const float* init,
                           float* out, int n, int k, int d0, int d1,
                           int symmetric, cudaStream_t stream) {
  return launch<float, false>(vals, idx, init, out, n, k, d0, d1, symmetric, 1,
                              1, kMaxSide, stream);
}

int scatter_accumulate_f64(const double* vals, const int* idx,
                           const double* init, double* out, int n, int k,
                           int d0, int d1, int symmetric, cudaStream_t stream) {
  return launch<double, false>(vals, idx, init, out, n, k, d0, d1, symmetric,
                               1, 1, kMaxSide, stream);
}

int block_scatter_accumulate_f32(const float* vals, const int* idx, float* out,
                                 int n, int nblk, int k, int block, int gn,
                                 cudaStream_t stream) {
  const int gm = nblk / gn;
  return launch<float, true>(vals, idx, nullptr, out, n, k, gm * block,
                             gn * block, 0, block, nblk, square_side(block),
                             stream);
}

int block_scatter_accumulate_f64(const double* vals, const int* idx,
                                 double* out, int n, int nblk, int k,
                                 int block, int gn, cudaStream_t stream) {
  const int gm = nblk / gn;
  return launch<double, true>(vals, idx, nullptr, out, n, k, gm * block,
                              gn * block, 0, block, nblk, square_side(block),
                              stream);
}

}  // extern "C"

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
// scatter_accumulate: the pairs are bucketed once, then each cell's
// bucket is summed in order; the work is O(n * k + d0 * d1). The
// entries (each pair, and its mirror when symmetric) carry their cell;
// the output's cells fall into regions of R = 2^log_r consecutive flat
// cells (so a (1, d1) row splits too), and dropped entries into a last
// region. A stable counting sort by region (digits of up to 11 bits of
// the region id, least significant first; one pass wherever the regions
// number under 2,048) puts each region's entries together in stream
// order. A pass is three launches: accum_count_kernel counts, per chunk
// of the entry stream (8 warps, each a segment of `seg` consecutive
// entries), the entries of each digit; accum_scan_kernel turns each
// digit's column of counts into its entries in earlier chunks, and its
// total; accum_place_kernel scans the totals into each digit's start,
// ranks each entry among its warp's entries of its digit (warp match,
// in stream order: groups of 32 in order, lanes in order), adds the
// earlier chunks' and warps' entries of the digit, and writes (cell,
// value) there. Then accum_sum_kernel gives each 2^log_sub cells of a
// region (up to a warp's 8 KB of shared memory) to one warp: its cells
// from `init` or 0, the region's bucket added 32 entries at a time (the
// entries of one cell in lane order, one round each; entries outside
// the warp's cells skipped), the cells written back with 16-byte
// stores, touched or not. A region's bucket is its digit's range (one
// pass) or, after several passes, found by a 32-way search of the
// sorted regions. The wrapper picks R, the digit width and `seg`
// (kernels/scatter_accum/ops.py `plan`), derives the rest of the plan
// and allocates the scratch; the launcher takes the plan as given and
// checks it. The counts are integers, and no value is ever added
// atomically.
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

#include <atomic>
#include <cstdint>

#include "common.cuh"

namespace {

constexpr unsigned kFull = 0xffffffffu;
constexpr int kMaxDevices = 64;

// Raise a kernel's dynamic shared-memory limit to `bytes`, once per
// kernel instantiation and device (the attribute call costs host time on
// every launch otherwise): `done` is that kernel's own static array of
// the largest limit set per device.
template <typename Kernel>
cudaError_t allow_smem(Kernel kernel, size_t bytes, std::atomic<int>* done) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  const int want = static_cast<int>(bytes);
  if (dev < kMaxDevices && done[dev].load(std::memory_order_relaxed) >= want)
    return cudaSuccess;
  err = cudaFuncSetAttribute(kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             want);
  if (err == cudaSuccess && dev < kMaxDevices)
    done[dev].store(want, std::memory_order_relaxed);
  return err;
}

// -- scatter_accumulate ---------------------------------------------------

constexpr int kChunkWarps = 8;                     // warps per chunk
constexpr int kChunkThreads = 32 * kChunkWarps;
constexpr int kMaxDigitBits = 11;
constexpr int kSumWarps = 4;                       // sum warps per block
constexpr int kSumWarpBytes = 8 * 1024;            // a sum warp's cells
constexpr unsigned kDropped = 0xffffffffu;         // an entry's dropped cell
constexpr int kGroups = 8;                         // 32-entry groups in flight
constexpr int kScanDigits = 128;                   // digits per scan block
constexpr int kSumGroups = 4;

struct Plan {
  int entries;      // n * k, twice that when symmetric
  int cells;        // d0 * d1
  int log_r;        // region of a cell: cell >> log_r
  int log_sub;      // a sum warp's share of a region: 2^log_sub cells
  int regions;      // ceil(cells / 2^log_r); id `regions` = dropped
  int digit_bits;   // of the region id, per pass
  int passes;
  int seg;          // entries per warp per chunk, a multiple of 32
  int chunks;       // ceil(entries / (kChunkWarps * seg))
};

// Where a pass reads its entries: pass 0 from the pairs (kFromPairs),
// later passes from the previous pass's (cell, value) arrays.
template <typename T>
struct Source {
  const T* vals;
  const int* idx;
  const unsigned* keys;
  int d0, d1, symmetric;
};

__device__ __forceinline__ unsigned region_of(unsigned key, const Plan& p) {
  return key == kDropped ? static_cast<unsigned>(p.regions) : key >> p.log_r;
}

// Entry e's cell (kDropped if it lands nowhere) and value. In stream
// order a symmetric pair q is entries 2q (the pair) and 2q + 1 (its
// mirror, which lands only off the diagonal and inside the matrix).
template <typename T, bool kFromPairs>
__device__ __forceinline__ void load_entry(const Source<T>& s, const Plan& p,
                                           int e, unsigned& key, T& v) {
  if (!kFromPairs) {
    key = s.keys[e];
    v = s.vals[e];
    return;
  }
  const int q = s.symmetric ? e >> 1 : e;
  const int id = s.idx[q];
  v = s.vals[q];
  key = kDropped;
  if (id < 0 || id >= p.cells) return;
  if (!(s.symmetric && (e & 1))) {
    key = static_cast<unsigned>(id);
    return;
  }
  const int r = id / s.d1, c = id - r * s.d1;
  if (r != c && c < s.d0 && r < s.d1)
    key = static_cast<unsigned>(c) * s.d1 + r;
}

// The digit of entries group g, u of a warp's segment (kFull past the
// stream): positions base + 32 (g + u) + lane.
template <typename T, bool kFromPairs>
__device__ __forceinline__ void load_group(const Source<T>& s, const Plan& p,
                                           long long base, int j, int lane,
                                           int shift, unsigned* digit,
                                           unsigned* key, T* v) {
  const unsigned mask = (1u << p.digit_bits) - 1u;
#pragma unroll
  for (int u = 0; u < kGroups; ++u) {
    const long long e = base + j + 32 * u + lane;
    digit[u] = kFull;
    key[u] = kDropped;
    v[u] = T(0);
    if (j + 32 * u < p.seg && e < p.entries) {
      load_entry<T, kFromPairs>(s, p, static_cast<int>(e), key[u], v[u]);
      digit[u] = (region_of(key[u], p) >> shift) & mask;
    }
  }
}

// Per chunk, the entries of each digit: counts[chunk][digit].
template <typename T, bool kFromPairs>
__global__ void __launch_bounds__(kChunkThreads)
accum_count_kernel(Source<T> s, Plan p, int shift, int* __restrict__ counts) {
  extern __shared__ int hist[];
  const int ndigit = 1 << p.digit_bits;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  for (int i = threadIdx.x; i < ndigit; i += kChunkThreads) hist[i] = 0;
  __syncthreads();
  const long long base =
      (static_cast<long long>(blockIdx.x) * kChunkWarps + warp) * p.seg;
  for (int j = 0; j < p.seg && base + j < p.entries; j += 32 * kGroups) {
    unsigned digit[kGroups], key[kGroups];
    T v[kGroups];
    load_group<T, kFromPairs>(s, p, base, j, lane, shift, digit, key, v);
#pragma unroll
    for (int u = 0; u < kGroups; ++u) {
      const unsigned peers = __match_any_sync(kFull, digit[u]);
      if (digit[u] != kFull && lane == __ffs(peers) - 1)
        atomicAdd(&hist[digit[u]], __popc(peers));
    }
  }
  __syncthreads();
  for (int i = threadIdx.x; i < ndigit; i += kChunkThreads)
    counts[static_cast<size_t>(blockIdx.x) * ndigit + i] = hist[i];
}

// Four (or, below 4 digits, one) counts of chunk c from digit d.
__device__ __forceinline__ int4 load_counts(const int* counts, int c, int d,
                                            int ndigit, int per) {
  const int* at = counts + static_cast<size_t>(c) * ndigit + d;
  return per == 4 ? *reinterpret_cast<const int4*>(at)
                  : make_int4(*at, 0, 0, 0);
}

// Per digit, counts[chunk][digit] -> the digit's entries in earlier
// chunks, and totals[digit]. A block takes kScanDigits digits; a thread
// 4 consecutive digits (16-byte loads) of one of up to 8 slices of the
// chunks, the slices combined in shared memory. ndigit is a power of 2.
__global__ void __launch_bounds__(256)
accum_scan_kernel(int* __restrict__ counts, int* __restrict__ totals,
                  int chunks, int ndigit) {
  __shared__ int part[4 * 256];                    // [digit][slice][quad]
  const int per = ndigit >= 4 ? 4 : 1;
  const int quads = min(ndigit, kScanDigits) / per;
  int slices = 1;
  while (slices < 8 && slices * 2 * quads <= 256) slices *= 2;
  const int t = threadIdx.x, q = t % quads, slice = t / quads;
  const bool active = slice < slices;
  const int per_slice = (chunks + slices - 1) / slices;
  const int c_lo = min(chunks, slice * per_slice);
  const int c_hi = min(chunks, c_lo + per_slice);
  const int d = (blockIdx.x * quads + q) * per;

  int tot[4] = {0, 0, 0, 0};
  for (int c0 = c_lo; active && c0 < c_hi; c0 += 8) {
    int4 x[8];
#pragma unroll
    for (int u = 0; u < 8; ++u)
      x[u] = c0 + u < c_hi ? load_counts(counts, c0 + u, d, ndigit, per)
                           : make_int4(0, 0, 0, 0);
#pragma unroll
    for (int u = 0; u < 8; ++u) {
      tot[0] += x[u].x;
      tot[1] += x[u].y;
      tot[2] += x[u].z;
      tot[3] += x[u].w;
    }
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) part[i * 256 + t] = tot[i];
  __syncthreads();
  if (!active) return;
  int run[4];
  for (int i = 0; i < per; ++i) {
    int earlier = 0, total = 0;
    for (int sl = 0; sl < slices; ++sl) {
      const int x = part[i * 256 + sl * quads + q];
      total += x;
      if (sl < slice) earlier += x;
    }
    run[i] = earlier;
    if (slice == 0) totals[d + i] = total;
  }
  for (int c0 = c_lo; c0 < c_hi; c0 += 8) {        // 8 loads, then 8 stores
    int4 x[8];
#pragma unroll
    for (int u = 0; u < 8; ++u)
      if (c0 + u < c_hi) x[u] = load_counts(counts, c0 + u, d, ndigit, per);
#pragma unroll
    for (int u = 0; u < 8; ++u) {
      if (c0 + u >= c_hi) break;
      int* dst = counts + static_cast<size_t>(c0 + u) * ndigit + d;
      if (per == 4) {
        *reinterpret_cast<int4*>(dst) =
            make_int4(run[0], run[1], run[2], run[3]);
        run[1] += x[u].y;
        run[2] += x[u].z;
        run[3] += x[u].w;
      } else {
        *dst = run[0];
      }
      run[0] += x[u].x;
    }
  }
}

// Each warp walks its segment in stream order; per group of 32, the
// lowest lane of each digit takes the group's entries of that digit
// from its warp's running count `mine[digit]`, and each entry gets
// that start plus its rank among lower lanes. With `kPlace` the entry
// is written there.
template <typename T, bool kFromPairs, bool kPlace>
__device__ __forceinline__ void walk_segment(const Source<T>& s, const Plan& p,
                                             long long base, int lane,
                                             int shift, int* mine,
                                             unsigned* keys_out, T* vals_out) {
  const unsigned below = (1u << lane) - 1u;
  for (int j = 0; j < p.seg && base + j < p.entries; j += 32 * kGroups) {
    unsigned digit[kGroups], key[kGroups];
    T v[kGroups];
    load_group<T, kFromPairs>(s, p, base, j, lane, shift, digit, key, v);
#pragma unroll
    for (int u = 0; u < kGroups; ++u) {
      const unsigned peers = __match_any_sync(kFull, digit[u]);
      const int leader = __ffs(peers) - 1;
      int start = 0;
      if (digit[u] != kFull && lane == leader) {
        start = mine[digit[u]];
        mine[digit[u]] = start + __popc(peers);
      }
      start = __shfl_sync(kFull, start, leader);
      if (kPlace && digit[u] != kFull) {
        const int at = start + __popc(peers & below);
        keys_out[at] = key[u];
        vals_out[at] = v[u];
      }
      __syncwarp();  // the next group's leaders read what these wrote
    }
  }
}

// One pass of the stable counting sort: every entry of the chunk to its
// place, stream order kept within each digit.
template <typename T, bool kFromPairs>
__global__ void __launch_bounds__(kChunkThreads)
accum_place_kernel(Source<T> s, Plan p, int shift,
                   const int* __restrict__ prefix,
                   const int* __restrict__ totals, int* __restrict__ starts,
                   unsigned* __restrict__ keys_out, T* __restrict__ vals_out) {
  extern __shared__ int table[];                   // [warp][digit], base
  __shared__ int buf[32];
  const int ndigit = 1 << p.digit_bits;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  for (int i = threadIdx.x; i < kChunkWarps * ndigit; i += kChunkThreads)
    table[i] = 0;
  // where each digit's entries start: the totals of the digits below it
  // (a thread scans up to 8 consecutive digits); block 0 hands them to
  // the sum kernel
  int* digit_base = table + kChunkWarps * ndigit;
  {
    const int span = (ndigit + kChunkThreads - 1) / kChunkThreads;  // <= 8
    const int first = threadIdx.x * span;
    int tot[8];
    int sum = 0;
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      tot[i] = i < span && first + i < ndigit ? totals[first + i] : 0;
      sum += tot[i];
    }
    int all;
    int run = repro::block_exclusive_scan(sum, &all, buf);
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      if (i < span && first + i < ndigit) {
        digit_base[first + i] = run;
        if (blockIdx.x == 0) starts[first + i] = run;
      }
      run += tot[i];
    }
  }
  __syncthreads();
  const long long base =
      (static_cast<long long>(blockIdx.x) * kChunkWarps + warp) * p.seg;
  int* mine = table + warp * ndigit;
  // 1. each warp's entries per digit
  walk_segment<T, kFromPairs, false>(s, p, base, lane, shift, mine, nullptr,
                                     nullptr);
  __syncthreads();
  // 2. where each warp's entries of a digit start: the digit's base, its
  // entries in earlier chunks, the earlier warps' counts
  for (int d = threadIdx.x; d < ndigit; d += kChunkThreads) {
    int run = digit_base[d] +
              prefix[static_cast<size_t>(blockIdx.x) * ndigit + d];
#pragma unroll
    for (int w = 0; w < kChunkWarps; ++w) {
      const int c = table[w * ndigit + d];
      table[w * ndigit + d] = run;
      run += c;
    }
  }
  __syncthreads();
  // 3. the same walk places each entry
  walk_segment<T, kFromPairs, true>(s, p, base, lane, shift, mine, keys_out,
                                    vals_out);
}

// First position in [0, entries) whose region is >= g (entries if
// none), by a 32-way search of the sorted keys; every lane gets it.
__device__ int bucket_start(const unsigned* keys, const Plan& p, unsigned g,
                            int lane) {
  int lo = 0, hi = p.entries;                      // the answer is in [lo, hi]
  while (lo < hi) {
    const int step = (hi - lo + 31) / 32;
    const int at = lo + lane * step;
    const bool less = at < hi && region_of(keys[at], p) < g;
    const int n = __popc(__ballot_sync(kFull, less));
    if (n == 0) return lo;
    hi = min(hi, lo + n * step);
    lo += (n - 1) * step + 1;
  }
  return lo;
}

// One warp per 2^log_sub cells of a region (all of it, or one share when
// the region is wider than a warp's shared memory): its cells from
// `init` (or 0), the entries of the region's bucket that land there
// added in stream order, all its cells written.
template <typename T>
__global__ void __launch_bounds__(32 * kSumWarps)
accum_sum_kernel(const unsigned* __restrict__ keys, const T* __restrict__ vals,
                 const int* __restrict__ starts, const T* __restrict__ init,
                 T* __restrict__ out, Plan p) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const long long sub = static_cast<long long>(blockIdx.x) * kSumWarps + warp;
  const int g = static_cast<int>(sub >> (p.log_r - p.log_sub));
  const long long first = sub << p.log_sub;
  if (first >= p.cells) return;                    // no block barrier below
  const int side = 1 << p.log_sub;
  T* acc = reinterpret_cast<T*>(smem) + static_cast<size_t>(warp) * side;
  const int ncell = static_cast<int>(min(static_cast<long long>(side),
                                         p.cells - first));
  int lo = 0, hi = 0;
  if (p.entries > 0) {
    if (starts != nullptr) {                       // one pass: the scan's
      lo = starts[g];
      hi = starts[g + 1];
    } else {
      lo = bucket_start(keys, p, g, lane);
      hi = bucket_start(keys, p, g + 1, lane);
    }
  }

  // the cells from init, or +0.0
  constexpr int kPer = 16 / static_cast<int>(sizeof(T));
  const bool vec = ((reinterpret_cast<uintptr_t>(out) |
                     reinterpret_cast<uintptr_t>(init)) & 15u) == 0;
  const int units = vec ? ncell / kPer : 0;
  uint4* acc4 = reinterpret_cast<uint4*>(acc);
  if (init != nullptr) {
    const uint4* src = reinterpret_cast<const uint4*>(init + first);
#pragma unroll 4
    for (int u = lane; u < units; u += 32) acc4[u] = src[u];
    for (int i = units * kPer + lane; i < ncell; i += 32)
      acc[i] = init[first + i];
  } else {
    for (int u = lane; u < units; u += 32) acc4[u] = make_uint4(0, 0, 0, 0);
    for (int i = units * kPer + lane; i < ncell; i += 32) acc[i] = T(0);
  }
  __syncwarp();

  // the bucket, kSumGroups groups of 32 loaded at a time; per group the
  // entries of one cell add in lane order, one round each
  const unsigned below = (1u << lane) - 1u;
  for (int b = lo; b < hi; b += 32 * kSumGroups) {
    int c[kSumGroups];
    T v[kSumGroups];
#pragma unroll
    for (int u = 0; u < kSumGroups; ++u) {
      const int e = b + 32 * u + lane;
      c[u] = -1;
      v[u] = T(0);
      if (e < hi) {
        const long long at = static_cast<long long>(keys[e]) - first;
        if (at >= 0 && at < ncell) {
          c[u] = static_cast<int>(at);
          v[u] = vals[e];
        }
      }
    }
#pragma unroll
    for (int u = 0; u < kSumGroups; ++u) {
      const unsigned peers = __match_any_sync(kFull, c[u]);
      const int rank = __popc(peers & below);
      const int last = __reduce_max_sync(kFull, c[u] >= 0 ? rank : 0);
      for (int r = 0; r <= last; ++r) {
        if (c[u] >= 0 && rank == r) acc[c[u]] += v[u];
        __syncwarp();
      }
    }
  }

  // every cell, 16 bytes a store where aligned
  uint4* dst = reinterpret_cast<uint4*>(out + first);
#pragma unroll 4
  for (int u = lane; u < units; u += 32) dst[u] = acc4[u];
  for (int i = units * kPer + lane; i < ncell; i += 32) out[first + i] = acc[i];
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

// A tile's rows in bands whose sums fit kAccBudget: the band count, the
// rows a band and the dynamic shared bytes of one block (the band's sums
// and a bitmap of its cells per chunk parity); nbands 0 when one row
// alone is over the budget.
struct Bands {
  int nbands, band_rows;
  size_t smem;
};

Bands band_plan(int block, size_t elem) {
  const long long row_bytes = static_cast<long long>(block) * elem;
  const long long max_rows = kAccBudget / row_bytes;
  if (max_rows < 1) return Bands{0, 0, 0};
  const int nbands = static_cast<int>((block + max_rows - 1) / max_rows);
  const int band_rows = (block + nbands - 1) / nbands;
  const int words = (band_rows * block + 31) / 32;
  return Bands{nbands, band_rows,
               static_cast<size_t>(band_rows) * row_bytes +
                   2 * static_cast<size_t>(words) * 4};
}

template <typename T>
int launch_block_scatter(const T* vals, const int* idx, T* out, int n,
                         int nblk, int k, int block, int gn,
                         cudaStream_t stream) {
  if (nblk <= 0 || block <= 0) return 0;
  if (gn <= 0 || nblk % gn != 0 || k < 0 || n < 0 ||
      static_cast<long long>(n) * k > 0x7fffffffLL)
    return static_cast<int>(cudaErrorInvalidValue);
  if (static_cast<long long>(block) * block > 0x7fffffffLL)
    return static_cast<int>(cudaErrorInvalidValue);
  const Bands bands = band_plan(block, sizeof(T));
  if (bands.nbands < 1) return static_cast<int>(cudaErrorInvalidValue);
  const int nbands = bands.nbands, band_rows = bands.band_rows;
  const long long ctas = static_cast<long long>(nblk) * nbands;
  if (ctas > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  const size_t smem = bands.smem;
  const bool vec = k % 4 == 0 && reinterpret_cast<uintptr_t>(vals) % 16 == 0 &&
                   reinterpret_cast<uintptr_t>(idx) % 16 == 0 &&
                   reinterpret_cast<uintptr_t>(out) % 16 == 0;
  auto kernel = vec ? block_scatter_kernel<T, true>
                    : block_scatter_kernel<T, false>;
  static std::atomic<int> done[2][kMaxDevices];
  const cudaError_t err = allow_smem(kernel, smem, done[vec ? 1 : 0]);
  if (err != cudaSuccess) return static_cast<int>(err);
  kernel<<<static_cast<unsigned>(ctas), kTileThreads, smem, stream>>>(
      vals, idx, out, n, nblk, k, block, gn, band_rows, nbands);
  return static_cast<int>(cudaGetLastError());
}

// Whether scratch array [at, at + bytes) lies in [base, base + size).
bool inside(const void* at, size_t bytes, const void* base, size_t size) {
  const uintptr_t a = reinterpret_cast<uintptr_t>(at);
  const uintptr_t b = reinterpret_cast<uintptr_t>(base);
  return bytes == 0 || (at != nullptr && a >= b && a - b <= size &&
                        bytes <= size - (a - b));
}

// The dynamic shared bytes of the count kernel (a histogram of the
// digits), the place kernel (one per warp and the block's bases) and the
// sum kernel (each warp's 2^log_sub cells).
size_t count_smem_bytes(int digit_bits) {
  return (size_t{1} << digit_bits) * sizeof(int);
}
size_t place_smem_bytes(int digit_bits) {
  return (kChunkWarps + 1) * count_smem_bytes(digit_bits);
}
size_t sum_smem_bytes(int log_sub, size_t elem) {
  return static_cast<size_t>(kSumWarps) * (elem << log_sub);
}

// The plan comes whole from the wrapper (ops.py `make_plan`); the
// launcher checks that it covers the matrix and the entries and that
// every array it writes lies in the scratch it is given.
template <typename T>
int launch_scatter(const T* vals, const int* idx, const T* init, T* out,
                   const void* scratch, size_t scratch_bytes, unsigned* keys0,
                   T* vals0, unsigned* keys1, T* vals1, int* counts,
                   int* totals, int* starts, int n, int k, int d0, int d1,
                   int symmetric, int log_r, int log_sub, int regions,
                   int digit_bits, int passes, int seg, int chunks,
                   cudaStream_t stream) {
  const int invalid = static_cast<int>(cudaErrorInvalidValue);
  if (n < 0 || k < 0 || d0 < 0 || d1 < 0) return invalid;
  if (d0 == 0 || d1 == 0) return 0;
  const long long cells = static_cast<long long>(d0) * d1;
  const long long entries =
      static_cast<long long>(n) * k * (symmetric ? 2 : 1);
  if (cells > 0x7fffffffLL || entries > 0x7fffffc0LL) return invalid;
  // regions of 2^log_r cells cover the matrix; ids 0..regions fit the
  // passes' digits; a sum warp's cells fit its shared memory; the chunks
  // cover the entries
  if (log_r < 0 || log_r > 30 || log_sub < 0 || log_sub > log_r ||
      (sizeof(T) << log_sub) > static_cast<size_t>(kSumWarpBytes) ||
      regions < 1 || (static_cast<long long>(regions) << log_r) < cells ||
      digit_bits < 1 || digit_bits > kMaxDigitBits || passes < 1 ||
      passes * digit_bits > 31 || (regions >> (passes * digit_bits)) != 0 ||
      seg < 32 || seg % 32 != 0 || chunks < 0 ||
      static_cast<long long>(chunks) * kChunkWarps * seg < entries)
    return invalid;
  const size_t ne = static_cast<size_t>(entries);
  const size_t ndigits = size_t{1} << digit_bits;
  const bool two = passes > 1;
  if (!inside(keys0, ne * 4, scratch, scratch_bytes) ||
      !inside(vals0, ne * sizeof(T), scratch, scratch_bytes) ||
      !inside(keys1, two ? ne * 4 : 0, scratch, scratch_bytes) ||
      !inside(vals1, two ? ne * sizeof(T) : 0, scratch, scratch_bytes) ||
      !inside(counts, static_cast<size_t>(chunks) * ndigits * 4, scratch,
              scratch_bytes) ||
      !inside(totals, ndigits * 4, scratch, scratch_bytes) ||
      !inside(starts, ndigits * 4, scratch, scratch_bytes) ||
      reinterpret_cast<uintptr_t>(counts) % 16 != 0)
    return invalid;
  Plan p;
  p.entries = static_cast<int>(entries);
  p.cells = static_cast<int>(cells);
  p.log_r = log_r;
  p.log_sub = log_sub;
  p.regions = regions;
  p.digit_bits = digit_bits;
  p.passes = passes;
  p.seg = seg;
  p.chunks = chunks;

  const int ndigit = 1 << digit_bits;
  const size_t count_smem = count_smem_bytes(digit_bits);
  const size_t place_smem = place_smem_bytes(digit_bits);
  const int scan_blocks = ndigit > kScanDigits ? ndigit / kScanDigits : 1;
  const size_t sum_smem = sum_smem_bytes(p.log_sub, sizeof(T));
  cudaError_t err;
  unsigned* keys_of[2] = {keys0, keys1};
  T* vals_of[2] = {vals0, vals1};
  if (entries > 0) {
    static std::atomic<int> place_done[2][kMaxDevices];
    if ((err = allow_smem(accum_place_kernel<T, true>, place_smem,
                          place_done[0])) != cudaSuccess ||
        (err = allow_smem(accum_place_kernel<T, false>, place_smem,
                          place_done[1])) != cudaSuccess)
      return static_cast<int>(err);
    for (int pass = 0; pass < p.passes; ++pass) {
      const int shift = pass * digit_bits;
      const int from = (pass - 1) & 1, to = pass & 1;
      if (pass == 0) {
        const Source<T> src{vals, idx, nullptr, d0, d1, symmetric};
        accum_count_kernel<T, true><<<p.chunks, kChunkThreads, count_smem,
                                      stream>>>(src, p, shift, counts);
        if ((err = cudaGetLastError()) != cudaSuccess)
          return static_cast<int>(err);
        accum_scan_kernel<<<scan_blocks, 256, 0, stream>>>(
            counts, totals, p.chunks, ndigit);
        if ((err = cudaGetLastError()) != cudaSuccess)
          return static_cast<int>(err);
        accum_place_kernel<T, true><<<p.chunks, kChunkThreads, place_smem,
                                      stream>>>(src, p, shift, counts, totals,
                                                starts, keys_of[to],
                                                vals_of[to]);
      } else {
        const Source<T> src{vals_of[from], nullptr, keys_of[from], d0, d1,
                            symmetric};
        accum_count_kernel<T, false><<<p.chunks, kChunkThreads, count_smem,
                                       stream>>>(src, p, shift, counts);
        if ((err = cudaGetLastError()) != cudaSuccess)
          return static_cast<int>(err);
        accum_scan_kernel<<<scan_blocks, 256, 0, stream>>>(
            counts, totals, p.chunks, ndigit);
        if ((err = cudaGetLastError()) != cudaSuccess)
          return static_cast<int>(err);
        accum_place_kernel<T, false><<<p.chunks, kChunkThreads, place_smem,
                                       stream>>>(src, p, shift, counts, totals,
                                                 starts, keys_of[to],
                                                 vals_of[to]);
      }
      if ((err = cudaGetLastError()) != cudaSuccess)
        return static_cast<int>(err);
    }
  }
  static std::atomic<int> sum_done[kMaxDevices];
  if ((err = allow_smem(accum_sum_kernel<T>, sum_smem, sum_done)) !=
      cudaSuccess)
    return static_cast<int>(err);
  const int last = (p.passes - 1) & 1;
  const int* bounds = entries > 0 && p.passes == 1 ? starts : nullptr;
  const long long warps = ((p.cells - 1LL) >> p.log_sub) + 1;
  const int blocks = static_cast<int>((warps + kSumWarps - 1) / kSumWarps);
  accum_sum_kernel<T><<<blocks, 32 * kSumWarps, sum_smem, stream>>>(
      keys_of[last], vals_of[last], bounds, init, out, p);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// keys0/vals0 (and keys1/vals1 when the sort takes several passes) hold
// `entries` (cell, value) pairs each, counts chunks * 2^digit_bits ints,
// totals and starts 2^digit_bits ints each, all within the
// `scratch_bytes` at `scratch`: the wrapper allocates them and gives the
// plan's fields (ops.py `make_plan`).
#define REPRO_SCATTER_ENTRY(NAME, T)                                         \
  int NAME(const T* vals, const int* idx, const T* init, T* out,             \
           const void* scratch, size_t scratch_bytes, unsigned* keys0,       \
           T* vals0, unsigned* keys1, T* vals1, int* counts, int* totals,    \
           int* starts, int n, int k, int d0, int d1, int symmetric,         \
           int log_r, int log_sub, int regions, int digit_bits, int passes,  \
           int seg, int chunks, cudaStream_t stream) {                       \
    return launch_scatter(vals, idx, init, out, scratch, scratch_bytes,      \
                          keys0, vals0, keys1, vals1, counts, totals, starts, \
                          n, k, d0, d1, symmetric, log_r, log_sub, regions,  \
                          digit_bits, passes, seg, chunks, stream);          \
  }

REPRO_SCATTER_ENTRY(scatter_accumulate_f32, float)
REPRO_SCATTER_ENTRY(scatter_accumulate_f64, double)
#undef REPRO_SCATTER_ENTRY

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

// Kernel `which` (kernels/resources.py KERNELS["scatter_accum"] order:
// accum_count_kernel<T, kFromPairs>, accum_scan_kernel,
// accum_place_kernel<T, kFromPairs>, accum_sum_kernel<T>,
// block_scatter_kernel<T, kVec>; T float before double, true before
// false) with args[0] = digit_bits (count, place), log_sub (sum) or block
// (block_scatter).
int scatter_accum_launch_query(int which, const long long* args,
                               long long* out) {
  const void* fns[] = {
      reinterpret_cast<const void*>(&accum_count_kernel<float, true>),
      reinterpret_cast<const void*>(&accum_count_kernel<float, false>),
      reinterpret_cast<const void*>(&accum_count_kernel<double, true>),
      reinterpret_cast<const void*>(&accum_count_kernel<double, false>),
      reinterpret_cast<const void*>(&accum_scan_kernel),
      reinterpret_cast<const void*>(&accum_place_kernel<float, true>),
      reinterpret_cast<const void*>(&accum_place_kernel<float, false>),
      reinterpret_cast<const void*>(&accum_place_kernel<double, true>),
      reinterpret_cast<const void*>(&accum_place_kernel<double, false>),
      reinterpret_cast<const void*>(&accum_sum_kernel<float>),
      reinterpret_cast<const void*>(&accum_sum_kernel<double>),
      reinterpret_cast<const void*>(&block_scatter_kernel<float, true>),
      reinterpret_cast<const void*>(&block_scatter_kernel<float, false>),
      reinterpret_cast<const void*>(&block_scatter_kernel<double, true>),
      reinterpret_cast<const void*>(&block_scatter_kernel<double, false>)};
  const int invalid = static_cast<int>(cudaErrorInvalidValue);
  const long long a = args[0];
  if (which < 0 || which >= 15 ||
      (which >= 11 ? a < 1 || a > 65535 : a < 0 || a > 30))
    return invalid;
  int threads = kChunkThreads;
  size_t dynamic = 0;
  if (which < 4) {
    dynamic = count_smem_bytes(static_cast<int>(a));
  } else if (which == 4) {
    threads = 256;
  } else if (which < 9) {
    dynamic = place_smem_bytes(static_cast<int>(a));
  } else if (which < 11) {
    threads = 32 * kSumWarps;
    dynamic = sum_smem_bytes(static_cast<int>(a),
                             which == 9 ? sizeof(float) : sizeof(double));
  } else {
    threads = kTileThreads;
    const Bands bands = band_plan(
        static_cast<int>(a), which < 13 ? sizeof(float) : sizeof(double));
    if (bands.nbands < 1) return invalid;
    dynamic = bands.smem;
  }
  return repro::query_kernel(fns[which], threads,
                             static_cast<long long>(dynamic), out);
}

}  // extern "C"

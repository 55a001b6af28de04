// Block-local Top-K per (block x block) tile, three ways:
//
//   diff_topk_payload   the fused FedNL uplink: the tile of D = a - b, its
//                       k largest-magnitude entries as a (value, in-tile
//                       flat index) payload, and the tile's ||D||_F^2;
//   block_topk_payload  the same payload of x itself (no second operand,
//                       no norm);
//   block_topk          the dense masked tile: x where |x| >= hi, else 0.
//
// Replaces the TPU kernels of src/repro/kernels/block_topk/kernel.py:
// diff_topk_payload_kernel (_diff_topk_payload_tile_kernel),
// block_topk_payload_kernel (_topk_payload_tile_kernel) — both through
// _emit_topk_payload / _bisect_bracket — and block_topk_kernel
// (_topk_tile_kernel). Their selection is kept exactly:
//   * |x| is rounded to f32 and the k-th magnitude is bracketed by 32
//     rounds of bisection on [0, max|x|]: mid = 0.5f * (lo + hi), then
//     lo = mid if count(|x| >= mid) > k, else hi = mid; the bracket
//     satisfies count(|x| >= hi) <= k <= count(|x| >= lo);
//   * a payload keeps exactly k entries: every entry with |x| >= hi, then
//     the ties lo <= |x| < hi, each group in flat order, stopping at k;
//     unfilled slots carry value 0 and index -1; with k >= block^2 the
//     whole tile is kept in flat order (unless `bisect_all` asks for the
//     bisection anyway, which is BlockTopKThreshold's order: survivors
//     above the bracket first, then the rest);
//   * the dense variant keeps |x| >= hi only, so fewer than k entries
//     survive inside a tie cluster; with k >= block^2 it copies x.
// Entries past the matrix edge count as x = 0 at their in-tile flat
// index, as on the TPU, where the wrapper zero-padded the inputs; here
// the ragged edge is masked in the kernel instead of padded in a copy.
//
// The bisection needs no pass over the tile per round. count(|x| >= mid)
// > k holds exactly when mid <= v, where v is the (k+1)-th largest
// non-NaN magnitude of the tile (with multiplicity; a NaN never counts).
// So the kernel finds v once, by a radix select on the magnitudes' f32
// bit patterns (sign bit masked, so -0.0 is 0; NaN patterns excluded;
// for non-negative floats the pattern order is the value order), and then
// runs the 32 rounds on scalars with the same f32 arithmetic. With fewer
// than k + 1 non-NaN entries (k >= block^2 among them) no round moves lo.
//
// Bound on the H100: bytes. Each kernel reads its inputs once and
// writes the payload (k values + k indices per tile) or the dense tile.
// The dense difference of the fused variant is never written to device
// memory. `b` may be shared by every silo (silo stride 0, a kernel of its
// own so that the stacked case keeps one offset for a and b): FedNL's
// curvature learner diffs n silo observations against one H.
//
// Design: one thread block of 512 threads per (silo, tile), the grid
// tile-major (the n silos of one tile are neighbours in launch order, so
// a shared b tile is fetched from device memory once and read from L2 by
// the others). The tile stays in registers: thread t holds the 4
// consecutive entries 2048 i + 4 t .. + 3 of each stripe i (at most 8
// stripes, 32 entries, at block 128), 16 bytes wide where the row length
// allows, as x (or a - b) in the input type; magnitudes are recomputed
// from it. The radix select takes three digit passes (11, 10 and 10
// bits): pass 1 counts every entry into a shared-memory histogram (int
// atomics; NaN into a bin of its own), and a block-wide suffix count
// picks the digit that holds v. The entries of that digit are gathered
// into a shared list (one atomic per warp places a warp's), counted by
// their next 10 bits on the way, and pass 3 runs over the list (the
// whole tile, at worst, in a tie cluster). For the compaction, warp w's
// entries of stripe i are the 128 consecutive flat entries of chunk
// 16 i + w: per chunk a warp scan counts strict and tie entries (two
// stripes a scan), one warp scans the chunk totals, and each kept entry
// computes its slot without a branch. The payload is staged in shared
// memory (over the histograms) and written out as contiguous (value,
// index) runs in 16-byte stores. On the embedding's tiles the block is
// bound by instruction issue, not by memory (one block per SM, about a
// hundred registers a thread): copying the next tile into shared memory
// while one is selected did not pay for its own issue cost.

#include <cuda_runtime.h>

#include <cstdint>
#include <initializer_list>

#include "common.cuh"

namespace {

constexpr int kThreads = 512;
constexpr int kWarps = kThreads / 32;
constexpr int kVec = 4;                          // a thread's per stripe
constexpr int kStripe = kVec * kThreads;         // 2048
constexpr int kMaxTile = 16384;                  // block <= 128
constexpr int kMaxStripes = kMaxTile / kStripe;  // 8
constexpr int kChunk = 32 * kVec;                // a warp's entries per stripe
constexpr int kMaxChunks = kMaxTile / kChunk;    // 128
constexpr int kBisectRounds = 32;
// radix passes over the 31-bit keys: bits 30..20, 19..10, 9..0
constexpr int kBins0 = 2048, kBins1 = 1024;
constexpr unsigned kInfKey = 0x7f800000u;        // keys above it are NaN
// the digit's entries that passes 2 and 3 gather: up to the whole tile
constexpr int kCand = kMaxTile;
// pass 1's histogram has one more bin, for NaN (counted, never picked)
constexpr int kHist0 = kBins0 + 4;
constexpr size_t kSelectBytes = (kHist0 + kBins1 + kCand) * sizeof(int);

enum Mode { kDiffPayload = 0, kPayload = 1, kDense = 2 };

// |x| rounded to f32. The sign of a zero changes no comparison, max or
// key below, so fabs serves (and folds into the f32 instructions).
__device__ __forceinline__ float magnitude(float x) { return fabsf(x); }
__device__ __forceinline__ float magnitude(double x) {
  return static_cast<float>(fabs(x));
}

// The order key of |x|: its f32 bit pattern without the sign bit
__device__ __forceinline__ unsigned key_of(float x) {
  return __float_as_uint(x) & 0x7fffffffu;
}
__device__ __forceinline__ unsigned key_of(double x) {
  return __float_as_uint(magnitude(x)) & 0x7fffffffu;
}

// 4 consecutive T at p (16-byte aligned)
template <typename T>
__device__ __forceinline__ void load4(const T* __restrict__ p, T (&x)[kVec]) {
  if (sizeof(T) == 4) {
    const float4 v = *reinterpret_cast<const float4*>(p);
    x[0] = static_cast<T>(v.x); x[1] = static_cast<T>(v.y);
    x[2] = static_cast<T>(v.z); x[3] = static_cast<T>(v.w);
  } else {
    const double2 u = reinterpret_cast<const double2*>(p)[0];
    const double2 v = reinterpret_cast<const double2*>(p)[1];
    x[0] = static_cast<T>(u.x); x[1] = static_cast<T>(u.y);
    x[2] = static_cast<T>(v.x); x[3] = static_cast<T>(v.y);
  }
}

template <typename T>
__device__ __forceinline__ void store4(T* __restrict__ p, const T (&x)[kVec]) {
  if (sizeof(T) == 4) {
    *reinterpret_cast<float4*>(p) = make_float4(
        static_cast<float>(x[0]), static_cast<float>(x[1]),
        static_cast<float>(x[2]), static_cast<float>(x[3]));
  } else {
    reinterpret_cast<double2*>(p)[0] = make_double2(x[0], x[1]);
    reinterpret_cast<double2*>(p)[1] = make_double2(x[2], x[3]);
  }
}

// The digit of one radix pass, from its histogram (nbins zeroed ints,
// filled by the caller before this call): the digit that holds the entry
// of rank *rank (0 = the largest) among the counted ones; *rank becomes
// its rank within that digit. Returns false (in every thread) if fewer
// than *rank + 1 entries were counted. Three barriers: after the
// histogram, after the warps' sums, after the pick.
__device__ __forceinline__ bool pick_digit(int nbins, const int* hist,
                                           int* digit, int* rank, int* red_i,
                                           int* pick) {
  __syncthreads();
  // thread t owns bins nbins - 1 - (per t + j): the largest digits first
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int per = nbins / kThreads;
  int h[kBins0 / kThreads];
  int local = 0;
#pragma unroll
  for (int j = 0; j < kBins0 / kThreads; ++j) {
    h[j] = j < per ? hist[nbins - 1 - (per * static_cast<int>(threadIdx.x) + j)]
                   : 0;
    local += h[j];
  }
  int incl = local;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const int y = __shfl_up_sync(0xffffffffu, incl, o);
    if (lane >= o) incl += y;
  }
  if (lane == 31) red_i[warp] = incl;
  __syncthreads();
  // every warp scans the warps' sums itself
  const int wsum = lane < kWarps ? red_i[lane] : 0;
  int wincl = wsum;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const int y = __shfl_up_sync(0xffffffffu, wincl, o);
    if (lane >= o) wincl += y;
  }
  const int total = __shfl_sync(0xffffffffu, wincl, kWarps - 1);
  int above = __shfl_sync(0xffffffffu, wincl - wsum, warp) + incl - local;
  if (total <= *rank) return false;  // total is the same in every thread
#pragma unroll
  for (int j = 0; j < kBins0 / kThreads; ++j) {
    if (j < per && above <= *rank && *rank < above + h[j]) {
      pick[0] = nbins - 1 - (per * static_cast<int>(threadIdx.x) + j);
      pick[1] = *rank - above;
    }
    above += h[j];
  }
  __syncthreads();
  *digit = pick[0];
  *rank = pick[1];
  return true;
}

// One (silo, tile): the body every variant shares, inlined into each.
// kSharedB: one b for every silo (read in place), else b is stacked like a.
// kVecIO: block, N and the pointers allow 16-byte loads and stores of the
// tile's rows.
template <typename T, int kMode, bool kSharedB, bool kVecIO>
__device__ __forceinline__ void select_tile(
    const T* __restrict__ a, const T* __restrict__ b,
    T* __restrict__ vals, int* __restrict__ idx, T* __restrict__ sq,
    T* __restrict__ dense, int n, int M, int N, int block, int gn, int nblk,
    int k, bool bisect_all, unsigned char* smem) {
  __shared__ T red_t[kWarps];
  __shared__ float red_f[kWarps];
  __shared__ int red_i[32];
  __shared__ int pick[2];
  __shared__ int chunk_off[kMaxChunks];
  __shared__ int totals[2];
  __shared__ int n_cand;

  const int bb = block * block;
  const int t = blockIdx.x / n;                  // tile-major grid
  const int silo = blockIdx.x - t * n;
  const int out_tile = silo * nblk + t;          // silo-major outputs
  const int r0 = (t / gn) * block, c0 = (t % gn) * block;
  const size_t plane = static_cast<size_t>(M) * N;
  const T* as = a + silo * plane;
  const T* bs = kMode != kDiffPayload ? nullptr
                : kSharedB ? b : b + silo * plane;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int e_first = kVec * static_cast<int>(threadIdx.x);
  int* hist0 = reinterpret_cast<int*>(smem);
  int* hist1 = hist0 + kHist0;
  unsigned* cand = reinterpret_cast<unsigned*>(hist1 + kBins1);
  for (int i = threadIdx.x; i < kHist0 + kBins1; i += kThreads) hist0[i] = 0;
  if (threadIdx.x == 0) n_cand = 0;

  // 1. the tile into registers: x (or a - b), 0 past the matrix edge.
  // In f32 every load is issued before any is used; in f64, which needs
  // twice the registers, a stripe's b is subtracted as it arrives.
  // Stripe i starts dr rows and dc columns after stripe i - 1.
  T x[kMaxStripes][kVec];
  {
    constexpr bool kLoadsFirst = sizeof(T) == 4;
    T y[kLoadsFirst ? kMaxStripes : 1][kVec];
    const int dr = kStripe / block, dc = kStripe - dr * block;
    int r = e_first / block, c = e_first - r * block;
#pragma unroll
    for (int i = 0; i < kMaxStripes; ++i) {
      const int e0 = i * kStripe + e_first;
      T (&yi)[kVec] = y[kLoadsFirst ? i : 0];
#pragma unroll
      for (int j = 0; j < kVec; ++j) x[i][j] = yi[j] = T(0);
      if (kVecIO) {
        // bb % 16 == 0: a stripe's 4 entries lie in one row, all or none
        // inside the tile and inside the matrix
        if (e0 < bb && r0 + r < M && c0 + c < N) {
          const size_t o = static_cast<size_t>(r0 + r) * N + c0 + c;
          load4(as + o, x[i]);
          if (kMode == kDiffPayload) load4(bs + o, yi);
        }
      } else {
#pragma unroll
        for (int j = 0; j < kVec; ++j) {
          const int e = e0 + j;
          const int rr = e / block, cc = e - rr * block;
          if (e < bb && r0 + rr < M && c0 + cc < N) {
            const size_t o = static_cast<size_t>(r0 + rr) * N + c0 + cc;
            x[i][j] = as[o];
            if (kMode == kDiffPayload) yi[j] = bs[o];
          }
        }
      }
      if constexpr (kMode == kDiffPayload && !kLoadsFirst) {
#pragma unroll
        for (int j = 0; j < kVec; ++j) x[i][j] = x[i][j] - yi[j];
      }
      r += dr;
      c += dc;
      if (c >= block) { c -= block; ++r; }
    }
    if constexpr (kMode == kDiffPayload && kLoadsFirst) {
#pragma unroll
      for (int i = 0; i < kMaxStripes; ++i)
#pragma unroll
        for (int j = 0; j < kVec; ++j) x[i][j] = x[i][j] - y[i][j];
    }
  }
  T part = T(0);
  float mx = 0.0f;
#pragma unroll
  for (int i = 0; i < kMaxStripes; ++i)
#pragma unroll
    for (int j = 0; j < kVec; ++j) {
      if (kMode == kDiffPayload) part += x[i][j] * x[i][j];
      mx = fmaxf(mx, magnitude(x[i][j]));
    }
  // tile max (fmaxf drops NaN) and, for the fused variant, ||D||^2
  mx = repro::warp_max(mx);
  if (kMode == kDiffPayload) part = repro::warp_sum(part);
  if (lane == 0) {
    red_f[warp] = mx;
    if (kMode == kDiffPayload) red_t[warp] = part;
  }
  __syncthreads();
  float amax = 0.0f;
#pragma unroll
  for (int w = 0; w < kWarps; ++w) amax = fmaxf(amax, red_f[w]);
  if (kMode == kDiffPayload && threadIdx.x == 0) {
    T total_sq = T(0);
    for (int w = 0; w < kWarps; ++w) total_sq += red_t[w];
    sq[out_tile] = total_sq;
  }

  // 2. the bracket: v by radix select, then 32 rounds on scalars. From
  // here on an entry past block^2 holds NaN: no select, max or bracket
  // counts it, and no payload keeps it (except under keep_all)
  const bool keep_all = k >= bb && !bisect_all;
#pragma unroll
  for (int i = 0; i < kMaxStripes; ++i)
#pragma unroll
    for (int j = 0; j < kVec; ++j)        // bb % 16 == 0 under kVecIO
      if (i * kStripe + e_first + (kVecIO ? 0 : j) >= bb) x[i][j] = T(NAN);
  float lo = 0.0f, hi = amax;
  if (!keep_all) {
    bool found = false;
    unsigned v_key = 0u;
    if (k < bb) {
      // pass 1 over every entry: bits 30..20 (a NaN into bin kBins0)
#pragma unroll
      for (int i = 0; i < kMaxStripes; ++i) {
        if (i * kStripe + e_first >= bb) continue;
#pragma unroll
        for (int j = 0; j < kVec; ++j) {
          const unsigned kk = key_of(x[i][j]);
          atomicAdd(&hist0[kk <= kInfKey ? kk >> 20 : kBins0], 1);
        }
      }
      int d, rank = k;
      found = pick_digit(kBins0, hist0, &d, &rank, red_i, pick);
      if (found) {
        const unsigned top = static_cast<unsigned>(d);
        // hist0 is read: clear it for the third pass (the second pass's
        // first barrier orders this before that pass's adds)
        for (int i = threadIdx.x; i < kBins0; i += kThreads) hist0[i] = 0;
        // the digit's entries, gathered (one atomic per warp) and
        // counted into pass 2's histogram (bits 19..10); pass 3 runs
        // over them (pass 2's barriers order the gather before it)
        unsigned in = 0u;
#pragma unroll
        for (int i = 0; i < kMaxStripes; ++i)
#pragma unroll
          for (int j = 0; j < kVec; ++j) {
            const unsigned kk = key_of(x[i][j]);
            if (kk <= kInfKey && (kk >> 20) == top) {
              in |= 1u << (kVec * i + j);
              atomicAdd(&hist1[(kk >> 10) & (kBins1 - 1)], 1);
            }
          }
        const int mine = __popc(in);
        int incl = mine;
#pragma unroll
        for (int o = 1; o < 32; o <<= 1) {
          const int y = __shfl_up_sync(0xffffffffu, incl, o);
          if (lane >= o) incl += y;
        }
        int base = 0;
        if (lane == 31 && incl) base = atomicAdd(&n_cand, incl);
        base = __shfl_sync(0xffffffffu, base, 31) + incl - mine;
#pragma unroll
        for (int i = 0; i < kMaxStripes; ++i)
#pragma unroll
          for (int j = 0; j < kVec; ++j)
            if ((in >> (kVec * i + j)) & 1u) cand[base++] = key_of(x[i][j]);
        pick_digit(kBins1, hist1, &d, &rank, red_i, pick);
        const unsigned mid = (top << 10) | static_cast<unsigned>(d);
        for (int c = threadIdx.x; c < n_cand; c += kThreads)
          if ((cand[c] >> 10) == mid)
            atomicAdd(&hist0[cand[c] & (kBins1 - 1)], 1);
        pick_digit(kBins1, hist0, &d, &rank, red_i, pick);
        v_key = (mid << 10) | static_cast<unsigned>(d);
      }
    }
    const float v = __uint_as_float(v_key);
    for (int it = 0; it < kBisectRounds; ++it) {
      const float m = 0.5f * (lo + hi);
      if (found && m <= v) lo = m; else hi = m;
    }
  }

  if (kMode == kDense) {
    // x where |x| >= hi (everything when k covers the tile), else 0
    T* out = dense + silo * plane;
    const int dr = kStripe / block, dc = kStripe - dr * block;
    int r = e_first / block, c = e_first - r * block;
#pragma unroll
    for (int i = 0; i < kMaxStripes; ++i) {
      const int e0 = i * kStripe + e_first;
      T y[kVec];
#pragma unroll
      for (int j = 0; j < kVec; ++j)
        y[j] = (keep_all || magnitude(x[i][j]) >= hi) ? x[i][j] : T(0);
      if (kVecIO) {
        if (e0 < bb && r0 + r < M && c0 + c < N)
          store4(out + static_cast<size_t>(r0 + r) * N + c0 + c, y);
      } else {
#pragma unroll
        for (int j = 0; j < kVec; ++j) {
          const int e = e0 + j;
          const int rr = e / block, cc = e - rr * block;
          if (e < bb && r0 + rr < M && c0 + cc < N)
            out[static_cast<size_t>(r0 + rr) * N + c0 + cc] = y[j];
        }
      }
      r += dr;
      c += dc;
      if (c >= block) { c -= block; ++r; }
    }
    return;
  }

  // 3. flat-order compaction: strict entries, then ties, each in flat
  // order. Chunk q = 16 i + w is warp w's 128 entries of stripe i; per
  // chunk, each lane's count of strict (high 16 bits) and tie entries
  unsigned strict = 0u, tie = 0u;      // bit 4 i + j
  int lane_off[kMaxStripes];
#pragma unroll
  for (int i = 0; i < kMaxStripes; i += 2) {
    // stripes i and i + 1 in one scan: 8-bit counts (a chunk holds 128)
    int c = 0;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      unsigned s4 = 0u, t4 = 0u;
#pragma unroll
      for (int j = 0; j < kVec; ++j) {
        const float f = magnitude(x[i + h][j]);
        if (keep_all ? (i + h) * kStripe + e_first + j < bb : f >= hi)
          s4 |= 1u << j;
        else if (!keep_all && f >= lo)
          t4 |= 1u << j;
      }
      strict |= s4 << (kVec * (i + h));
      tie |= t4 << (kVec * (i + h));
      c |= ((__popc(s4) << 8) | __popc(t4)) << (16 * h);
    }
    int incl = c;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const int y = __shfl_up_sync(0xffffffffu, incl, o);
      if (lane >= o) incl += y;
    }
    // stripe i + h's (strict << 16) | ties, from the packed counts
    auto unpack = [](int packed, int h) {
      return (((packed >> (16 * h + 8)) & 0xff) << 16) |
             ((packed >> (16 * h)) & 0xff);
    };
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      lane_off[i + h] = unpack(incl - c, h);
      const int q = (i + h) * kWarps + warp;
      if (lane == 31 && q * kChunk < bb) chunk_off[q] = unpack(incl, h);
    }
  }
  __syncthreads();
  const int nchunks = (bb + kChunk - 1) / kChunk;
  if (warp == 0) {
    // exclusive scan of the chunk totals, 4 chunks a lane
    int c[kMaxChunks / 32];
    int local = 0;
#pragma unroll
    for (int j = 0; j < kMaxChunks / 32; ++j) {
      const int q = lane * (kMaxChunks / 32) + j;
      c[j] = q < nchunks ? chunk_off[q] : 0;
      local += c[j];
    }
    int incl = local;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const int y = __shfl_up_sync(0xffffffffu, incl, o);
      if (lane >= o) incl += y;
    }
    int run = incl - local;
#pragma unroll
    for (int j = 0; j < kMaxChunks / 32; ++j) {
      const int q = lane * (kMaxChunks / 32) + j;
      if (q < nchunks) chunk_off[q] = run;
      run += c[j];
    }
    if (lane == 31) {
      totals[0] = incl >> 16;          // strict entries
      totals[1] = incl & 0xffff;       // ties
    }
  }
  __syncthreads();
  const int strict_total = totals[0], tie_total = totals[1];
  const int filled = min(k, strict_total + tie_total);

  // stage the payload (values, then indices, k of each) over the
  // histograms: an entry's slot is its group's start plus the group's
  // entries before it
  T* s_val = reinterpret_cast<T*>(smem);
  int* s_idx =
      reinterpret_cast<int*>(smem + static_cast<size_t>(k) * sizeof(T));
#pragma unroll
  for (int i = 0; i < kMaxStripes; ++i) {
    const int q = i * kWarps + warp;
    if (q >= nchunks) continue;
    const int off = chunk_off[q] + lane_off[i];
    const int s_base = off >> 16, t_base = strict_total + (off & 0xffff);
    const unsigned s4 = (strict >> (kVec * i)) & 15u;
    const unsigned t4 = (tie >> (kVec * i)) & 15u;
#pragma unroll
    for (int j = 0; j < kVec; ++j) {
      // branch-free: the slot in either group, or k (none)
      const unsigned below = (1u << j) - 1u;
      const int s_pos = s_base + __popc(s4 & below);
      const int t_pos = t_base + __popc(t4 & below);
      int pos = (t4 >> j) & 1u ? t_pos : k;
      pos = (s4 >> j) & 1u ? s_pos : pos;
      if (pos < k) {
        s_val[pos] = x[i][j];
        s_idx[pos] = i * kStripe + e_first + j;
      }
    }
  }
  for (int p = filled + threadIdx.x; p < k; p += kThreads) {
    s_val[p] = T(0);
    s_idx[p] = -1;
  }
  __syncthreads();

  // 4. the (value, index) runs of this (silo, tile), 16 bytes a store
  // (size_t row offsets: n * tiles * k exceeds 2^31 at LLM widths)
  T* vrow = vals + static_cast<size_t>(out_tile) * k;
  int* irow = idx + static_cast<size_t>(out_tile) * k;
  if (kVecIO && k % 4 == 0) {
    const int vu = k * static_cast<int>(sizeof(T)) / 16, iu = k / 4;
    for (int u = threadIdx.x; u < vu + iu; u += kThreads) {
      if (u < vu)
        reinterpret_cast<uint4*>(vrow)[u] =
            reinterpret_cast<const uint4*>(s_val)[u];
      else
        reinterpret_cast<uint4*>(irow)[u - vu] =
            reinterpret_cast<const uint4*>(s_idx)[u - vu];
    }
  } else {
    for (int p = threadIdx.x; p < k; p += kThreads) {
      vrow[p] = s_val[p];
      irow[p] = s_idx[p];
    }
  }
}

template <typename T, bool kSharedB, bool kVecIO>
__global__ void __launch_bounds__(kThreads)
diff_topk_payload_kernel(const T* __restrict__ a, const T* __restrict__ b,
                         T* __restrict__ vals, int* __restrict__ idx,
                         T* __restrict__ sq, int n, int M, int N, int block,
                         int gn, int nblk, int k) {
  extern __shared__ __align__(16) unsigned char smem[];
  select_tile<T, kDiffPayload, kSharedB, kVecIO>(
      a, b, vals, idx, sq, nullptr, n, M, N, block, gn, nblk, k, false, smem);
}

template <typename T, bool kVecIO>
__global__ void __launch_bounds__(kThreads)
block_topk_payload_kernel(const T* __restrict__ x, T* __restrict__ vals,
                          int* __restrict__ idx, int n, int M, int N,
                          int block, int gn, int nblk, int k, int bisect_all) {
  extern __shared__ __align__(16) unsigned char smem[];
  select_tile<T, kPayload, false, kVecIO>(x, nullptr, vals, idx, nullptr,
                                          nullptr, n, M, N, block, gn, nblk, k,
                                          bisect_all != 0, smem);
}

template <typename T, bool kVecIO>
__global__ void __launch_bounds__(kThreads)
block_topk_dense_kernel(const T* __restrict__ x, T* __restrict__ out, int n,
                        int M, int N, int block, int gn, int nblk, int k) {
  extern __shared__ __align__(16) unsigned char smem[];
  select_tile<T, kDense, false, kVecIO>(x, nullptr, nullptr, nullptr, nullptr,
                                        out, n, M, N, block, gn, nblk, k,
                                        false, smem);
}

// Grid and shared memory of one launch: one block per (tile, silo).
struct Launch {
  int gn, nblk;
  unsigned blocks;
  bool vec;
  size_t smem;
  int err;
};

// The dynamic shared memory of one launch: the histograms and
// candidates, then (in the same space) the payload of k entries.
size_t select_smem(int k, size_t elem) {
  const size_t payload = static_cast<size_t>(k) * (elem + sizeof(int));
  return payload > kSelectBytes ? payload : kSelectBytes;
}

Launch plan(int n, int M, int N, int block, int k, size_t elem,
            std::initializer_list<const void*> ptrs) {
  Launch l{0, 0, 0, false, 0, 0};
  if (block <= 0 || block * block > kMaxTile || k < 0 || n < 0) {
    l.err = static_cast<int>(cudaErrorInvalidValue);
    return l;
  }
  const int gm = (M + block - 1) / block;
  l.gn = (N + block - 1) / block;
  l.nblk = gm * l.gn;
  const long long blocks = static_cast<long long>(n) * l.nblk;
  if (blocks > 0x7fffffffLL) {
    l.err = static_cast<int>(cudaErrorInvalidValue);
    return l;
  }
  l.blocks = static_cast<unsigned>(blocks);
  // 16-byte rows: 4 entries of a tile row never straddle the ragged edge
  // or a row, and every 4th entry of a row is 16-byte aligned
  l.vec = block % kVec == 0 && N % kVec == 0;
  for (const void* p : ptrs)
    if (p != nullptr && reinterpret_cast<uintptr_t>(p) % 16 != 0) l.vec = false;
  l.smem = select_smem(k, elem);
  return l;
}

template <typename Kernel, typename... Args>
int launch(Kernel kernel, const Launch& l, cudaStream_t stream,
           Args... args) {
  if (l.err || l.blocks == 0) return l.err;
  const int err = static_cast<int>(cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(l.smem)));
  if (err) return err;
  kernel<<<l.blocks, kThreads, l.smem, stream>>>(args...);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, bool kSharedB>
int diff_topk_payload(const T* a, const T* b, T* vals, int* idx, T* sq, int n,
                      int M, int N, int block, int k, cudaStream_t stream) {
  const Launch l = plan(n, M, N, block, k, sizeof(T), {a, b, vals, idx});
  auto kernel = l.vec ? diff_topk_payload_kernel<T, kSharedB, true>
                      : diff_topk_payload_kernel<T, kSharedB, false>;
  return launch(kernel, l, stream, a, b, vals, idx, sq, n, M, N, block, l.gn,
                l.nblk, k);
}

// b_stride: 0 for one b shared by every silo, M * N for a stacked b
template <typename T>
int diff_topk_payload(const T* a, const T* b, long long b_stride, T* vals,
                      int* idx, T* sq, int n, int M, int N, int block, int k,
                      cudaStream_t stream) {
  if (b_stride == 0)
    return diff_topk_payload<T, true>(a, b, vals, idx, sq, n, M, N, block, k,
                                      stream);
  if (b_stride == static_cast<long long>(M) * N)
    return diff_topk_payload<T, false>(a, b, vals, idx, sq, n, M, N, block, k,
                                       stream);
  return static_cast<int>(cudaErrorInvalidValue);
}

template <typename T>
int block_topk_payload(const T* x, T* vals, int* idx, int n, int M, int N,
                       int block, int k, int bisect_all, cudaStream_t stream) {
  const Launch l = plan(n, M, N, block, k, sizeof(T), {x, vals, idx});
  auto kernel = l.vec ? block_topk_payload_kernel<T, true>
                      : block_topk_payload_kernel<T, false>;
  return launch(kernel, l, stream, x, vals, idx, n, M, N, block, l.gn, l.nblk,
                k, bisect_all);
}

template <typename T>
int block_topk(const T* x, T* out, int n, int M, int N, int block, int k,
               cudaStream_t stream) {
  const Launch l = plan(n, M, N, block, 0, sizeof(T), {x, out});
  auto kernel = l.vec ? block_topk_dense_kernel<T, true>
                      : block_topk_dense_kernel<T, false>;
  return launch(kernel, l, stream, x, out, n, M, N, block, l.gn, l.nblk, k);
}

}  // namespace

extern "C" {

int diff_topk_payload_f32(const float* a, const float* b, long long b_stride,
                          float* vals, int* idx, float* sq, int n, int M,
                          int N, int block, int k, cudaStream_t stream) {
  return diff_topk_payload(a, b, b_stride, vals, idx, sq, n, M, N, block, k,
                           stream);
}

int diff_topk_payload_f64(const double* a, const double* b, long long b_stride,
                          double* vals, int* idx, double* sq, int n, int M,
                          int N, int block, int k, cudaStream_t stream) {
  return diff_topk_payload(a, b, b_stride, vals, idx, sq, n, M, N, block, k,
                           stream);
}

int block_topk_payload_f32(const float* x, float* vals, int* idx, int n, int M,
                           int N, int block, int k, int bisect_all,
                           cudaStream_t stream) {
  return block_topk_payload(x, vals, idx, n, M, N, block, k, bisect_all,
                            stream);
}

int block_topk_payload_f64(const double* x, double* vals, int* idx, int n,
                           int M, int N, int block, int k, int bisect_all,
                           cudaStream_t stream) {
  return block_topk_payload(x, vals, idx, n, M, N, block, k, bisect_all,
                            stream);
}

int block_topk_f32(const float* x, float* out, int n, int M, int N, int block,
                   int k, cudaStream_t stream) {
  return block_topk(x, out, n, M, N, block, k, stream);
}

int block_topk_f64(const double* x, double* out, int n, int M, int N,
                   int block, int k, cudaStream_t stream) {
  return block_topk(x, out, n, M, N, block, k, stream);
}

// Kernel `which` (kernels/resources.py KERNELS["block_topk"] order:
// diff_topk_payload_kernel<T, kSharedB, kVecIO>, then
// block_topk_payload_kernel<T, kVecIO>, then block_topk_dense_kernel<T,
// kVecIO>, T float before double, true before false) at payload width
// args[0] (0 for the dense kernel, as its launcher passes).
int block_topk_launch_query(int which, const long long* args,
                            long long* out) {
  const void* fns[] = {
      reinterpret_cast<const void*>(&diff_topk_payload_kernel<float, true, true>),
      reinterpret_cast<const void*>(&diff_topk_payload_kernel<float, true, false>),
      reinterpret_cast<const void*>(&diff_topk_payload_kernel<float, false, true>),
      reinterpret_cast<const void*>(&diff_topk_payload_kernel<float, false, false>),
      reinterpret_cast<const void*>(&diff_topk_payload_kernel<double, true, true>),
      reinterpret_cast<const void*>(&diff_topk_payload_kernel<double, true, false>),
      reinterpret_cast<const void*>(&diff_topk_payload_kernel<double, false, true>),
      reinterpret_cast<const void*>(&diff_topk_payload_kernel<double, false, false>),
      reinterpret_cast<const void*>(&block_topk_payload_kernel<float, true>),
      reinterpret_cast<const void*>(&block_topk_payload_kernel<float, false>),
      reinterpret_cast<const void*>(&block_topk_payload_kernel<double, true>),
      reinterpret_cast<const void*>(&block_topk_payload_kernel<double, false>),
      reinterpret_cast<const void*>(&block_topk_dense_kernel<float, true>),
      reinterpret_cast<const void*>(&block_topk_dense_kernel<float, false>),
      reinterpret_cast<const void*>(&block_topk_dense_kernel<double, true>),
      reinterpret_cast<const void*>(&block_topk_dense_kernel<double, false>)};
  if (which < 0 || which >= 16 || args[0] < 0 || args[0] > kMaxTile)
    return static_cast<int>(cudaErrorInvalidValue);
  // which / 2 % 2 picks the type among the payload kernels' 4-groups
  const bool f64 = which < 8 ? which >= 4 : (which / 2) % 2 == 1;
  const size_t elem = f64 ? sizeof(double) : sizeof(float);
  return repro::query_kernel(
      fns[which], kThreads,
      static_cast<long long>(select_smem(static_cast<int>(args[0]), elem)),
      out);
}

}  // extern "C"

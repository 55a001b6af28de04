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
//     rounds of bisection on [0, max|x|], each round a block-wide count
//     of |x| >= mid; the bracket (lo, hi) satisfies
//     count(|x| >= hi) <= k <= count(|x| >= lo);
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
// Bound on the H100: bytes. Each kernel reads its inputs once and
// writes the payload (k values + k indices per tile) or the dense tile;
// the bisection's 32 passes run over the tile's |x| in shared memory
// (64 KiB f32 at block = 128), never over device memory. The dense
// difference of the fused variant is never written to device memory.
// `b` may be shared by every silo (silo stride 0, a kernel of its own so
// that the stacked case keeps one offset for a and b): FedNL's curvature
// learner diffs n silo observations against one H.
//
// Design: one thread block of 512 threads per (silo, tile). Loads are
// coalesced along tile rows. Each bisection round costs one barrier
// (per-warp counts meet in a shared-memory counter; three counters in
// rotation so none is cleared while it is read). For the flat-order
// compaction each thread owns a contiguous segment of at most 32 entries
// (block <= 128), reads it in a skewed order so the warp's shared-memory
// reads hit 32 different banks, and keeps its strict and tie entries as
// two 32-bit masks; one block-wide exclusive scan of the packed counts
// places every entry. The kept values are re-read from device memory,
// so they are x (or a - b) in the input type, bit for bit.

#include <cuda_runtime.h>

#include "common.cuh"

namespace {

constexpr int kThreads = 512;
constexpr int kBisectRounds = 32;
constexpr int kMaxTile = 32 * kThreads;  // block^2 limit: a segment fits a mask

enum Mode { kDiffPayload = 0, kPayload = 1, kDense = 2 };

// x at in-tile entry e of the tile at (r0, c0): a - b (kDiffPayload) or
// a; 0 past the matrix edge
template <typename T, int kMode>
__device__ __forceinline__ T tile_at(const T* __restrict__ a,
                                     const T* __restrict__ b, int e,
                                     int block, int r0, int c0, int M, int N) {
  const int r = e / block, c = e - r * block;
  const int gr = r0 + r, gc = c0 + c;
  if (gr >= M || gc >= N) return T(0);
  const size_t o = static_cast<size_t>(gr) * N + gc;
  return kMode == kDiffPayload ? a[o] - b[o] : a[o];
}

// One (silo, tile): the body every variant shares, inlined into each.
// kSharedB: one b for every silo (read in place), else b is stacked like a.
template <typename T, int kMode, bool kSharedB = false>
__device__ __forceinline__ void select_tile(
    const T* __restrict__ a, const T* __restrict__ b,
    T* __restrict__ vals, int* __restrict__ idx, T* __restrict__ sq,
    T* __restrict__ dense, int M, int N, int block, int gn, int nblk, int k,
    bool bisect_all, float* ax) {
  __shared__ T red_t[32];
  __shared__ float red_f[32];
  __shared__ int red_i[32];
  __shared__ int counts[3];

  const int bb = block * block;
  const int tile = blockIdx.x;                 // silo * nblk + tile in silo
  const int silo = tile / nblk, t = tile - silo * nblk;
  const int r0 = (t / gn) * block, c0 = (t % gn) * block;
  const size_t plane = static_cast<size_t>(M) * N;
  const T* as = a + silo * plane;
  const T* bs = kMode != kDiffPayload ? nullptr
                : kSharedB ? b : b + silo * plane;
  if (threadIdx.x < 3) counts[threadIdx.x] = 0;

  T part = T(0);
  float mx = 0.0f;
#pragma unroll 4
  for (int e = threadIdx.x; e < bb; e += kThreads) {
    const T x = tile_at<T, kMode>(as, bs, e, block, r0, c0, M, N);
    if (kMode == kDiffPayload) part += x * x;
    const float f = static_cast<float>(x < T(0) ? -x : x);
    ax[e] = f;
    mx = fmaxf(mx, f);
  }
  if (kMode == kDiffPayload) {
    const T total_sq = repro::block_sum(part, red_t);
    if (threadIdx.x == 0) sq[tile] = total_sq;
  }
  const float amax = repro::block_max(mx, red_f);

  // bisection bracket, f32, exactly as the TPU kernel's _bisect_bracket
  float lo = 0.0f, hi = amax;
  const bool keep_all = k >= bb && !bisect_all;
  if (!keep_all) {
    for (int it = 0; it < kBisectRounds; ++it) {
      const float mid = 0.5f * (lo + hi);
      int c = 0;
      for (int e = threadIdx.x; e < bb; e += kThreads) c += ax[e] >= mid;
      c = repro::warp_sum(c);
      if ((threadIdx.x & 31) == 0 && c) atomicAdd(&counts[it % 3], c);
      __syncthreads();
      const int cnt = counts[it % 3];
      if (threadIdx.x == 0) counts[(it + 2) % 3] = 0;  // read last round
      if (cnt > k) lo = mid; else hi = mid;
    }
  }

  if (kMode == kDense) {
    // x where |x| >= hi (everything when k covers the tile), else 0
    T* out = dense + silo * plane;
    for (int e = threadIdx.x; e < bb; e += kThreads) {
      const int r = e / block, c = e - r * block;
      if (r0 + r < M && c0 + c < N) {
        const size_t o = static_cast<size_t>(r0 + r) * N + c0 + c;
        out[o] = (keep_all || ax[e] >= hi) ? as[o] : T(0);
      }
    }
    return;
  }

  // flat-order compaction: strict entries, then ties, each in flat order
  const int seg = (bb + kThreads - 1) / kThreads;           // <= 32
  const int beg = min(bb, static_cast<int>(threadIdx.x) * seg);
  const int len = min(bb, beg + seg) - beg;
  unsigned strict = 0u, tie = 0u;
  for (int jj = 0; jj < len; ++jj) {
    const int j = (jj + threadIdx.x) % len;   // skewed: distinct banks
    const float f = ax[beg + j];
    if (keep_all || f >= hi) strict |= 1u << j;
    else if (f >= lo) tie |= 1u << j;
  }
  // both counts in one scan: each total is <= 16384 < 2^16
  int packed_total;
  const int packed = repro::block_exclusive_scan(
      (__popc(strict) << 16) | __popc(tie), &packed_total, red_i);
  const int strict_total = packed_total >> 16;
  const int tie_total = packed_total & 0xffff;
  int s_pos = packed >> 16;
  int t_pos = strict_total + (packed & 0xffff);

  // size_t row offsets: n * tiles * k exceeds 2^31 at LLM widths
  T* vrow = vals + static_cast<size_t>(tile) * k;
  int* irow = idx + static_cast<size_t>(tile) * k;
  for (; strict; strict &= strict - 1) {
    const int e = beg + __ffs(strict) - 1;
    const int pos = s_pos++;
    if (pos < k) {
      vrow[pos] = tile_at<T, kMode>(as, bs, e, block, r0, c0, M, N);
      irow[pos] = e;
    }
  }
  for (; tie && t_pos < k; tie &= tie - 1) {
    const int e = beg + __ffs(tie) - 1;
    const int pos = t_pos++;
    vrow[pos] = tile_at<T, kMode>(as, bs, e, block, r0, c0, M, N);
    irow[pos] = e;
  }
  const int filled = min(k, strict_total + tie_total);
  for (int p = filled + threadIdx.x; p < k; p += kThreads) {
    vrow[p] = T(0);
    irow[p] = -1;
  }
}

template <typename T, bool kSharedB>
__global__ void __launch_bounds__(kThreads)
diff_topk_payload_kernel(const T* __restrict__ a, const T* __restrict__ b,
                         T* __restrict__ vals, int* __restrict__ idx,
                         T* __restrict__ sq, int M, int N, int block, int gn,
                         int nblk, int k) {
  extern __shared__ float ax[];  // block * block magnitudes, f32
  select_tile<T, kDiffPayload, kSharedB>(a, b, vals, idx, sq, nullptr, M, N,
                                         block, gn, nblk, k, false, ax);
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
block_topk_payload_kernel(const T* __restrict__ x, T* __restrict__ vals,
                          int* __restrict__ idx, int M, int N, int block,
                          int gn, int nblk, int k, int bisect_all) {
  extern __shared__ float ax[];
  select_tile<T, kPayload>(x, nullptr, vals, idx, nullptr, nullptr, M, N,
                           block, gn, nblk, k, bisect_all != 0, ax);
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
block_topk_dense_kernel(const T* __restrict__ x, T* __restrict__ out, int M,
                        int N, int block, int gn, int nblk, int k) {
  extern __shared__ float ax[];
  select_tile<T, kDense>(x, nullptr, nullptr, nullptr, nullptr, out, M, N,
                         block, gn, nblk, k, false, ax);
}

// Grid and shared memory of one launch: one block per (silo, tile).
struct Launch {
  int gn, nblk;
  unsigned blocks;
  size_t smem;
  int err;
};

template <typename Kernel>
Launch plan(Kernel kernel, int n, int M, int N, int block) {
  Launch l{0, 0, 0, 0, 0};
  if (block <= 0 || block * block > kMaxTile) {
    l.err = static_cast<int>(cudaErrorInvalidValue);
    return l;
  }
  const int gm = (M + block - 1) / block;
  l.gn = (N + block - 1) / block;
  l.nblk = gm * l.gn;
  l.smem = static_cast<size_t>(block) * block * sizeof(float);
  const long long blocks = static_cast<long long>(n) * l.nblk;
  if (blocks > 0x7fffffffLL) {
    l.err = static_cast<int>(cudaErrorInvalidValue);
    return l;
  }
  l.blocks = static_cast<unsigned>(blocks);
  l.err = static_cast<int>(cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(l.smem)));
  return l;
}

template <typename T, bool kSharedB>
int diff_topk_payload(const T* a, const T* b, T* vals, int* idx, T* sq, int n,
                      int M, int N, int block, int k, cudaStream_t stream) {
  const Launch l = plan(diff_topk_payload_kernel<T, kSharedB>, n, M, N, block);
  if (l.err || l.blocks == 0) return l.err;
  diff_topk_payload_kernel<T, kSharedB><<<l.blocks, kThreads, l.smem, stream>>>(
      a, b, vals, idx, sq, M, N, block, l.gn, l.nblk, k);
  return static_cast<int>(cudaGetLastError());
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
  const Launch l = plan(block_topk_payload_kernel<T>, n, M, N, block);
  if (l.err || l.blocks == 0) return l.err;
  block_topk_payload_kernel<T><<<l.blocks, kThreads, l.smem, stream>>>(
      x, vals, idx, M, N, block, l.gn, l.nblk, k, bisect_all);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int block_topk(const T* x, T* out, int n, int M, int N, int block, int k,
               cudaStream_t stream) {
  const Launch l = plan(block_topk_dense_kernel<T>, n, M, N, block);
  if (l.err || l.blocks == 0) return l.err;
  block_topk_dense_kernel<T><<<l.blocks, kThreads, l.smem, stream>>>(
      x, out, M, N, block, l.gn, l.nblk, k);
  return static_cast<int>(cudaGetLastError());
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

}  // extern "C"

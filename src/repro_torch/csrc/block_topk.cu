// Fused FedNL uplink for Block-Top-K: per (block x block) tile of
// D = a - b, the k largest-magnitude entries as a (value, in-tile flat
// index) payload plus the tile's ||D||_F^2 partial.
//
// Replaces the TPU kernel diff_topk_payload_kernel
// (src/repro/kernels/block_topk/kernel.py, body in
// _diff_topk_payload_tile_kernel / _emit_topk_payload / _bisect_bracket)
// and keeps its selection exactly:
//   * |D| is rounded to f32 and the k-th magnitude is bracketed by 32
//     rounds of bisection on [0, max|D|], each round a block-wide count
//     of |D| >= mid; the bracket (lo, hi) satisfies
//     count(|D| >= hi) <= k <= count(|D| >= lo);
//   * exactly k entries are kept: every entry with |D| >= hi, then the
//     ties lo <= |D| < hi, each group in flat order, stopping at k;
//   * the payload lists the kept entries in that order, unfilled slots
//     carry value 0 and index -1; with k >= block^2 the whole tile is
//     kept in flat order.
// Entries past the matrix edge count as D = 0 at their in-tile flat
// index, as on the TPU, where the wrapper zero-padded the inputs; here
// the ragged edge is masked in the kernel instead of padded in a copy.
//
// Bound on the H100: bytes. The kernel reads a and b once (2 n d^2
// elements) and writes n * tiles * (k values + k indices + 1 partial);
// the bisection's 32 passes run over the tile's |D| in shared memory
// (64 KiB f32 at block = 128), never over device memory. The dense
// difference is never written to device memory.
//
// Design: one thread block of 512 threads per (silo, tile). Loads are
// coalesced along tile rows. Each bisection round costs one barrier
// (per-warp counts meet in a shared-memory counter; three counters in
// rotation so none is cleared while it is read). For the flat-order
// compaction each thread owns a contiguous segment of at most 32 entries
// (block <= 128), reads it in a skewed order so the warp's shared-memory
// reads hit 32 different banks, and keeps its strict and tie entries as
// two 32-bit masks; one block-wide exclusive scan of the packed counts
// places every entry. The kept values are re-read from a and b, so they
// are a - b in the input type, bit for bit.

#include <cuda_runtime.h>

#include "common.cuh"

namespace {

constexpr int kThreads = 512;
constexpr int kBisectRounds = 32;
constexpr int kMaxTile = 32 * kThreads;  // block^2 limit: a segment fits a mask

template <typename T>
__device__ __forceinline__ T diff_at(const T* a, const T* b, int e, int block,
                                     int r0, int c0, int M, int N) {
  const int r = e / block, c = e - r * block;
  const int gr = r0 + r, gc = c0 + c;
  if (gr >= M || gc >= N) return T(0);
  const size_t o = static_cast<size_t>(gr) * N + gc;
  return a[o] - b[o];
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
diff_topk_payload_kernel(const T* __restrict__ a, const T* __restrict__ b,
                         T* __restrict__ vals, int* __restrict__ idx,
                         T* __restrict__ sq, int M, int N, int block, int gn,
                         int nblk, int k) {
  extern __shared__ float ax[];  // block * block magnitudes, f32
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
  const T* bs = b + silo * plane;
  if (threadIdx.x < 3) counts[threadIdx.x] = 0;

  T part = T(0);
  float mx = 0.0f;
#pragma unroll 4
  for (int e = threadIdx.x; e < bb; e += kThreads) {
    const T d = diff_at(as, bs, e, block, r0, c0, M, N);
    part += d * d;
    const float f = static_cast<float>(d < T(0) ? -d : d);
    ax[e] = f;
    mx = fmaxf(mx, f);
  }
  const T total_sq = repro::block_sum(part, red_t);
  if (threadIdx.x == 0) sq[tile] = total_sq;
  const float amax = repro::block_max(mx, red_f);

  // bisection bracket, f32, exactly as the TPU kernel's _bisect_bracket
  float lo = 0.0f, hi = amax;
  const bool keep_all = k >= bb;
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

  T* vrow = vals + static_cast<size_t>(tile) * k;
  int* irow = idx + static_cast<size_t>(tile) * k;
  for (; strict; strict &= strict - 1) {
    const int e = beg + __ffs(strict) - 1;
    const int pos = s_pos++;
    if (pos < k) {
      vrow[pos] = diff_at(as, bs, e, block, r0, c0, M, N);
      irow[pos] = e;
    }
  }
  for (; tie && t_pos < k; tie &= tie - 1) {
    const int e = beg + __ffs(tie) - 1;
    const int pos = t_pos++;
    vrow[pos] = diff_at(as, bs, e, block, r0, c0, M, N);
    irow[pos] = e;
  }
  const int filled = min(k, strict_total + tie_total);
  for (int p = filled + threadIdx.x; p < k; p += kThreads) {
    vrow[p] = T(0);
    irow[p] = -1;
  }
}

template <typename T>
int launch(const T* a, const T* b, T* vals, int* idx, T* sq, int n, int M,
           int N, int block, int k, cudaStream_t stream) {
  const int gm = (M + block - 1) / block, gn = (N + block - 1) / block;
  const int nblk = gm * gn;
  if (block * block > kMaxTile) return static_cast<int>(cudaErrorInvalidValue);
  const size_t smem = static_cast<size_t>(block) * block * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      diff_topk_payload_kernel<T>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  if (n * nblk == 0) return 0;
  diff_topk_payload_kernel<T><<<n * nblk, kThreads, smem, stream>>>(
      a, b, vals, idx, sq, M, N, block, gn, nblk, k);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

int diff_topk_payload_f32(const float* a, const float* b, float* vals,
                          int* idx, float* sq, int n, int M, int N, int block,
                          int k, cudaStream_t stream) {
  return launch(a, b, vals, idx, sq, n, M, N, block, k, stream);
}

int diff_topk_payload_f64(const double* a, const double* b, double* vals,
                          int* idx, double* sq, int n, int M, int N,
                          int block, int k, cudaStream_t stream) {
  return launch(a, b, vals, idx, sq, n, M, N, block, k, stream);
}

}  // extern "C"

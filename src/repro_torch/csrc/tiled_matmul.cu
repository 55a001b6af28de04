// f32 matrix product C = A @ B with f32 accumulation, on the CUDA cores.
//
// Replaces the TPU kernel tiled_matmul_kernel
// (src/repro/kernels/tiled_matmul/kernel.py:31, body _matmul_kernel): the
// (bm, bn) output tile accumulated over the K axis in f32 from f32
// operands. Here every product is an f32 fused multiply-add on the CUDA
// cores: no tensor cores, so no TF32 rounding of the operands.
//
// Bound on the H100: operations for square products (2 M N K flops at
// 67 TFLOP/s f32), bytes for the skinny ones of the PowerSGD power
// iteration on an (M, K) matrix: reading A once for M @ Q and M^T @ P
// (N = r <= a few), writing C once for P @ Q^T (K = r), at 3.35 TB/s.
// Three routes, chosen by the wrapper from the shapes and strides:
//  - tiled (any shape): a classic shared-memory tiling, one block of 256
//    threads per 64 x 64 output tile, K in steps of 16; each thread keeps
//    a 4 x 4 register tile at rows ty + 16 i and columns tx + 16 j, so a
//    warp's shared-memory reads are broadcasts (A) or 16 distinct banks
//    (B). Operands may be transposed views: each is read through its two
//    strides, and the tile loader walks whichever index is contiguous so
//    the loads stay coalesced. The edges are masked (zeros in the tiles).
//    On a skinny product it wastes most of each tile and launches too few
//    blocks to fill the card, hence:
//  - small N (N <= 8): each element of A is read once, 16 bytes a load
//    along its contiguous index (the wrapper sends A here only where its
//    address, stride and contiguous extent allow 16-byte loads). Row-major A: one block of 4 warps per
//    (output row, K chunk), lanes along K, the N sums reduced by shuffles
//    and then across the warps in a fixed order. Column-major A (a
//    transposed view): lanes along the rows, 4 rows a thread, the block's
//    8 warps splitting its K chunk, reduced across the warps in a fixed
//    order. K is split into chunks where there are too few rows to fill
//    132 SMs; the chunks' partial sums are added by a second pass in chunk
//    order, never by float atomics, so the result does not depend on the
//    run.
//  - small K (K <= 8, N a multiple of 4): an outer-product expansion
//    bound by the C it writes; each thread holds B's K x 4 values of its
//    4 columns and writes 16 bytes per row for 8 rows.
#include <cuda_runtime.h>

#include "common.cuh"

namespace {

constexpr int kBM = 64, kBN = 64, kBK = 16;
constexpr int kThreads = 256;
constexpr int kTM = 4, kTN = 4;

__global__ void __launch_bounds__(kThreads)
tiled_matmul_kernel(const float* __restrict__ a, long long sam, long long sak,
                    const float* __restrict__ b, long long sbk, long long sbn,
                    float* __restrict__ c, int M, int N, int K) {
  __shared__ float as[kBK][kBM + 1];
  __shared__ float bs[kBK][kBN + 1];
  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
  const int row0 = blockIdx.y * kBM, col0 = blockIdx.x * kBN;
  const bool a_rows = sak == 1;   // A's K index is contiguous
  const bool b_rows = sbn == 1;   // B's N index is contiguous
  float acc[kTM][kTN] = {};

  for (int k0 = 0; k0 < K; k0 += kBK) {
    for (int i = threadIdx.x; i < kBM * kBK; i += kThreads) {
      const int r = a_rows ? i / kBK : i % kBM;
      const int kk = a_rows ? i % kBK : i / kBM;
      const int gr = row0 + r, gk = k0 + kk;
      as[kk][r] = (gr < M && gk < K) ? a[gr * sam + gk * sak] : 0.0f;
    }
    for (int i = threadIdx.x; i < kBK * kBN; i += kThreads) {
      const int kk = b_rows ? i / kBN : i % kBK;
      const int col = b_rows ? i % kBN : i / kBK;
      const int gk = k0 + kk, gc = col0 + col;
      bs[kk][col] = (gk < K && gc < N) ? b[gk * sbk + gc * sbn] : 0.0f;
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < kBK; ++kk) {
      float av[kTM], bv[kTN];
#pragma unroll
      for (int i = 0; i < kTM; ++i) av[i] = as[kk][ty + 16 * i];
#pragma unroll
      for (int j = 0; j < kTN; ++j) bv[j] = bs[kk][tx + 16 * j];
#pragma unroll
      for (int i = 0; i < kTM; ++i)
#pragma unroll
        for (int j = 0; j < kTN; ++j) acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
    }
    __syncthreads();
  }
#pragma unroll
  for (int i = 0; i < kTM; ++i) {
    const int gr = row0 + ty + 16 * i;
    if (gr >= M) continue;
#pragma unroll
    for (int j = 0; j < kTN; ++j) {
      const int gc = col0 + tx + 16 * j;
      if (gc < N) c[static_cast<long long>(gr) * N + gc] = acc[i][j];
    }
  }
}

constexpr int kMaxSkinny = 8;  // N (small-N route) or K (small-K route)
constexpr int kLoads = 4;      // loads of A in flight per thread

__device__ __forceinline__ float warp_sum(float v) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// Small N, row-major A (a[m * sam + k]; a 16-byte aligned, sam, kc and K
// multiples of 4): block (m, chunk) of 128 threads sums k in
// [chunk * kc, min(K, (chunk + 1) * kc)), 4 k a load.
__global__ void __launch_bounds__(128)
tiled_matmul_small_n_rows_kernel(const float* __restrict__ a, long long sam,
                                 const float* __restrict__ b, long long sbk,
                                 long long sbn, float* __restrict__ out,
                                 int M, int N, int K, int kc) {
  __shared__ float red[4][kMaxSkinny];
  const int m = blockIdx.x, chunk = blockIdx.y;
  const int k_lo = chunk * kc, k_hi = min(K, k_lo + kc);
  const float* row = a + m * sam;
  constexpr int STEP = 4 * 128;  // k per sweep of the block
  float acc[kMaxSkinny] = {};
  // kLoads loads are issued before any is used, to keep bytes in flight
  for (int k0 = k_lo + 4 * threadIdx.x; k0 < k_hi; k0 += STEP * kLoads) {
    float4 x[kLoads];
#pragma unroll
    for (int u = 0; u < kLoads; ++u) {
      const int k = k0 + u * STEP;
      x[u] = k < k_hi ? *reinterpret_cast<const float4*>(row + k)
                      : make_float4(0.0f, 0.0f, 0.0f, 0.0f);
    }
#pragma unroll
    for (int u = 0; u < kLoads; ++u) {
      const int k = k0 + u * STEP;
      if (k >= k_hi) break;
      const float xs[4] = {x[u].x, x[u].y, x[u].z, x[u].w};
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < kMaxSkinny; ++j)
          if (j < N) acc[j] = fmaf(xs[i], b[(k + i) * sbk + j * sbn], acc[j]);
    }
  }
  const int lane = threadIdx.x & 31, w = threadIdx.x >> 5;
#pragma unroll
  for (int j = 0; j < kMaxSkinny; ++j) {
    if (j >= N) break;
    const float v = warp_sum(acc[j]);
    if (lane == 0) red[w][j] = v;
  }
  __syncthreads();
  if (threadIdx.x < N) {
    const int j = threadIdx.x;
    const float v = ((red[0][j] + red[1][j]) + red[2][j]) + red[3][j];
    out[(static_cast<long long>(chunk) * M + m) * N + j] = v;
  }
}

// Small N, column-major A (a[m + k * sak]; a 16-byte aligned, sak and M
// multiples of 4): block (tile of 128 rows, chunk) of 256 threads; lane l
// takes rows 4 l .. 4 l + 3 of the tile with one 16-byte load, and warp w
// the k = k_lo + w, k_lo + w + 8, ... of the chunk.
__global__ void __launch_bounds__(256)
tiled_matmul_small_n_cols_kernel(const float* __restrict__ a, long long sak,
                                 const float* __restrict__ b, long long sbk,
                                 long long sbn, float* __restrict__ out,
                                 int M, int N, int K, int kc) {
  __shared__ float red[8][128][kMaxSkinny];
  const int lane = threadIdx.x & 31, w = threadIdx.x >> 5;
  const int m0 = blockIdx.x * 128 + 4 * lane;
  const int chunk = blockIdx.y;
  const int k_lo = chunk * kc, k_hi = min(K, k_lo + kc);
  float acc[4][kMaxSkinny] = {};
  if (m0 < M) {
    // kLoads loads are issued before any is used, to keep bytes in flight
    for (int k0 = k_lo + w; k0 < k_hi; k0 += 8 * kLoads) {
      float4 x[kLoads];
#pragma unroll
      for (int u = 0; u < kLoads; ++u) {
        const int k = k0 + 8 * u;
        x[u] = k < k_hi ? *reinterpret_cast<const float4*>(a + m0 + k * sak)
                        : make_float4(0.0f, 0.0f, 0.0f, 0.0f);
      }
#pragma unroll
      for (int u = 0; u < kLoads; ++u) {
        const int k = k0 + 8 * u;
        if (k >= k_hi) break;
        const float xs[4] = {x[u].x, x[u].y, x[u].z, x[u].w};
#pragma unroll
        for (int j = 0; j < kMaxSkinny; ++j) {
          if (j >= N) break;
          const float bj = b[k * sbk + j * sbn];
#pragma unroll
          for (int r = 0; r < 4; ++r) acc[r][j] = fmaf(xs[r], bj, acc[r][j]);
        }
      }
    }
  }
#pragma unroll
  for (int r = 0; r < 4; ++r)
#pragma unroll
    for (int j = 0; j < kMaxSkinny; ++j) red[w][4 * lane + r][j] = acc[r][j];
  __syncthreads();
  for (int i = threadIdx.x; i < 128 * N; i += 256) {
    const int r = i / N, j = i % N;
    const int m = blockIdx.x * 128 + r;
    if (m >= M) continue;
    float v = red[0][r][j];
#pragma unroll
    for (int ww = 1; ww < 8; ++ww) v += red[ww][r][j];
    out[(static_cast<long long>(chunk) * M + m) * N + j] = v;
  }
}

// C = the sum of the `chunks` partial products (chunks, M * N), in chunk
// order.
__global__ void tiled_matmul_sum_partials_kernel(
    const float* __restrict__ part, float* __restrict__ c, long long mn,
    int chunks) {
  const long long i = blockIdx.x * static_cast<long long>(blockDim.x) +
                      threadIdx.x;
  if (i >= mn) return;
  float v = part[i];
  for (int s = 1; s < chunks; ++s) v += part[s * mn + i];
  c[i] = v;
}

// Small K: C (M, N) row-major, N a multiple of 4; block (column tile of
// 1024, row tile of 8) of 256 threads; thread t takes columns 4 t .. 4 t + 3
// and writes them with one 16-byte store a row.
__global__ void __launch_bounds__(256)
tiled_matmul_small_k_kernel(const float* __restrict__ a, long long sam,
                            long long sak, const float* __restrict__ b,
                            long long sbk, long long sbn,
                            float* __restrict__ c, int M, int N, int K) {
  constexpr int kRows = 8;
  const int n0 = (blockIdx.x * 256 + threadIdx.x) * 4;
  if (n0 >= N) return;
  float bv[kMaxSkinny][4];
#pragma unroll
  for (int k = 0; k < kMaxSkinny; ++k)
#pragma unroll
    for (int u = 0; u < 4; ++u)
      bv[k][u] = k < K ? b[k * sbk + (n0 + u) * sbn] : 0.0f;
  const int m_hi = min(M, (blockIdx.y + 1) * kRows);
  for (int m = blockIdx.y * kRows; m < m_hi; ++m) {
    float v[4] = {};
#pragma unroll
    for (int k = 0; k < kMaxSkinny; ++k) {
      if (k >= K) break;
      const float x = a[m * sam + k * sak];
#pragma unroll
      for (int u = 0; u < 4; ++u) v[u] = fmaf(x, bv[k][u], v[u]);
    }
    *reinterpret_cast<float4*>(c + static_cast<long long>(m) * N + n0) =
        make_float4(v[0], v[1], v[2], v[3]);
  }
}

}  // namespace

extern "C" {

// C (M, N) row-major = A (M, K) @ B (K, N); A and B by their strides.
int tiled_matmul_f32(const float* a, long long sam, long long sak,
                     const float* b, long long sbk, long long sbn, float* c,
                     int M, int N, int K, cudaStream_t stream) {
  if (M == 0 || N == 0) return 0;
  const dim3 grid((N + kBN - 1) / kBN, (M + kBM - 1) / kBM);
  if (grid.y > 65535) return static_cast<int>(cudaErrorInvalidValue);
  tiled_matmul_kernel<<<grid, kThreads, 0, stream>>>(a, sam, sak, b, sbk, sbn,
                                                     c, M, N, K);
  return static_cast<int>(cudaGetLastError());
}

// The small-N route, N <= 8: A row-major (sak == 1) or column-major
// (sam == 1), 16-byte aligned with its other stride and its contiguous
// extent multiples of 4. K is cut into `chunks` of kc (a multiple of 4 for
// row-major A); with more than one chunk the partial products go to `part`
// (chunks, M, N) and a second pass adds them into C.
int tiled_matmul_small_n_f32(const float* a, long long sam, long long sak,
                             const float* b, long long sbk, long long sbn,
                             float* c, float* part, int M, int N, int K,
                             int chunks, int kc, cudaStream_t stream) {
  if (M == 0 || N == 0) return 0;
  if (N > kMaxSkinny || chunks < 1 || chunks > 65535 ||
      (chunks > 1 && part == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  float* dst = chunks > 1 ? part : c;
  if (sak == 1) {
    tiled_matmul_small_n_rows_kernel<<<dim3(M, chunks), 128, 0, stream>>>(
        a, sam, b, sbk, sbn, dst, M, N, K, kc);
  } else if (sam == 1) {
    tiled_matmul_small_n_cols_kernel<<<dim3((M + 127) / 128, chunks), 256, 0,
                                       stream>>>(a, sak, b, sbk, sbn, dst, M,
                                                 N, K, kc);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || chunks == 1) return static_cast<int>(err);
  const long long mn = static_cast<long long>(M) * N;
  tiled_matmul_sum_partials_kernel<<<(mn + 255) / 256, 256, 0, stream>>>(
      part, c, mn, chunks);
  return static_cast<int>(cudaGetLastError());
}

// The small-K route, K <= 8: C (M, N) row-major, N a multiple of 4.
int tiled_matmul_small_k_f32(const float* a, long long sam, long long sak,
                             const float* b, long long sbk, long long sbn,
                             float* c, int M, int N, int K,
                             cudaStream_t stream) {
  if (M == 0 || N == 0) return 0;
  if (K > kMaxSkinny || N % 4 != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid((N + 1023) / 1024, (M + 7) / 8);
  if (grid.y > 65535) return static_cast<int>(cudaErrorInvalidValue);
  tiled_matmul_small_k_kernel<<<grid, 256, 0, stream>>>(a, sam, sak, b, sbk,
                                                        sbn, c, M, N, K);
  return static_cast<int>(cudaGetLastError());
}

// Kernel `which` (tiled_matmul_kernel, tiled_matmul_small_n_rows_kernel,
// tiled_matmul_small_n_cols_kernel, tiled_matmul_sum_partials_kernel,
// tiled_matmul_small_k_kernel) with the threads its launcher gives it;
// none takes dynamic shared memory, args are not read.
int tiled_matmul_launch_query(int which, const long long* args,
                              long long* out) {
  (void)args;
  const void* fns[] = {
      reinterpret_cast<const void*>(&tiled_matmul_kernel),
      reinterpret_cast<const void*>(&tiled_matmul_small_n_rows_kernel),
      reinterpret_cast<const void*>(&tiled_matmul_small_n_cols_kernel),
      reinterpret_cast<const void*>(&tiled_matmul_sum_partials_kernel),
      reinterpret_cast<const void*>(&tiled_matmul_small_k_kernel)};
  const int threads[] = {kThreads, 128, 256, 256, 256};
  if (which < 0 || which >= 5) return static_cast<int>(cudaErrorInvalidValue);
  return repro::query_kernel(fns[which], threads[which], 0, out);
}

}  // extern "C"

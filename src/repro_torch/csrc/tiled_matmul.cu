// f32 matrix product C = A @ B with f32 accumulation, on the CUDA cores.
//
// Replaces the TPU kernel tiled_matmul_kernel
// (src/repro/kernels/tiled_matmul/kernel.py, body _matmul_kernel): the
// (bm, bn) output tile accumulated over the K axis in f32 from f32
// operands. Here every product is an f32 fused multiply-add on the CUDA
// cores: no tensor cores, so no TF32 rounding of the operands.
//
// Bound on the H100: operations for square products (2 M N K flops at
// 67 TFLOP/s f32), bytes for the skinny ones of the PowerSGD power
// iteration (M x K times K x r with r <= a few), where reading A once
// at 3.35 TB/s is the floor.
// Design: a classic shared-memory tiling — one block of 256 threads per
// 64 x 64 output tile, K in steps of 16; each thread keeps a 4 x 4
// register tile at rows ty + 16 i and columns tx + 16 j, so a warp's
// shared-memory reads are broadcasts (A) or 16 distinct banks (B).
// Operands may be transposed views: each is read through its two strides,
// and the tile loader walks whichever index is contiguous in memory so
// the loads stay coalesced. The edges are masked (zeros in the tiles).

#include <cuda_runtime.h>

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

}  // extern "C"

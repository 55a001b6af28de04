// FedNL's device-side Hessian bookkeeping (Algorithm 1, lines 5-6) in
// one pass over the tiles of a stack of matrices:
//
//   out      = H + alpha * S                    (in H's type)
//   err[t]   = sum over tile t of f32(H - D)^2  (f32, also for f64 input)
//
// and the wrapper takes ||H - D||_F = sqrt(sum_t err[t]).
//
// Replaces the TPU kernel hess_update_kernel
// (src/repro/kernels/hess_update/kernel.py, body _hess_update_kernel):
// the same arithmetic — H - D in the input type, rounded to f32, squared
// and summed in f32; H + alpha * S as one fused multiply-add (a single
// rounding), which is what XLA makes of the reference's `h + alpha * s`
// and what `torch.add(h, s, alpha=alpha)` computes, so the updated H
// equals both bit for bit (at alpha = 1 it is the plain sum). The TPU
// wrapper zero-pads the ragged edge; here the edge tiles are masked in
// the kernel and no padded copy is made.
//
// Bound on the H100: bytes. Three reads and one write per entry, and one
// f32 per tile; about 5 flops per entry.
// Design: one block of 256 threads per (matrix, block x block tile),
// threads along the tile's rows so every warp reads 32 neighbouring
// entries; one block-wide f32 sum per tile.

#include <cuda_runtime.h>

#include "common.cuh"

namespace {

constexpr int kThreads = 256;

__device__ __forceinline__ float axpy(float h, float a, float s) {
  return __fmaf_rn(a, s, h);
}
__device__ __forceinline__ double axpy(double h, double a, double s) {
  return __fma_rn(a, s, h);
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
hess_update_kernel(const T* __restrict__ h, const T* __restrict__ d,
                   const T* __restrict__ s, T alpha, T* __restrict__ out,
                   float* __restrict__ err, int M, int N, int block, int gn,
                   int nblk) {
  __shared__ float red[32];
  const int tile = blockIdx.x;                 // matrix * nblk + tile
  const int mat = tile / nblk, t = tile - mat * nblk;
  const int r0 = (t / gn) * block, c0 = (t % gn) * block;
  const int rows = min(block, M - r0), cols = min(block, N - c0);
  const long long base = static_cast<long long>(mat) * M * N;
  float part = 0.0f;
  for (int e = threadIdx.x; e < rows * cols; e += kThreads) {
    const int r = e / cols, c = e - r * cols;
    const long long o = base + static_cast<long long>(r0 + r) * N + c0 + c;
    const T hv = h[o];
    const float df = static_cast<float>(hv - d[o]);
    part += df * df;
    out[o] = axpy(hv, alpha, s[o]);
  }
  const float total = repro::block_sum(part, red);
  if (threadIdx.x == 0) err[tile] = total;
}

template <typename T>
int launch(const T* h, const T* d, const T* s, double alpha, T* out,
           float* err, int nmat, int M, int N, int block,
           cudaStream_t stream) {
  if (block <= 0) return static_cast<int>(cudaErrorInvalidValue);
  const int gm = (M + block - 1) / block, gn = (N + block - 1) / block;
  const long long blocks = static_cast<long long>(nmat) * gm * gn;
  if (blocks == 0) return 0;
  if (blocks > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  hess_update_kernel<T><<<static_cast<unsigned>(blocks), kThreads, 0,
                          stream>>>(h, d, s, static_cast<T>(alpha), out, err,
                                    M, N, block, gn, gm * gn);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

int hess_update_f32(const float* h, const float* d, const float* s,
                    double alpha, float* out, float* err, int nmat, int M,
                    int N, int block, cudaStream_t stream) {
  return launch(h, d, s, alpha, out, err, nmat, M, N, block, stream);
}

int hess_update_f64(const double* h, const double* d, const double* s,
                    double alpha, double* out, float* err, int nmat, int M,
                    int N, int block, cudaStream_t stream) {
  return launch(h, d, s, alpha, out, err, nmat, M, N, block, stream);
}

// Kernel `which` (hess_update_kernel<float>, then <double>): no dynamic
// shared memory; args are not read.
int hess_update_launch_query(int which, const long long* args,
                             long long* out) {
  (void)args;
  const void* fns[] = {
      reinterpret_cast<const void*>(&hess_update_kernel<float>),
      reinterpret_cast<const void*>(&hess_update_kernel<double>)};
  if (which < 0 || which >= 2) return static_cast<int>(cudaErrorInvalidValue);
  return repro::query_kernel(fns[which], kThreads, 0, out);
}

}  // extern "C"

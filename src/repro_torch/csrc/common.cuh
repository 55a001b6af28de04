// Block-wide reductions and scans shared by the port's kernels.
// Every helper must be reached by all threads of the block (they
// synchronise) and needs blockDim.x to be a multiple of 32.
#pragma once

#include <cuda_runtime.h>

namespace repro {

template <typename T>
__device__ __forceinline__ T warp_sum(T v) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_down_sync(0xffffffffu, v, o);
  return v;
}

// Max over the warp of floats (fmaxf: a NaN never wins), to every lane.
__device__ __forceinline__ float warp_max(float v) {
  for (int o = 16; o > 0; o >>= 1)
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

// Sum over the block, returned to every thread. `buf` holds 32 T.
template <typename T>
__device__ T block_sum(T v, T* buf) {
  const int lane = threadIdx.x & 31, wid = threadIdx.x >> 5;
  const int nw = blockDim.x >> 5;
  v = warp_sum(v);
  if (lane == 0) buf[wid] = v;
  __syncthreads();
  if (wid == 0) {
    T w = lane < nw ? buf[lane] : T(0);
    w = warp_sum(w);
    if (lane == 0) buf[0] = w;
  }
  __syncthreads();
  T total = buf[0];
  __syncthreads();  // buf may be reused right away
  return total;
}

// Exclusive prefix sum over threads in thread order; *total gets the
// block-wide sum. `buf` holds 32 ints.
__device__ inline int block_exclusive_scan(int v, int* total, int* buf) {
  const int lane = threadIdx.x & 31, wid = threadIdx.x >> 5;
  const int nw = blockDim.x >> 5;
  int x = v;
  for (int o = 1; o < 32; o <<= 1) {
    int y = __shfl_up_sync(0xffffffffu, x, o);
    if (lane >= o) x += y;
  }
  if (lane == 31) buf[wid] = x;
  __syncthreads();
  if (wid == 0) {
    int w = lane < nw ? buf[lane] : 0;
    for (int o = 1; o < 32; o <<= 1) {
      int y = __shfl_up_sync(0xffffffffu, w, o);
      if (lane >= o) w += y;
    }
    buf[lane] = w;  // inclusive scan of the warp sums
  }
  __syncthreads();
  const int before = wid > 0 ? buf[wid - 1] : 0;
  *total = buf[nw - 1];
  __syncthreads();
  return before + x - v;
}

// What a launcher's query reports of one kernel function: out = {numRegs,
// sharedSizeBytes (static), maxThreadsPerBlock} from
// cudaFuncGetAttributes, then the threads per block and the dynamic
// shared bytes its launcher gives that kernel for the query's arguments.
// kernels/resources.py prices the same launches in Python.
inline int query_kernel(const void* fn, int threads, long long dynamic,
                        long long* out) {
  cudaFuncAttributes a;
  const cudaError_t err = cudaFuncGetAttributes(&a, fn);
  if (err != cudaSuccess) return static_cast<int>(err);
  out[0] = a.numRegs;
  out[1] = static_cast<long long>(a.sharedSizeBytes);
  out[2] = a.maxThreadsPerBlock;
  out[3] = threads;
  out[4] = dynamic;
  return 0;
}

}  // namespace repro

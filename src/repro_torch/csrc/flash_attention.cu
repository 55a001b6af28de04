// Causal flash attention forward in f32: out = softmax(q k^T / sqrt(hd),
// causal) v, with online-softmax statistics, over q (B, T, H, hd) and k, v
// (B, T, KV, hd), head h reading KV head h / (H / KV); with a sliding
// window W > 0, query i attends to keys j with i - W < j <= i. bf16 inputs
// take the tensor-core kernel in flash_attention_wgmma.cu.
//
// Replaces the TPU kernel flash_attention_kernel
// (src/repro/kernels/flash_attention/kernel.py, body _flash_kernel) for
// f32 inputs: per (batch*head, query tile) the key/value tiles up to the
// diagonal stream past a running max m, sum l and accumulator acc kept in
// f32; q is scaled by 1/sqrt(hd) in f32, keys after the query score -1e30,
// and the output is acc / max(l, 1e-30). Every product and sum is an f32
// fused multiply-add on the CUDA cores: no tensor cores, no TF32, so the
// f32 route keeps f32 products.
//
// Bound on the H100: operations. A causal pass does 4 hd T(T+1)/2 flops
// per (batch, head), about 1.9 TFLOP per layer of qwen2-0.5B at
// T = 32,768 against 0.26 GB of f32 q, k, v and out; this kernel runs on
// the f32 FFMA pipes (67 TFLOP/s peak).
// Design: one block of 256 threads (16 x 16) per (batch*head, BQ-row query
// tile), the tiles of the longest walks launched first (with a window,
// every tile past the window walks as far: the order stays longest first,
// with ties). The scaled
// q tile is kept transposed in dynamic shared memory; each key tile is
// loaded transposed into one buffer, the BQ x BK scores are computed as
// an (BQ/16) x (BK/16) register tile per thread (rows ty + 16 i, columns
// tx + 16 j, so a warp's shared-memory reads are broadcasts or distinct
// banks), masked, and reduced per row across the 16 lanes of a half-warp
// by shuffles. The probabilities go to shared memory, the value tile
// replaces the key tile in the same buffer, and each thread adds P V into
// its (BQ/16) x (hd/16) accumulator with the rows of its scores, so the
// row statistics never leave the thread. Only key tiles holding a key <=
// the tile's last query are walked (for any BQ, BK: the reference's
// (qi*bq)//bk + 1 drops keys when bq > bk), and with a window only from
// the tile holding key q0 - W + 1, the first that the tile's first query
// sees; the window's edge tile is masked like the diagonal one. The walk
// runs forward, so with a window a row's first tile can be all masked
// (keys <= row - W): its scores of -1e30 then weigh 1 each while the
// row's max is -1e30, and the first real key's rescale
// exp(-1e30 - m) = 0 clears them exactly; every row's own key is in the
// walk, so none ends there. A ragged T is masked, its
// padded rows read as zeros and are never written. Inputs are read
// through their batch, sequence and head strides (the last dim must be
// contiguous); the output is a contiguous (B, T, H, hd).

#include <cuda_runtime.h>

#include <cmath>

#include "common.cuh"

namespace {

constexpr int kThreads = 256;

struct Strides {
  long long b, t, h;
};

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ void store(float* p, float x) { *p = x; }

template <int HD, int BQ, int BK>
constexpr int smem_floats() {
  return HD * (BQ + 1) + HD * (BK + 1) + BQ * (BK + 1);
}

template <typename T, int HD, int BQ, int BK>
__global__ void __launch_bounds__(kThreads, 1)
flash_attention_kernel(const T* __restrict__ q, Strides sq,
                       const T* __restrict__ k, Strides sk,
                       const T* __restrict__ v, Strides sv,
                       T* __restrict__ o, int seq, int heads, int n_rep,
                       int window, float scale) {
  constexpr int RM = BQ / 16, CN = BK / 16, DN = HD / 16;
  constexpr int QLD = BQ + 1, KLD = BK + 1, PLD = BK + 1;
  extern __shared__ float smem[];
  float* qs = smem;              // scaled q^T: [HD][QLD]
  float* kv = qs + HD * QLD;     // k^T [HD][KLD], then v [BK][HD]
  float* ps = kv + HD * KLD;     // probabilities: [BQ][PLD]

  const int tid = threadIdx.x, tx = tid & 15, ty = tid >> 4;
  const int b = blockIdx.y / heads, h = blockIdx.y % heads;
  const int q0 = (gridDim.x - 1 - blockIdx.x) * BQ;
  const T* qb = q + b * sq.b + h * sq.h;
  const T* kb = k + b * sk.b + (h / n_rep) * sk.h;
  const T* vb = v + b * sv.b + (h / n_rep) * sv.h;

  for (int i = tid; i < BQ * HD; i += kThreads) {
    const int r = i / HD, d = i % HD, t = q0 + r;
    qs[d * QLD + r] = t < seq ? to_f32(qb[t * sq.t + d]) * scale : 0.0f;
  }
  float m[RM], l[RM], acc[RM][DN];
#pragma unroll
  for (int i = 0; i < RM; ++i) {
    m[i] = -1e30f;
    l[i] = 0.0f;
#pragma unroll
    for (int j = 0; j < DN; ++j) acc[i][j] = 0.0f;
  }

  const int q_last = min(q0 + BQ, seq) - 1;
  const int n_kt = q_last / BK + 1;  // key tiles holding a key <= q_last
  // the first key tile holding a key in q0's window
  const int kt0 = window > 0 ? max(0, q0 - window + 1) / BK : 0;
  for (int kt = kt0; kt < n_kt; ++kt) {
    const int k0 = kt * BK;
    __syncthreads();  // the last tile's p and v reads are done
    for (int i = tid; i < BK * HD; i += kThreads) {
      const int r = i / HD, d = i % HD, t = k0 + r;
      kv[d * KLD + r] = t < seq ? to_f32(kb[t * sk.t + d]) : 0.0f;
    }
    __syncthreads();

    float s[RM][CN];
#pragma unroll
    for (int i = 0; i < RM; ++i)
#pragma unroll
      for (int j = 0; j < CN; ++j) s[i][j] = 0.0f;
#pragma unroll 4
    for (int d = 0; d < HD; ++d) {
      float a[RM], c[CN];
#pragma unroll
      for (int i = 0; i < RM; ++i) a[i] = qs[d * QLD + ty + 16 * i];
#pragma unroll
      for (int j = 0; j < CN; ++j) c[j] = kv[d * KLD + tx + 16 * j];
#pragma unroll
      for (int i = 0; i < RM; ++i)
#pragma unroll
        for (int j = 0; j < CN; ++j) s[i][j] = fmaf(a[i], c[j], s[i][j]);
    }

    // causal, window and ragged mask, then the online softmax of each
    // row; a row lives in the 16 lanes of one half-warp
#pragma unroll
    for (int i = 0; i < RM; ++i) {
      const int qi = q0 + ty + 16 * i;
      float mx = -1e30f;
#pragma unroll
      for (int j = 0; j < CN; ++j) {
        const int kj = k0 + tx + 16 * j;
        if (kj > qi || kj >= seq || (window > 0 && kj <= qi - window))
          s[i][j] = -1e30f;
        mx = fmaxf(mx, s[i][j]);
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float m_new = fmaxf(m[i], mx);
      const float alpha = expf(m[i] - m_new);
      float rs = 0.0f;
#pragma unroll
      for (int j = 0; j < CN; ++j) {
        s[i][j] = expf(s[i][j] - m_new);
        rs += s[i][j];
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        rs += __shfl_xor_sync(0xffffffffu, rs, off);
      l[i] = l[i] * alpha + rs;
      m[i] = m_new;
#pragma unroll
      for (int j = 0; j < DN; ++j) acc[i][j] *= alpha;
#pragma unroll
      for (int j = 0; j < CN; ++j) ps[(ty + 16 * i) * PLD + tx + 16 * j] = s[i][j];
    }
    __syncthreads();  // k^T reads done, p written

    for (int i = tid; i < BK * HD; i += kThreads) {
      const int r = i / HD, d = i % HD, t = k0 + r;
      kv[r * HD + d] = t < seq ? to_f32(vb[t * sv.t + d]) : 0.0f;
    }
    __syncthreads();
#pragma unroll 4
    for (int c = 0; c < BK; ++c) {
      float p[RM], w[DN];
#pragma unroll
      for (int i = 0; i < RM; ++i) p[i] = ps[(ty + 16 * i) * PLD + c];
#pragma unroll
      for (int j = 0; j < DN; ++j) w[j] = kv[c * HD + tx + 16 * j];
#pragma unroll
      for (int i = 0; i < RM; ++i)
#pragma unroll
        for (int j = 0; j < DN; ++j) acc[i][j] = fmaf(p[i], w[j], acc[i][j]);
    }
  }

#pragma unroll
  for (int i = 0; i < RM; ++i) {
    const int t = q0 + ty + 16 * i;
    if (t >= seq) continue;
    const float li = fmaxf(l[i], 1e-30f);
    T* row = o + ((static_cast<long long>(b) * seq + t) * heads + h) * HD;
#pragma unroll
    for (int j = 0; j < DN; ++j) store(row + tx + 16 * j, acc[i][j] / li);
  }
}

template <typename T, int HD, int BQ, int BK>
int launch(const T* q, Strides sq, const T* k, Strides sk, const T* v,
           Strides sv, T* o, int B, int seq, int H, int KV, int window,
           cudaStream_t stream) {
  constexpr int smem =
      static_cast<int>(smem_floats<HD, BQ, BK>() * sizeof(float));
  auto kernel = flash_attention_kernel<T, HD, BQ, BK>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((seq + BQ - 1) / BQ, B * H);
  // 1/sqrt(hd) rounded once to f32, as the reference's Python scale
  const float scale = static_cast<float>(1.0 / std::sqrt(double(HD)));
  kernel<<<grid, kThreads, smem, stream>>>(q, sq, k, sk, v, sv, o, seq, H,
                                           H / KV, window, scale);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int dispatch(const T* q, Strides sq, const T* k, Strides sk, const T* v,
             Strides sv, T* o, int B, int seq, int H, int KV, int hd, int bq,
             int bk, int window, cudaStream_t stream) {
  if (B * H > 65535 || KV <= 0 || H % KV != 0 || window < 0)
    return static_cast<int>(cudaErrorInvalidValue);
#define FLASH_CASE(HD_, BQ_, BK_)                                        \
  if (hd == HD_ && bq == BQ_ && bk == BK_)                               \
    return launch<T, HD_, BQ_, BK_>(q, sq, k, sk, v, sv, o, B, seq, H, KV, \
                                    window, stream);
  FLASH_CASE(64, 128, 128)
  FLASH_CASE(64, 128, 64)
  FLASH_CASE(64, 64, 128)
  FLASH_CASE(64, 64, 64)
  FLASH_CASE(128, 128, 128)
  FLASH_CASE(128, 128, 64)
  FLASH_CASE(128, 64, 128)
  FLASH_CASE(128, 64, 64)
#undef FLASH_CASE
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace

extern "C" {

// out (B, T, H, hd) contiguous = causal attention of f32 q over k, v;
// each input by its batch, sequence and head strides (elements); window
// 0 for none, else the keys each query sees.
#define FLASH_ENTRY(NAME, T)                                                  \
  int NAME(const T* q, long long sqb, long long sqt, long long sqh,           \
           const T* k, long long skb, long long skt, long long skh,           \
           const T* v, long long svb, long long svt, long long svh, T* o,     \
           int B, int seq, int H, int KV, int hd, int bq, int bk, int window, \
           cudaStream_t stream) {                                             \
    if (B == 0 || seq == 0 || H == 0) return 0;                               \
    return dispatch<T>(q, Strides{sqb, sqt, sqh}, k, Strides{skb, skt, skh},  \
                       v, Strides{svb, svt, svh}, o, B, seq, H, KV, hd, bq,   \
                       bk, window, stream);                                   \
  }
FLASH_ENTRY(flash_attention_f32, float)
#undef FLASH_ENTRY

// Kernel `which` of the (hd, bq, bk) instantiations in the order of
// `dispatch` (64 before 128, 128 before 64 for the tiles): its threads
// and the dynamic shared bytes its launcher sets; args are not read.
int flash_attention_launch_query(int which, const long long* args,
                                 long long* out) {
  (void)args;
#define FLASH_QUERY(I, HD_, BQ_, BK_)                                     \
  if (which == I)                                                         \
    return repro::query_kernel(                                           \
        reinterpret_cast<const void*>(                                    \
            &flash_attention_kernel<float, HD_, BQ_, BK_>),               \
        kThreads, smem_floats<HD_, BQ_, BK_>() * sizeof(float), out);
  FLASH_QUERY(0, 64, 128, 128)
  FLASH_QUERY(1, 64, 128, 64)
  FLASH_QUERY(2, 64, 64, 128)
  FLASH_QUERY(3, 64, 64, 64)
  FLASH_QUERY(4, 128, 128, 128)
  FLASH_QUERY(5, 128, 128, 64)
  FLASH_QUERY(6, 128, 64, 128)
  FLASH_QUERY(7, 128, 64, 64)
#undef FLASH_QUERY
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // extern "C"

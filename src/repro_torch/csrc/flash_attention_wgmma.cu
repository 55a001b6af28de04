// Causal flash attention forward for bf16 on Hopper's tensor cores:
// out = softmax(q k^T / sqrt(hd), causal) v over q (B, T, H, hd) and k, v
// (B, T, KV, hd), head h reading KV head h / (H / KV); with a sliding
// window W > 0, query i attends to keys j with i - W < j <= i.
//
// Replaces the TPU kernel flash_attention_kernel
// (src/repro/kernels/flash_attention/kernel.py:53, body _flash_kernel) for
// bf16 inputs; f32 inputs take the FFMA kernel in flash_attention.cu.
//
// Bound on the H100: operations. A causal pass does 4 hd T(T+1)/2 flops
// per (batch, head): 1.92 TFLOP per layer of qwen2-0.5B at T = 32,768,
// 1.95 ms at the bf16 tensor-core rate (989 TFLOP/s), against 0.13 GB of
// q, k, v and out (0.04 ms at 3.35 TB/s). Only wgmma reaches that rate.
// At hd 64 the softmax's exponentials (one per score, 16 per clock per SM
// on the MUFU pipe) take as long as the two products take on the tensor
// cores, so two consumer warpgroups run side by side: while one waits on
// its products, the other computes its softmax.
//
// Design (FlashAttention-3's shape, without its overlap inside one
// warpgroup): one block per (batch*head, BQ-row query tile), the longest
// walks launched first (with a window, every tile past the window walks
// as far: the order stays longest first, with ties); BQ/64 consumer
// warpgroups of 64 query rows
// and one producer warp. The producer loads the q tile once and streams
// the K and V tiles (BK x hd) through a ring of kStages slots by TMA
// (cp.async.bulk.tensor, 128-byte swizzle, rows past T filled with zeros)
// from tensor maps over the (B, T, H, hd) and (B, T, KV, hd) layouts with
// their own strides, so GQA and strided views cost no copy; full and empty
// mbarriers hand the slots over. Each consumer warpgroup computes
// S = q K^T by wgmma m64nBKk16 (both operands K-major in shared memory, f32
// accumulators in registers), masks only the tiles that cross its
// diagonal or its rows' window edge, keeps the online softmax (m, l) of
// its two rows per thread in
// registers with exp2 on a log2(e)-folded scale, rounds P to bf16 in
// registers (S's accumulator fragment is the A fragment of the next
// product) and adds P V by wgmma m64nHDk16 (A from registers, V MN-major
// in shared memory: the transpose bit). The sum l is taken over the f32
// P. The output acc / max(l, 1e-30) is rounded to bf16 once and written to
// a contiguous (B, T, H, hd), rows >= T skipped. The key tiles are walked
// from the diagonal down to the tile holding key q0 - W + 1, the first
// that the tile's first query sees (to 0 without a window); a warpgroup
// skips a tile whose keys all come after its rows or all lie before its
// rows' windows. So the first tile a warpgroup adds holds each of its
// rows' own key, and a row's max is a real score from then on: a masked
// score of -1e30 weighs exactly 0. hd 128 rows (256 bytes,
// over the swizzle's 128) are loaded as two 64-column boxes, and the wgmma
// descriptors step from one box to the next.

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cmath>
#include <cstdint>

#include "common.cuh"

namespace {

// -- PTX: shared addresses, mbarriers, TMA, wgmma -----------------------------

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_u32(bar)),
               "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
          smem_u32(bar)),
      "r"(bytes)
      : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(smem_u32(bar))
               : "memory");
}

// Wait until the phase of parity `parity` of the barrier has completed.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  const uint32_t addr = smem_u32(bar);
  uint32_t done = 0;
  do {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(addr), "r"(parity)
        : "memory");
  } while (!done);
}

// One box of a 4-d tensor map into shared memory; completes on `bar`.
__device__ __forceinline__ void tma_load_4d(void* dst, const CUtensorMap* map,
                                            uint64_t* bar, int c0, int c1,
                                            int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4, %5, %6}], [%2];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(c0),
      "r"(c1), "r"(c2), "r"(c3)
      : "memory");
}

// wgmma's shared-memory descriptor of a 128-byte-swizzled operand: rows of
// 128 bytes, 8-row groups 1024 bytes apart (the stride byte offset);
// `lbo` is the leading byte offset (the distance between the 64-column
// boxes of an MN-major operand; 16 for a K-major one, where it is unused).
__device__ __forceinline__ uint64_t sw128_desc(uint32_t addr, uint32_t lbo) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) |
         static_cast<uint64_t>((lbo >> 4) & 0x3FFF) << 16 |
         static_cast<uint64_t>(1024 >> 4) << 32 | 1ull << 62;
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_wait_all() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}

// After wgmma_wait_all: the registers an asynchronous wgmma wrote (or
// read) are taken as changed here, so no read of them moves above the wait
// and no other value takes their place before it.
template <int N>
__device__ __forceinline__ void fence_regs(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i])::"memory");
}
template <int N>
__device__ __forceinline__ void fence_regs(uint32_t (&a)[N][4]) {
#pragma unroll
  for (int i = 0; i < N; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) asm volatile("" : "+r"(a[i][j])::"memory");
}

// D (64 x 64) {+}= A (64 x 16) B (16 x 64), A and B K-major in shared memory
__device__ __forceinline__ void wgmma_ss(float (&d)[32], uint64_t da,
                                         uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, "
      "%12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31}, "
      "%32, %33, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "r"(scale_d));
}

// D (64 x 64) += A (64 x 16, registers) B (16 x 64, MN-major in shared memory)
__device__ __forceinline__ void wgmma_rs_tb(float (&d)[32],
                                            const uint32_t (&a)[4],
                                            uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, "
      "%12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// D (64 x 128) {+}= A (64 x 16) B (16 x 128), A and B K-major in shared memory
__device__ __forceinline__ void wgmma_ss(float (&d)[64], uint64_t da,
                                         uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, "
      "%12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, "
      "%36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, "
      "%60, %61, %62, %63}, "
      "%64, %65, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]),
        "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]),
        "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]),
        "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]),
        "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(da), "l"(db), "r"(scale_d));
}

// D (64 x 128) += A (64 x 16, registers) B (16 x 128, MN-major in shared memory)
__device__ __forceinline__ void wgmma_rs_tb(float (&d)[64],
                                            const uint32_t (&a)[4],
                                            uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, "
      "%12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, "
      "%36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, "
      "%60, %61, %62, %63}, "
      "{%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]),
        "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]),
        "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]),
        "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]),
        "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 p = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&p);
}

// -- the kernel ---------------------------------------------------------------

template <int HD, int BQ, int BK>
struct Tiles {
  static constexpr int kConsumers = BQ / 64;           // warpgroups of 64 rows
  static constexpr int kThreads = kConsumers * 128 + 32;  // + a producer warp
  static constexpr int kBoxes = HD / 64;  // 64-column boxes: 128 bytes a row
  static constexpr int kQBytes = BQ * HD * 2;
  static constexpr int kTileBytes = BK * HD * 2;       // one K or V tile
  static constexpr int kStages =
      (200 * 1024 - kQBytes) / (2 * kTileBytes) < 4
          ? (200 * 1024 - kQBytes) / (2 * kTileBytes)
          : 4;
  // + 1024 to align the tiles to the swizzle's 1024-byte period
  static constexpr int kSmem = kQBytes + 2 * kStages * kTileBytes + 1024;
  static_assert(kStages >= 2, "shared memory holds fewer than 2 stages");
};

template <int HD, int BQ, int BK>
__global__ void __launch_bounds__(Tiles<HD, BQ, BK>::kThreads, 1)
flash_attention_kernel_wgmma(const __grid_constant__ CUtensorMap tm_q,
                             const __grid_constant__ CUtensorMap tm_k,
                             const __grid_constant__ CUtensorMap tm_v,
                             __nv_bfloat16* __restrict__ o, int seq,
                             int heads, int n_rep, int window,
                             float scale_log2) {
  using C = Tiles<HD, BQ, BK>;
  constexpr int S = C::kStages;
  constexpr int NS = BK / 2;   // score accumulators per thread
  constexpr int NO = HD / 2;   // output accumulators per thread
  extern __shared__ unsigned char smem_raw[];
  __shared__ uint64_t full_k[S], full_v[S], empty[S], q_full;
  unsigned char* qs =
      smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  unsigned char* ks = qs + C::kQBytes;        // [S][kBoxes][BK][64] bf16
  unsigned char* vs = ks + S * C::kTileBytes;  // the same for V

  const int b = blockIdx.y / heads, h = blockIdx.y % heads;
  const int q0 = (gridDim.x - 1 - blockIdx.x) * BQ;
  const int q_last = min(q0 + BQ, seq) - 1;
  const int kt_end = q_last / BK + 1;  // key tiles holding a key <= q_last
  // the first key tile holding a key in q0's window
  const int kt0 = window > 0 ? max(0, q0 - window + 1) / BK : 0;
  const int n_kt = kt_end - kt0;  // walked from kt_end - 1 down to kt0
  const int warp = threadIdx.x / 32, lane = threadIdx.x & 31;

  if (threadIdx.x == 0) {
    for (int s = 0; s < S; ++s) {
      mbar_init(&full_k[s], 1);
      mbar_init(&full_v[s], 1);
      mbar_init(&empty[s], 4 * C::kConsumers);  // lane 0 of each consumer warp
    }
    mbar_init(&q_full, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (warp == 4 * C::kConsumers) {
    // producer: the q tile once, then K and V tiles from the diagonal down
    if (lane == 0) {
      const int kvh = h / n_rep;
      mbar_expect_tx(&q_full, C::kQBytes);
      for (int x = 0; x < C::kBoxes; ++x)
        tma_load_4d(qs + x * BQ * 128, &tm_q, &q_full, x * 64, q0, h, b);
      for (int i = 0; i < n_kt; ++i) {
        const int s = i % S, k0 = (kt_end - 1 - i) * BK;
        mbar_wait(&empty[s], ((i / S) & 1) ^ 1);  // round 0 passes at once
        unsigned char* kt = ks + s * C::kTileBytes;
        unsigned char* vt = vs + s * C::kTileBytes;
        mbar_expect_tx(&full_k[s], C::kTileBytes);
        for (int x = 0; x < C::kBoxes; ++x)
          tma_load_4d(kt + x * BK * 128, &tm_k, &full_k[s], x * 64, k0, kvh, b);
        mbar_expect_tx(&full_v[s], C::kTileBytes);
        for (int x = 0; x < C::kBoxes; ++x)
          tma_load_4d(vt + x * BK * 128, &tm_v, &full_v[s], x * 64, k0, kvh, b);
      }
    }
    return;
  }

  // consumer warpgroup wg: rows row0 .. row0 + 63; this thread holds rows
  // r0 and r0 + 8, columns c0 + 8 j + {0, 1} of each accumulator tile
  const int wg = warp / 4;
  const int row0 = q0 + wg * 64;
  const int r0 = row0 + (warp % 4) * 16 + lane / 4;
  const int c0 = 2 * (lane % 4);
  const uint32_t q_addr = smem_u32(qs) + wg * 64 * 128;
  float acc[NO];
#pragma unroll
  for (int i = 0; i < NO; ++i) acc[i] = 0.0f;
  float m_a = -1e30f, m_b = -1e30f, l_a = 0.0f, l_b = 0.0f;

  mbar_wait(&q_full, 0);
  for (int i = 0; i < n_kt; ++i) {
    const int s = i % S, k0 = (kt_end - 1 - i) * BK;
    const uint32_t parity = (i / S) & 1;
    mbar_wait(&full_k[s], parity);
    // every key of the tile comes after every row, or lies before every
    // row's window
    if (k0 > row0 + 63 || (window > 0 && k0 + BK - 1 <= row0 - window)) {
      if (lane == 0) mbar_arrive(&empty[s]);
      continue;
    }

    // S = q K^T, f32
    float sc[NS];
    const uint32_t k_addr = smem_u32(ks + s * C::kTileBytes);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < HD / 16; ++kk) {
      const uint32_t off = (kk % 4) * 32;  // 16 columns into the box
      wgmma_ss(sc, sw128_desc(q_addr + (kk / 4) * BQ * 128 + off, 16),
               sw128_desc(k_addr + (kk / 4) * BK * 128 + off, 16), kk > 0);
    }
    wgmma_commit();
    wgmma_wait_all();
    fence_regs(sc);

    // the tile crosses the diagonal or the window's edge of some row: mask
    const bool edge = window > 0 && k0 <= row0 + 63 - window;
    if (k0 + BK - 1 > row0 || edge) {
#pragma unroll
      for (int j = 0; j < BK / 8; ++j)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int col = k0 + 8 * j + c0 + e;
          if (col > r0 || (edge && col <= r0 - window)) sc[4 * j + e] = -1e30f;
          if (col > r0 + 8 || (edge && col <= r0 + 8 - window))
            sc[4 * j + 2 + e] = -1e30f;
        }
    }

    // online softmax of rows r0 (a) and r0 + 8 (b); a row lives in 4 lanes
    float mx_a = m_a, mx_b = m_b;
#pragma unroll
    for (int j = 0; j < BK / 8; ++j) {
      mx_a = fmaxf(mx_a, fmaxf(sc[4 * j], sc[4 * j + 1]));
      mx_b = fmaxf(mx_b, fmaxf(sc[4 * j + 2], sc[4 * j + 3]));
    }
#pragma unroll
    for (int off = 1; off < 4; off <<= 1) {
      mx_a = fmaxf(mx_a, __shfl_xor_sync(0xffffffffu, mx_a, off));
      mx_b = fmaxf(mx_b, __shfl_xor_sync(0xffffffffu, mx_b, off));
    }
    const float alpha_a = ex2((m_a - mx_a) * scale_log2);
    const float alpha_b = ex2((m_b - mx_b) * scale_log2);
    m_a = mx_a;
    m_b = mx_b;
    const float mb_a = mx_a * scale_log2, mb_b = mx_b * scale_log2;
    float rs_a = 0.0f, rs_b = 0.0f;
    uint32_t pa[BK / 16][4];  // P in bf16: the A fragments of P V
#pragma unroll
    for (int j = 0; j < BK / 8; ++j) {
      const float p0 = ex2(fmaf(sc[4 * j], scale_log2, -mb_a));
      const float p1 = ex2(fmaf(sc[4 * j + 1], scale_log2, -mb_a));
      const float p2 = ex2(fmaf(sc[4 * j + 2], scale_log2, -mb_b));
      const float p3 = ex2(fmaf(sc[4 * j + 3], scale_log2, -mb_b));
      rs_a += p0 + p1;
      rs_b += p2 + p3;
      pa[j / 2][(j % 2) * 2] = pack_bf16(p0, p1);
      pa[j / 2][(j % 2) * 2 + 1] = pack_bf16(p2, p3);
    }
    l_a = l_a * alpha_a + rs_a;  // partial over this thread's columns
    l_b = l_b * alpha_b + rs_b;
#pragma unroll
    for (int j = 0; j < HD / 8; ++j) {
      acc[4 * j] *= alpha_a;
      acc[4 * j + 1] *= alpha_a;
      acc[4 * j + 2] *= alpha_b;
      acc[4 * j + 3] *= alpha_b;
    }

    // acc += P V
    mbar_wait(&full_v[s], parity);
    const uint32_t v_addr = smem_u32(vs + s * C::kTileBytes);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk)
      wgmma_rs_tb(acc, pa[kk], sw128_desc(v_addr + kk * 16 * 128, BK * 128));
    wgmma_commit();
    wgmma_wait_all();
    fence_regs(acc);
    fence_regs(pa);
    if (lane == 0) mbar_arrive(&empty[s]);
  }

#pragma unroll
  for (int off = 1; off < 4; off <<= 1) {
    l_a += __shfl_xor_sync(0xffffffffu, l_a, off);
    l_b += __shfl_xor_sync(0xffffffffu, l_b, off);
  }
  const float d_a = fmaxf(l_a, 1e-30f), d_b = fmaxf(l_b, 1e-30f);
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int t = r0 + 8 * half;
    if (t >= seq) continue;
    const float d = half ? d_b : d_a;
    __nv_bfloat16* row =
        o + ((static_cast<long long>(b) * seq + t) * heads + h) * HD + c0;
#pragma unroll
    for (int j = 0; j < HD / 8; ++j)
      *reinterpret_cast<__nv_bfloat162*>(row + 8 * j) = __floats2bfloat162_rn(
          acc[4 * j + 2 * half] / d, acc[4 * j + 2 * half + 1] / d);
  }
}

// -- host: tensor maps and launch ---------------------------------------------

using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                                 void*, const cuuint64_t*, const cuuint64_t*,
                                 const cuuint32_t*, const cuuint32_t*,
                                 CUtensorMapInterleave, CUtensorMapSwizzle,
                                 CUtensorMapL2promotion,
                                 CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled from the driver, found through the runtime so the
// library need not link libcuda.
EncodeTiled encode_tiled() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    const cudaError_t err = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &found);
#else
    const cudaError_t err = cudaGetDriverEntryPoint(
        "cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found);
#endif
    if (err != cudaSuccess || found != cudaDriverEntryPointSuccess) return nullptr;
    fn = reinterpret_cast<EncodeTiled>(p);
  }
  return fn;
}

// A map over x (B, T, N, hd) bf16 with element strides (sb, st, sn), read
// in boxes of 64 columns by `rows` rows with the 128-byte swizzle; reads
// past T fill with zeros. Strides must be multiples of 8 elements (16
// bytes) and x 16-byte aligned: the wrapper checks both.
bool make_map(CUtensorMap* map, const void* x, int B, int T, int N, int hd,
              long long sb, long long st, long long sn, int rows) {
  const EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return false;
  const cuuint64_t dims[4] = {static_cast<cuuint64_t>(hd),
                              static_cast<cuuint64_t>(T),
                              static_cast<cuuint64_t>(N),
                              static_cast<cuuint64_t>(B)};
  const cuuint64_t strides[3] = {static_cast<cuuint64_t>(st) * 2,
                                 static_cast<cuuint64_t>(sn) * 2,
                                 static_cast<cuuint64_t>(sb) * 2};
  const cuuint32_t box[4] = {64, static_cast<cuuint32_t>(rows), 1, 1};
  const cuuint32_t unit[4] = {1, 1, 1, 1};
  return encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(x),
                dims, strides, box, unit, CU_TENSOR_MAP_INTERLEAVE_NONE,
                CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <int HD, int BQ, int BK>
int launch(const CUtensorMap& mq, const CUtensorMap& mk, const CUtensorMap& mv,
           __nv_bfloat16* o, int B, int seq, int H, int KV, int window,
           cudaStream_t stream) {
  using C = Tiles<HD, BQ, BK>;
  auto kernel = flash_attention_kernel_wgmma<HD, BQ, BK>;
  const cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, C::kSmem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((seq + BQ - 1) / BQ, B * H);
  // 1/sqrt(hd) log2(e): scores are exponentiated base 2
  const float scale_log2 =
      static_cast<float>(1.4426950408889634 / std::sqrt(double(HD)));
  kernel<<<grid, C::kThreads, C::kSmem, stream>>>(mq, mk, mv, o, seq, H,
                                                  H / KV, window, scale_log2);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// out (B, T, H, hd) contiguous = causal attention of bf16 q over k, v;
// each input by its batch, sequence and head strides (elements); window
// 0 for none, else the keys each query sees.
int flash_attention_bf16(const __nv_bfloat16* q, long long sqb, long long sqt,
                         long long sqh, const __nv_bfloat16* k, long long skb,
                         long long skt, long long skh, const __nv_bfloat16* v,
                         long long svb, long long svt, long long svh,
                         __nv_bfloat16* o, int B, int seq, int H, int KV,
                         int hd, int bq, int bk, int window,
                         cudaStream_t stream) {
  if (B == 0 || seq == 0 || H == 0) return 0;
  if (B * H > 65535 || KV <= 0 || H % KV != 0 || window < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  CUtensorMap mq, mk, mv;
  if (!make_map(&mq, q, B, seq, H, hd, sqb, sqt, sqh, bq) ||
      !make_map(&mk, k, B, seq, KV, hd, skb, skt, skh, bk) ||
      !make_map(&mv, v, B, seq, KV, hd, svb, svt, svh, bk))
    return static_cast<int>(cudaErrorInvalidValue);
#define FLASH_CASE(HD_, BQ_, BK_)                                              \
  if (hd == HD_ && bq == BQ_ && bk == BK_)                                     \
    return launch<HD_, BQ_, BK_>(mq, mk, mv, o, B, seq, H, KV, window, stream);
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

// Kernel `which` of the (hd, bq, bk) instantiations in the order of
// flash_attention_bf16's cases: its threads (a producer warp and a
// warpgroup per 64 query rows) and the dynamic shared bytes its launcher
// sets (Tiles::kSmem); args are not read.
int flash_attention_wgmma_launch_query(int which, const long long* args,
                                       long long* out) {
  (void)args;
#define FLASH_QUERY(I, HD_, BQ_, BK_)                                     \
  if (which == I)                                                         \
    return repro::query_kernel(                                           \
        reinterpret_cast<const void*>(                                    \
            &flash_attention_kernel_wgmma<HD_, BQ_, BK_>),                \
        Tiles<HD_, BQ_, BK_>::kThreads, Tiles<HD_, BQ_, BK_>::kSmem, out);
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

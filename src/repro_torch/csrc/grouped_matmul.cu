// Grouped matmul over the landed dispatch buffer:
//   out[g, c, :] = x[g, c, :] @ w[g % E]      for rows c < counts[g]
// and zero for rows at or past counts[g] (row-granular, also inside a
// partly occupied tile).  x: (G, C, K) contiguous; w: E weights (K, N) read
// through their strides; out: (G, C, N) contiguous in x's dtype; f32
// accumulation.
//
// Replaces the Pallas kernel repro/kernels/grouped_matmul.py:grouped_matmul
// (_gmm_kernel).  In the port it carries the row-masked products of the
// fused SwiGLU backward (repro_torch/kernels/ref.py:fused_swiglu_bwd, the
// recompute of repro/kernels/ops.py:129-148): h = x@w1, u = x@w3,
// da = dy@w2^T and dx = dh@w1^T + du@w3^T, five launches per MoE layer and
// training step.
//
// Weights are read through strides, so a transposed view of the expert
// weights (w2^T, w1^T, w3^T: the k stride is 1) is taken as it is; copying
// it would cost 403 MB per copy per layer at full width.  At EP > 1 the
// landed buffer is (S, E, C, .) with the S source lanes sharing each
// expert's weights: one launch takes all G = S * E groups and group g reads
// weight g % E (a group-to-weight map, not one launch per lane).
//
// Bound on the H100 at the training shape (qwen3-moe-30b-a3b, B 4 x S 512,
// 128 experts, top-8, capacity 256 = _cap(2048 * 8 / 128, 2.0)): each
// (128, 256, 2048) x (128, 2048, 768) bf16 product reads 403 MB of weights,
// ~0.12 ms at 3.35 TB/s, and does 103 GFLOP over all rows, ~0.10 ms at
// 989 TFLOP/s; with about half the rows live it is bytes-bound.
//
// Design.  One block per (column tile, row tile, group); the blocks run in
// no order and nothing carries between them: the contraction is a loop
// inside the block.  The block reads counts[g] itself; a tile wholly at or
// past it writes zeros without reading x or w.  Rows at or past counts[g]
// inside a partial tile are never read (zero-filled in shared memory) and
// are written as zeros.  Any C, K and N are taken (the ragged edges are
// masked); the reduced model's K 64 / N 32 runs.
//
// gmm_tc (bf16): 64 x 64 output tiles, 4 warps of 32 x 32, WMMA
// (mma.sync, bf16 in, f32 accumulate) over 32-deep k steps; the x and w
// tiles of step k + 1 are copied by cp.async (16 bytes a thread) while step
// k multiplies (two stages).  It needs K and N multiples of 8, 16-byte
// aligned operands, and w with unit stride along n or along k (the wrapper
// checks).  gmm_fma (float32): the same tiling with FMA on the CUDA cores,
// any strides; no TF32, so f32 stays exact enough for the 1e-3 card-vs-CPU
// check.
//
// What the simple design leaves on the table: each row tile re-reads its
// expert's weights (from L2 when the tiles of one group run together), and
// WMMA from a two-stage ring does not reach the wgmma rate.  One pass over
// each expert's weights with wgmma and TMA is later work.
#include <mma.h>

#include <type_traits>

#include "common.cuh"

namespace {

using bf16 = __nv_bfloat16;

constexpr int kBM = 64;   // rows of x per tile
constexpr int kBN = 64;   // output columns per tile
constexpr int kBK = 32;   // contraction depth per step (gmm_tc)
constexpr int kPad = 8;   // bf16 of padding per shared row (16 bytes)
constexpr int kTcThreads = 128;
constexpr int kLdA = kBK + kPad;                 // As [2][kBM][kLdA]
constexpr int kLdBRow = kBN + kPad;              // Bs [2][kBK][kLdBRow] (n unit stride)
constexpr int kLdBCol = kBK + kPad;              // Bs [2][kBN][kLdBCol] (k unit stride)
constexpr int kLdC = kBN + 4;                    // Cs [kBM][kLdC] f32
constexpr int kABytes = 2 * kBM * kLdA * 2;
constexpr int kBBytes = 2 * kBN * kLdBCol * 2;   // >= 2 * kBK * kLdBRow * 2

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(gmem));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}
__device__ __forceinline__ void zero16(void* smem) {
  *reinterpret_cast<uint4*>(smem) = make_uint4(0, 0, 0, 0);
}

// Zeros for the rows [0, rows) x columns [n0, n0 + kBN) of a tile.
template <typename T>
__device__ void write_zero_tile(T* o, int rows, int n0, int N, int tid,
                                int threads) {
  const int cols = min(kBN, N - n0);
  for (int q = tid; q < rows * cols; q += threads)
    o[static_cast<size_t>(q / cols) * N + n0 + q % cols] = repro::from_f32<T>(0.f);
}

// kKMajorB: w's unit stride is along k (a transposed view); else along n.
template <bool kKMajorB>
__global__ void __launch_bounds__(kTcThreads)
    gmm_tc(const bf16* __restrict__ x, const bf16* __restrict__ w,
           const int* __restrict__ counts, bf16* __restrict__ out, int E,
           int C, int K, int N, int sw_e, int ldw) {
  using namespace nvcuda;
  using LayoutB = std::conditional_t<kKMajorB, wmma::col_major, wmma::row_major>;
  using FragA = wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major>;
  using FragB = wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, LayoutB>;
  using FragC = wmma::fragment<wmma::accumulator, 16, 16, 16, float>;

  const int n0 = blockIdx.x * kBN;
  const int m0 = blockIdx.y * kBM;
  const int g = blockIdx.z;
  const int tid = threadIdx.x;
  const int rows = min(kBM, C - m0);
  const int live = max(0, min(rows, counts[g] - m0));
  bf16* o = out + (static_cast<size_t>(g) * C + m0) * N;
  if (live == 0) {  // the whole tile is past the group's occupancy
    write_zero_tile(o, rows, n0, N, tid, kTcThreads);
    return;
  }

  __shared__ __align__(128) unsigned char smem[kABytes + kBBytes + kBM * kLdC * 4];
  bf16* As = reinterpret_cast<bf16*>(smem);
  bf16* Bs = reinterpret_cast<bf16*>(smem + kABytes);
  float* Cs = reinterpret_cast<float*>(smem + kABytes + kBBytes);

  const bf16* xg = x + (static_cast<size_t>(g) * C + m0) * K;
  const bf16* wg = w + static_cast<size_t>(g % E) * sw_e;

  // one k step's tiles into stage st: 256 chunks of 8 bf16 for each of A
  // and B, two of each per thread; chunks outside the live rows or the
  // matrix are zero-filled, never read
  auto load = [&](int k0, int st) {
    bf16* a = As + st * kBM * kLdA;
    bf16* b = Bs + st * kBN * kLdBCol;
    for (int q = tid; q < kBM * (kBK / 8); q += kTcThreads) {
      const int r = q / (kBK / 8), kc = (q % (kBK / 8)) * 8;
      bf16* dst = a + r * kLdA + kc;
      if (r < live && k0 + kc < K)
        cp_async16(dst, xg + static_cast<size_t>(r) * K + k0 + kc);
      else
        zero16(dst);
    }
    if constexpr (kKMajorB) {  // element (k, n) at wg[n * ldw + k] -> b[n][k]
      for (int q = tid; q < kBN * (kBK / 8); q += kTcThreads) {
        const int n = q / (kBK / 8), kc = (q % (kBK / 8)) * 8;
        bf16* dst = b + n * kLdBCol + kc;
        if (n0 + n < N && k0 + kc < K)
          cp_async16(dst, wg + static_cast<size_t>(n0 + n) * ldw + k0 + kc);
        else
          zero16(dst);
      }
    } else {  // element (k, n) at wg[k * ldw + n] -> b[k][n]
      for (int q = tid; q < kBK * (kBN / 8); q += kTcThreads) {
        const int k = q / (kBN / 8), nc = (q % (kBN / 8)) * 8;
        bf16* dst = b + k * kLdBRow + nc;
        if (k0 + k < K && n0 + nc < N)
          cp_async16(dst, wg + static_cast<size_t>(k0 + k) * ldw + n0 + nc);
        else
          zero16(dst);
      }
    }
  };

  const int warp = tid / 32;
  const int wm = (warp / 2) * 32, wn = (warp % 2) * 32;
  FragC acc[2][2];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 2; ++j) wmma::fill_fragment(acc[i][j], 0.f);

  const int nk = (K + kBK - 1) / kBK;
  load(0, 0);
  cp_async_commit();
  for (int kt = 0; kt < nk; ++kt) {
    if (kt + 1 < nk) load((kt + 1) * kBK, (kt + 1) & 1);
    cp_async_commit();
    cp_async_wait<1>();  // step kt has landed
    __syncthreads();
    const bf16* a = As + (kt & 1) * kBM * kLdA;
    const bf16* b = Bs + (kt & 1) * kBN * kLdBCol;
#pragma unroll
    for (int kk = 0; kk < kBK; kk += 16) {
      FragA fa[2];
      FragB fb[2];
#pragma unroll
      for (int i = 0; i < 2; ++i)
        wmma::load_matrix_sync(fa[i], a + (wm + 16 * i) * kLdA + kk, kLdA);
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        if constexpr (kKMajorB)
          wmma::load_matrix_sync(fb[j], b + (wn + 16 * j) * kLdBCol + kk, kLdBCol);
        else
          wmma::load_matrix_sync(fb[j], b + kk * kLdBRow + wn + 16 * j, kLdBRow);
      }
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int j = 0; j < 2; ++j) wmma::mma_sync(acc[i][j], fa[i], fb[j], acc[i][j]);
    }
    __syncthreads();  // the stage is refilled by the next step
  }
  cp_async_wait<0>();

#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 2; ++j)
      wmma::store_matrix_sync(Cs + (wm + 16 * i) * kLdC + wn + 16 * j, acc[i][j],
                              kLdC, wmma::mem_row_major);
  __syncthreads();
  const int cols = min(kBN, N - n0);
  for (int q = tid; q < rows * cols; q += kTcThreads) {
    const int r = q / cols, c = q % cols;
    o[static_cast<size_t>(r) * N + n0 + c] =
        __float2bfloat16(r < live ? Cs[r * kLdC + c] : 0.f);
  }
}

constexpr int kFmaThreads = 256;  // 16 x 16 threads, 4 x 4 outputs each
constexpr int kFmaBK = 16;

__global__ void __launch_bounds__(kFmaThreads)
    gmm_fma(const float* __restrict__ x, const float* __restrict__ w,
            const int* __restrict__ counts, float* __restrict__ out, int E,
            int C, int K, int N, int sw_e, int sw_k, int sw_n) {
  const int n0 = blockIdx.x * kBN;
  const int m0 = blockIdx.y * kBM;
  const int g = blockIdx.z;
  const int tid = threadIdx.x;
  const int rows = min(kBM, C - m0);
  const int live = max(0, min(rows, counts[g] - m0));
  float* o = out + (static_cast<size_t>(g) * C + m0) * N;
  if (live == 0) {
    write_zero_tile(o, rows, n0, N, tid, kFmaThreads);
    return;
  }

  __shared__ float As[kFmaBK][kBM];  // k-major: a thread reads a row of 4
  __shared__ float Bs[kFmaBK][kBN];
  const float* xg = x + (static_cast<size_t>(g) * C + m0) * K;
  const float* wg = w + static_cast<size_t>(g % E) * sw_e;
  const int ty = tid / 16, tx = tid % 16;
  float acc[4][4] = {};

  for (int k0 = 0; k0 < K; k0 += kFmaBK) {
    for (int q = tid; q < kBM * kFmaBK; q += kFmaThreads) {
      const int r = q / kFmaBK, kk = q % kFmaBK;
      As[kk][r] = (r < live && k0 + kk < K)
                      ? xg[static_cast<size_t>(r) * K + k0 + kk] : 0.f;
    }
    for (int q = tid; q < kFmaBK * kBN; q += kFmaThreads) {
      const int kk = q / kBN, c = q % kBN;
      Bs[kk][c] = (k0 + kk < K && n0 + c < N)
                      ? wg[static_cast<size_t>(k0 + kk) * sw_k +
                           static_cast<size_t>(n0 + c) * sw_n]
                      : 0.f;
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < kFmaBK; ++kk) {
      float a[4], b[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) a[i] = As[kk][ty + 16 * i];
#pragma unroll
      for (int j = 0; j < 4; ++j) b[j] = Bs[kk][tx + 16 * j];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
    }
    __syncthreads();
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = ty + 16 * i;
    if (r >= rows) continue;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int c = n0 + tx + 16 * j;
      if (c < N) o[static_cast<size_t>(r) * N + c] = r < live ? acc[i][j] : 0.f;
    }
  }
}

}  // namespace

// x: (G, C, K) contiguous; w: E weights, element (e, k, n) at
// w[e * sw_e + k * sw_k + n * sw_n]; group g reads weight g % E; counts:
// (G,) int32; out: (G, C, N) contiguous.  dtype kBF16 takes the tensor
// cores and needs sw_n == 1 or sw_k == 1, K % 8 == 0, N % 8 == 0, sw_e and
// the other stride multiples of 8 and 16-byte aligned x, w and out; kF32
// takes FMA and any strides.
extern "C" int grouped_matmul(const void* x, const void* w, const void* counts,
                              void* out, int G, int E, int C, int K, int N,
                              int sw_e, int sw_k, int sw_n, int dtype,
                              void* stream) {
  if (G == 0 || C == 0 || N == 0) return static_cast<int>(cudaSuccess);
  if (E <= 0 || G > 65535) return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid((N + kBN - 1) / kBN, (C + kBM - 1) / kBM, G);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case repro::kF32:
      gmm_fma<<<grid, kFmaThreads, 0, st>>>(
          static_cast<const float*>(x), static_cast<const float*>(w),
          static_cast<const int*>(counts), static_cast<float*>(out), E, C, K,
          N, sw_e, sw_k, sw_n);
      break;
    case repro::kBF16:
      if (K % 8 != 0 || N % 8 != 0 || sw_e % 8 != 0)
        return static_cast<int>(cudaErrorInvalidValue);
      if (sw_n == 1 && sw_k % 8 == 0)
        gmm_tc<false><<<grid, kTcThreads, 0, st>>>(
            static_cast<const bf16*>(x), static_cast<const bf16*>(w),
            static_cast<const int*>(counts), static_cast<bf16*>(out), E, C, K,
            N, sw_e, sw_k);
      else if (sw_k == 1 && sw_n % 8 == 0)
        gmm_tc<true><<<grid, kTcThreads, 0, st>>>(
            static_cast<const bf16*>(x), static_cast<const bf16*>(w),
            static_cast<const int*>(counts), static_cast<bf16*>(out), E, C, K,
            N, sw_e, sw_n);
      else
        return static_cast<int>(cudaErrorInvalidValue);
      break;
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

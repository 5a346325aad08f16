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
// 989 TFLOP/s; with about half the rows live it is bytes-bound.  A weight
// tile is read once per live 128-row tile of its group (from the L2 after
// the first), and an x row tile once per 256-column tile.  What holds the
// kernel back on this card is one SM's TMA stream (a loads-only build takes
// ~0.96 of its time; PERF.md): ~48 KiB a k step out of the L2.  A
// persistent form that overlapped the blocks' fill and drain, with static
// or dynamic tile order, was no faster.
//
// gmm_wgmma (bf16; the Hopper form, on the core of hopper.cuh).  One block
// per (256-column tile, 128-row tile, group), flattened into blockIdx.x
// with the column tiles fastest, so the tiles of one group run together and
// share its expert's weights and its x rows through the L2; no G limit.
// 288 threads: two consumer warpgroups (64 rows each, a 64 x 256 f32
// accumulator on wgmma m64n256k16) and one producer warp whose first lane
// streams (x 128 x 64, w 64 x 256) k-steps with TMA through a kGStages
// ring guarded by full/empty mbarriers; a warpgroup keeps one k-step's
// products in flight and releases the stage before it.  x is loaded
// K-major through a 3-D (K, C, G) map, so a tile crossing C reads zeros,
// never the next group's rows.  Both weight layouts come from the same storage with no copy: a
// row-major w (n contiguous) is loaded MN-major as four 64 x 64 boxes and
// fed to wgmma with its B-transpose bit; a transposed view (k contiguous)
// is loaded K-major as one 64 x 256 box; each map is built over the
// tensor's own strides.  A tile wholly at or past counts[g] writes zeros
// without loads; the second 64-row half of x is not loaded when all its
// rows are past it (both warpgroups still multiply, so the wgmma path is
// uniform); rows at or past counts are stored as zeros, whatever was read.
// Ragged K and N read zeros past the extents (TMA), and stores are masked.
//
// gmm_fma (float32): 64 x 64 tiles, FMA on the CUDA cores, any strides; no
// TF32, so f32 stays exact enough for the 1e-3 card-vs-CPU check.
//
// gmm_swiglu_wgmma (bf16; the C entry grouped_swiglu): the gate/up half of
// fused_swiglu (repro/kernels/fused_staging.py:fused_swiglu_pallas) where f
// is too wide for fused_swiglu.cu's Hopper form to keep 64 x f activations
// resident in shared memory (f above ~1472: deepseek-v3-bench's 2048,
// mixtral-8x22b's 16384):
//   a[g, c, :] = silu(x[g, c, :] @ w1[g % E]) * (x[g, c, :] @ w3[g % E])
// for rows c < counts[g], zero past it, written in bf16; the caller then
// runs grouped_matmul(a, w2).  The layout is gmm_wgmma's with two B
// operands: one block per (128-column tile, 128-row tile, group), a stage
// holding the x k-step (128 x 64) and the same 64 x 128 k-step of w1 and of
// w3 (two 64 x 64 MN-major boxes each, row-major weights only), 48 KiB as
// gmm_wgmma's; each consumer warpgroup keeps two 64 x 128 f32 accumulators
// (h and u, wgmma m64n128k16) and applies silu(h) * u in registers before
// the store, so h and u never reach device memory.  At mixtral's prefill
// shape (8 x 2048 x 6144 against 16384) the (G, C, f) bf16 buffer is about
// 11 % of the three weights' bytes (1 % at deepseek's).
#include <climits>

#include "common.cuh"
#include "hopper.cuh"

namespace {

using bf16 = __nv_bfloat16;

constexpr int kBM = 64;   // gmm_fma: rows of x per tile
constexpr int kBN = 64;   // gmm_fma: output columns per tile

// Zeros for the rows [0, rows) x columns [n0, n0 + kBN) of a tile.
template <typename T>
__device__ void write_zero_tile(T* o, int rows, int n0, int N, int tid,
                                int threads) {
  const int cols = min(kBN, N - n0);
  for (int q = tid; q < rows * cols; q += threads)
    o[static_cast<size_t>(q / cols) * N + n0 + q % cols] = repro::from_f32<T>(0.f);
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

constexpr int kGBM = 128;  // gmm_wgmma: rows per tile, 64 per warpgroup
constexpr int kGBN = 256;  // gmm_wgmma: output columns per tile
constexpr int kGBK = 64;   // contraction depth of a stage
constexpr int kGStages = 4;
constexpr int kGABytes = kGBM * kGBK * 2;  // 16 KiB
constexpr int kGBBytes = kGBK * kGBN * 2;  // 32 KiB
constexpr int kGStageBytes = kGABytes + kGBBytes;
constexpr int kGSmem = 1024 + 256 + kGStages * kGStageBytes;  // slack, barriers, ring
constexpr int kGThreads = 288;

// kKMajorB: w's unit stride is along k (a transposed view); else along n.
template <bool kKMajorB>
__global__ void __launch_bounds__(kGThreads, 1)
    gmm_wgmma(const __grid_constant__ CUtensorMap xmap,
              const __grid_constant__ CUtensorMap wmap,
              const int* __restrict__ counts, bf16* __restrict__ out, int E,
              int C, int K, int N, int m_tiles, int n_tiles) {
  using namespace hopper;
  const int n_t = blockIdx.x % n_tiles;
  const int m_t = (blockIdx.x / n_tiles) % m_tiles;
  const int g = blockIdx.x / n_tiles / m_tiles;
  const int n0 = n_t * kGBN, m0 = m_t * kGBM;
  const int tid = threadIdx.x;
  const int rows = min(kGBM, C - m0);
  const int cols = min(kGBN, N - n0);
  const int live = max(0, min(rows, counts[g] - m0));
  bf16* o = out + (static_cast<size_t>(g) * C + m0) * N + n0;
  if (live == 0) {  // the whole tile is past the group's occupancy
    zero_rows(o, N, rows, cols, tid, kGThreads);
    return;
  }

  extern __shared__ __align__(1024) unsigned char smem_g[];
  uint64_t* full = reinterpret_cast<uint64_t*>(smem_g);  // [kGStages]
  uint64_t* empty = full + kGStages;                      // [kGStages]
  const uint32_t s0 = smem_addr(smem_g);
  unsigned char* ring = smem_g + (((s0 + 256 + 1023) & ~1023u) - s0);
  const int nk = (K + kGBK - 1) / kGBK;

  if (tid == 0) {
    for (int i = 0; i < kGStages; ++i) {
      mbar_init(&full[i], 1);
      mbar_init(&empty[i], 8);  // lane 0 of each consumer warp
    }
    fence_barrier_init();
  }
  __syncthreads();

  const int warp = tid / 32;
  if (warp == 8) {  // producer: one lane issues every load
    if (tid % 32 == 0) {
      prefetch_map(&xmap);
      prefetch_map(&wmap);
      const int e = g % E;
      const bool two_halves = live > 64;
      const int stage_bytes = kGStageBytes - (two_halves ? 0 : kGABytes / 2);
      int st = 0;
      uint32_t ph = 0;
      for (int kt = 0; kt < nk; ++kt) {
        mbar_wait(&empty[st], ph ^ 1);
        unsigned char* slot = ring + st * kGStageBytes;
        if constexpr (!kLoads) {
          mbar_arrive(&full[st]);
        } else {
          mbar_expect_tx(&full[st], stage_bytes);
          // x: two 64-row boxes; a second half wholly past counts[g] is not
          // read (its stale rows are stored as zeros)
          tma_load_3d(slot, &xmap, &full[st], kt * kGBK, m0, g);
          if (two_halves)
            tma_load_3d(slot + kGABytes / 2, &xmap, &full[st], kt * kGBK, m0 + 64,
                        g);
          if constexpr (kKMajorB) {  // one 64 (k) x 256 (n rows) box
            tma_load_3d(slot + kGABytes, &wmap, &full[st], kt * kGBK, n0, e);
          } else {  // four 64 (n) x 64 (k rows) boxes
            for (int q = 0; q < 4; ++q)
              tma_load_3d(slot + kGABytes + q * kBoxBytes, &wmap, &full[st],
                          n0 + 64 * q, kt * kGBK, e);
          }
        }
        if (++st == kGStages) { st = 0; ph ^= 1; }
      }
    }
  } else {  // consumers: warpgroup wg owns rows [64 wg, 64 wg + 64)
    const int wg = warp / 4;
    const int t = tid % 128;
    float acc[128];  // the first product (kt = 0, kk = 0) overwrites it
    int st = 0, prev = -1;
    uint32_t ph = 0;
    for (int kt = 0; kt < nk; ++kt) {
      mbar_wait(&full[st], ph);
      {
        const unsigned char* slot = ring + st * kGStageBytes;
        const unsigned char* a = slot + wg * (kGABytes / 2);
        const unsigned char* b = slot + kGABytes;
        fence_acc(acc);
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < kGBK / 16 && kProducts; ++kk) {
          const uint64_t da = desc(a + 32 * kk, 16, 1024);
          if constexpr (kKMajorB)
            wgmma_m64n256k16<0>(acc, da, desc(b + 32 * kk, 16, 1024),
                                (kt | kk) != 0);
          else
            wgmma_m64n256k16<1>(acc, da, desc(b + 2048 * kk, kBoxBytes, 1024),
                                (kt | kk) != 0);
        }
        wgmma_commit();
        wgmma_wait<1>();  // the previous stage's products are done
        fence_acc(acc);
      }
      if (prev >= 0 && t % 32 == 0) mbar_arrive(&empty[prev]);
      prev = st;
      if (++st == kGStages) { st = 0; ph ^= 1; }
    }
    wgmma_wait<0>();
    fence_acc(acc);
    store_acc(o + static_cast<size_t>(64 * wg) * N, N, rows - 64 * wg,
              live - 64 * wg, cols, acc, t);
  }
}

constexpr int kSBN = 128;  // gmm_swiglu_wgmma: output columns per tile

__global__ void __launch_bounds__(kGThreads, 1)
    gmm_swiglu_wgmma(const __grid_constant__ CUtensorMap xmap,
                     const __grid_constant__ CUtensorMap w1map,
                     const __grid_constant__ CUtensorMap w3map,
                     const int* __restrict__ counts, bf16* __restrict__ out,
                     int E, int C, int K, int N, int m_tiles, int n_tiles) {
  using namespace hopper;
  const int n_t = blockIdx.x % n_tiles;
  const int m_t = (blockIdx.x / n_tiles) % m_tiles;
  const int g = blockIdx.x / n_tiles / m_tiles;
  const int n0 = n_t * kSBN, m0 = m_t * kGBM;
  const int tid = threadIdx.x;
  const int rows = min(kGBM, C - m0);
  const int cols = min(kSBN, N - n0);
  const int live = max(0, min(rows, counts[g] - m0));
  bf16* o = out + (static_cast<size_t>(g) * C + m0) * N + n0;
  if (live == 0) {  // the whole tile is past the group's occupancy
    zero_rows(o, N, rows, cols, tid, kGThreads);
    return;
  }

  extern __shared__ __align__(1024) unsigned char smem_s[];
  uint64_t* full = reinterpret_cast<uint64_t*>(smem_s);  // [kGStages]
  uint64_t* empty = full + kGStages;                      // [kGStages]
  const uint32_t s0 = smem_addr(smem_s);
  unsigned char* ring = smem_s + (((s0 + 256 + 1023) & ~1023u) - s0);
  const int nk = (K + kGBK - 1) / kGBK;

  if (tid == 0) {
    for (int i = 0; i < kGStages; ++i) {
      mbar_init(&full[i], 1);
      mbar_init(&empty[i], 8);  // lane 0 of each consumer warp
    }
    fence_barrier_init();
  }
  __syncthreads();

  const int warp = tid / 32;
  if (warp == 8) {  // producer: one lane issues every load
    if (tid % 32 == 0) {
      prefetch_map(&xmap);
      prefetch_map(&w1map);
      prefetch_map(&w3map);
      const int e = g % E;
      const bool two_halves = live > 64;
      const int stage_bytes = kGStageBytes - (two_halves ? 0 : kGABytes / 2);
      int st = 0;
      uint32_t ph = 0;
      for (int kt = 0; kt < nk; ++kt) {
        mbar_wait(&empty[st], ph ^ 1);
        unsigned char* slot = ring + st * kGStageBytes;
        if constexpr (!kLoads) {
          mbar_arrive(&full[st]);
        } else {
          mbar_expect_tx(&full[st], stage_bytes);
          tma_load_3d(slot, &xmap, &full[st], kt * kGBK, m0, g);
          if (two_halves)
            tma_load_3d(slot + kGABytes / 2, &xmap, &full[st], kt * kGBK, m0 + 64,
                        g);
          // w1 then w3: two 64 (n) x 64 (k rows) boxes each
          for (int q = 0; q < 2; ++q) {
            tma_load_3d(slot + kGABytes + q * kBoxBytes, &w1map, &full[st],
                        n0 + 64 * q, kt * kGBK, e);
            tma_load_3d(slot + kGABytes + (2 + q) * kBoxBytes, &w3map,
                        &full[st], n0 + 64 * q, kt * kGBK, e);
          }
        }
        if (++st == kGStages) { st = 0; ph ^= 1; }
      }
    }
  } else {  // consumers: warpgroup wg owns rows [64 wg, 64 wg + 64)
    const int wg = warp / 4;
    const int t = tid % 128;
    float h[64], u[64];  // the first products (kt = 0, kk = 0) overwrite them
    int st = 0, prev = -1;
    uint32_t ph = 0;
    for (int kt = 0; kt < nk; ++kt) {
      mbar_wait(&full[st], ph);
      {
        const unsigned char* slot = ring + st * kGStageBytes;
        const unsigned char* a = slot + wg * (kGABytes / 2);
        const unsigned char* b1 = slot + kGABytes;
        const unsigned char* b3 = b1 + 2 * kBoxBytes;
        fence_acc(h);
        fence_acc(u);
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < kGBK / 16 && kProducts; ++kk) {
          const uint64_t da = desc(a + 32 * kk, 16, 1024);
          wgmma_m64n128k16<1>(h, da, desc(b1 + 2048 * kk, kBoxBytes, 1024),
                              (kt | kk) != 0);
          wgmma_m64n128k16<1>(u, da, desc(b3 + 2048 * kk, kBoxBytes, 1024),
                              (kt | kk) != 0);
        }
        wgmma_commit();
        wgmma_wait<1>();  // the previous stage's products are done
        fence_acc(h);
        fence_acc(u);
      }
      if (prev >= 0 && t % 32 == 0) mbar_arrive(&empty[prev]);
      prev = st;
      if (++st == kGStages) { st = 0; ph ^= 1; }
    }
    wgmma_wait<0>();
    fence_acc(h);
    fence_acc(u);
#pragma unroll
    for (int i = 0; i < 64; ++i) h[i] = h[i] / (1.f + __expf(-h[i])) * u[i];
    store_acc(o + static_cast<size_t>(64 * wg) * N, N, rows - 64 * wg,
              live - 64 * wg, cols, h, t);
  }
}

int launch_wgmma(const void* x, const void* w, const void* counts, void* out,
                 int G, int E, int C, int K, int N, int sw_e, int sw_k,
                 int sw_n, cudaStream_t st) {
  if (K % 8 != 0 || N % 8 != 0 || sw_e % 8 != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const bool mn_major = sw_n == 1 && sw_k % 8 == 0;
  const bool k_major = !mn_major && sw_k == 1 && sw_n % 8 == 0;
  if (!mn_major && !k_major) return static_cast<int>(cudaErrorInvalidValue);
  if (K == 0)  // an empty contraction: every row is zero
    return static_cast<int>(cudaMemsetAsync(
        out, 0, static_cast<size_t>(G) * C * N * sizeof(bf16), st));
  const int m_tiles = (C + kGBM - 1) / kGBM, n_tiles = (N + kGBN - 1) / kGBN;
  const long long blocks = static_cast<long long>(G) * m_tiles * n_tiles;
  if (blocks > INT_MAX) return static_cast<int>(cudaErrorInvalidValue);
  const uint64_t es = sizeof(bf16);
  const uint64_t uk = K, un = N, uc = C;
  CUtensorMap xm, wm;
  bool ok = hopper::make_map_3d(&xm, x, uk, uc, G, uk * es, uc * uk * es,
                                kGBK, kGBM / 2);
  if (mn_major)
    ok = ok && hopper::make_map_3d(&wm, w, un, uk, E, sw_k * es, sw_e * es, 64,
                                   kGBK);
  else
    ok = ok && hopper::make_map_3d(&wm, w, uk, un, E, sw_n * es, sw_e * es,
                                   kGBK, kGBN);
  if (!ok) return hopper::kErrTensorMap;
  const auto kernel = mn_major ? gmm_wgmma<false> : gmm_wgmma<true>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kGSmem);
  if (err != cudaSuccess) return static_cast<int>(err);
  kernel<<<static_cast<unsigned>(blocks), kGThreads, kGSmem, st>>>(
      xm, wm, static_cast<const int*>(counts), static_cast<bf16*>(out), E, C,
      K, N, m_tiles, n_tiles);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// x: (G, C, K) contiguous bf16; w1, w3: E row-major (K, N) weights each,
// expert e at w1 + e * sw_e (sw_e and N multiples of 8, 16-byte aligned);
// counts: (G,) int32; out: (G, C, N) contiguous bf16, silu(x @ w1) * (x @
// w3) per group, rows at or past counts[g] zero (gmm_swiglu_wgmma).  Returns
// hopper::kErrTensorMap if TMA refuses a map.
extern "C" int grouped_swiglu(const void* x, const void* w1, const void* w3,
                              const void* counts, void* out, int G, int E,
                              int C, int K, int N, int sw_e, void* stream) {
  if (G == 0 || C == 0 || N == 0) return static_cast<int>(cudaSuccess);
  if (E <= 0 || K <= 0 || K % 8 != 0 || N % 8 != 0 || sw_e % 8 != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int m_tiles = (C + kGBM - 1) / kGBM, n_tiles = (N + kSBN - 1) / kSBN;
  const long long blocks = static_cast<long long>(G) * m_tiles * n_tiles;
  if (blocks > INT_MAX) return static_cast<int>(cudaErrorInvalidValue);
  const uint64_t es = sizeof(bf16);
  const uint64_t uk = K, un = N, uc = C;
  CUtensorMap xm, w1m, w3m;
  bool ok = hopper::make_map_3d(&xm, x, uk, uc, G, uk * es, uc * uk * es,
                                kGBK, kGBM / 2);
  ok = ok && hopper::make_map_3d(&w1m, w1, un, uk, E, un * es, sw_e * es, 64,
                                 kGBK);
  ok = ok && hopper::make_map_3d(&w3m, w3, un, uk, E, un * es, sw_e * es, 64,
                                 kGBK);
  if (!ok) return hopper::kErrTensorMap;
  cudaError_t err = cudaFuncSetAttribute(
      gmm_swiglu_wgmma, cudaFuncAttributeMaxDynamicSharedMemorySize, kGSmem);
  if (err != cudaSuccess) return static_cast<int>(err);
  gmm_swiglu_wgmma<<<static_cast<unsigned>(blocks), kGThreads, kGSmem, st>>>(
      xm, w1m, w3m, static_cast<const int*>(counts), static_cast<bf16*>(out), E,
      C, K, N, m_tiles, n_tiles);
  return static_cast<int>(cudaGetLastError());
}

// x: (G, C, K) contiguous; w: E weights, element (e, k, n) at
// w[e * sw_e + k * sw_k + n * sw_n]; group g reads weight g % E; counts:
// (G,) int32; out: (G, C, N) contiguous.  dtype kBF16 takes the Hopper form
// and needs sw_n == 1 or sw_k == 1, K % 8 == 0, N % 8 == 0, sw_e and the
// other stride multiples of 8 and 16-byte aligned x, w and out (returns
// hopper::kErrTensorMap if TMA refuses a map); kF32 takes FMA, any strides
// and G <= 65535.
extern "C" int grouped_matmul(const void* x, const void* w, const void* counts,
                              void* out, int G, int E, int C, int K, int N,
                              int sw_e, int sw_k, int sw_n, int dtype,
                              void* stream) {
  if (G == 0 || C == 0 || N == 0) return static_cast<int>(cudaSuccess);
  if (E <= 0) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case repro::kF32: {
      if (G > 65535) return static_cast<int>(cudaErrorInvalidValue);
      const dim3 grid((N + kBN - 1) / kBN, (C + kBM - 1) / kBM, G);
      gmm_fma<<<grid, kFmaThreads, 0, st>>>(
          static_cast<const float*>(x), static_cast<const float*>(w),
          static_cast<const int*>(counts), static_cast<float*>(out), E, C, K,
          N, sw_e, sw_k, sw_n);
      return static_cast<int>(cudaGetLastError());
    }
    case repro::kBF16:
      return launch_wgmma(x, w, counts, out, G, E, C, K, N, sw_e, sw_k, sw_n, st);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

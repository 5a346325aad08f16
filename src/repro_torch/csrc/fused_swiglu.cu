// Fused grouped SwiGLU over the landed dispatch buffer:
//   out[s, e, c, :] = (silu(x[s,e,c] @ w1[e]) * (x[s,e,c] @ w3[e])) @ w2[e]
// for rows c < counts[s, e]; rows at or past counts are written as zeros.
//
// Replaces the Pallas kernel repro/kernels/fused_staging.py:
// fused_swiglu_pallas (_swiglu_kernel), the expert FFN of the prefill
// shuffle (repro/core/fusco.py:55) and of the decode MoE
// (repro/layers/moe.py:374).
//
// Bound on the H100: bytes for the shapes serving gives it.  Every call
// reads the weights of each expert with a live row: at the main-path shape
// (128 experts, d 2048, f 768, bf16) that is 3 * 128 * 2048 * 768 * 2 B
// ~= 1.2 GB (~0.36 ms at 3.35 TB/s), against 2 * 3 * d * f flops per live
// row (4096 live rows: ~39 GFLOP, ~39 us at the bf16 tensor-core peak).
//
// Design, shared by both variants.  One block of 8 warps per (s, e, tile of
// rows).  A tile whose first row is at or past counts[s, e] writes zeros and
// returns without reading weights.  Otherwise the block keeps its x tile
// (rows x d) in dynamic shared memory and the tile's hidden activations never
// leave the SM: the (C, f) activations never reach device memory -- the
// property the Pallas kernel got from VMEM -- and no sum crosses blocks.
// Tiles of one expert are neighbours in the grid (blockIdx.x is the tile),
// so they run together and share the expert's weights through the L2.
//
// swiglu_tile_tc (bf16, d and f multiples of 16): 16-row tiles on the
// tensor cores through WMMA (mma.sync, bf16 in, f32 accumulate).  It keeps
// the whole activation row block, silu(h) * u for all f (16 x f bf16), in
// shared memory instead of an f32 output accumulator: first each warp
// takes 16-column tiles of h and u and runs the whole d reduction, then
// each warp takes 16-column tiles of the output and runs the whole f
// reduction, so each output tile is written once, with no accumulator in
// shared memory.  Every warp streams its weight tiles through a private
// ring of kTcStages slots filled by cp.async (one 16-byte copy per lane per
// tile), which keeps ~8 KiB of weights in flight per warp, as WMMA loads
// straight from global memory cannot (the card stays latency-bound).  silu(h) * u
// is formed in f32 and rounded to bf16 as the down product's A operand.
// wgmma, TMA and warp specialisation are later work.
//
// swiglu_tile (any dtype and shape, BC rows per tile): FMA on the CUDA
// cores, with an f32 output accumulator (BC x d) in shared memory, walking f
// in chunks.  The 8 warps split d to form h and u for kFC = 32
// columns (each thread owns one column, so every weight element is read once
// per block, coalesced along f) and reduce their partials in shared memory;
// silu(h) * u stays in f32.
//
// Shared memory per block (must match repro_torch/kernels/fused_staging.py):
//   swiglu_tile:    BC*d*4 (acc) + kWarps*2*BC*kFC*4 (partials)
//                   + BC*kFC*4 (act) + BC*d*sizeof(T) (x)
//   swiglu_tile_tc: 16*d*2 (x) + 16*f*2 (act) + kWarps*kTcWarpBytes (rings)
// At d = 2048, f = 768 in bf16: 231,424 B (BC = 16) and 172,032 B of the
// 232,448 B a block may opt into.
#include <mma.h>

#include "common.cuh"

namespace {

constexpr int kFC = 32;    // swiglu_tile: f columns per chunk, one warp's width
constexpr int kWarps = 8;
constexpr int kThreads = kWarps * 32;
constexpr int kTcStages = 8;  // swiglu_tile_tc: weight tiles in flight per warp
// swiglu_tile_tc, per warp: a ring of kTcStages slots of two 16 x 16 bf16
// tiles (1 KiB each), then two 16 x 16 f32 tiles of scratch
constexpr int kTcWarpBytes = kTcStages * 1024 + 2 * 16 * 16 * 4;

size_t smem_bytes(int bc, int d, int elem_bytes) {
  return static_cast<size_t>(bc) * d * 4 +
         static_cast<size_t>(kWarps) * 2 * bc * kFC * 4 +
         static_cast<size_t>(bc) * kFC * 4 +
         static_cast<size_t>(bc) * d * elem_bytes;
}

template <typename T, int BC>
__global__ void __launch_bounds__(kThreads)
    swiglu_tile(const T* __restrict__ x, const T* __restrict__ w1,
                const T* __restrict__ w3, const T* __restrict__ w2,
                const int* __restrict__ counts, T* __restrict__ out, int E,
                int C, int d, int f) {
  const int tile = blockIdx.x;
  const int e = blockIdx.y;
  const int s = blockIdx.z;
  const int tid = threadIdx.x;
  const int c0 = tile * BC;
  const int rows = min(BC, C - c0);  // rows of this tile inside C
  const int live = max(0, min(rows, counts[s * E + e] - c0));
  const size_t first = (static_cast<size_t>(s) * E + e) * C + c0;
  T* o = out + first * d;

  if (live == 0) {  // the whole tile is past the group's occupancy
    for (int k = tid; k < rows * d; k += kThreads) o[k] = repro::from_f32<T>(0.f);
    return;
  }

  extern __shared__ __align__(16) unsigned char smem[];
  float* acc = reinterpret_cast<float*>(smem);  // [BC][d]
  float* part = acc + BC * d;                    // [kWarps][2][BC][kFC]
  float* act = part + kWarps * 2 * BC * kFC;     // [BC][kFC]
  T* xs = reinterpret_cast<T*>(act + BC * kFC);  // [BC][d]

  const T* xg = x + first * d;
  for (int k = tid; k < BC * d; k += kThreads) {
    acc[k] = 0.f;
    xs[k] = k < live * d ? xg[k] : repro::from_f32<T>(0.f);
  }
  __syncthreads();

  const int warp = tid / 32;
  const int lane = tid % 32;
  const T* w1e = w1 + static_cast<size_t>(e) * d * f;
  const T* w3e = w3 + static_cast<size_t>(e) * d * f;
  const T* w2e = w2 + static_cast<size_t>(e) * f * d;

  for (int f0 = 0; f0 < f; f0 += kFC) {
    // gate/up for column j = f0 + lane over this warp's share of d
    const int j = f0 + lane;
    float h[BC], u[BC];
#pragma unroll
    for (int r = 0; r < BC; ++r) {
      h[r] = 0.f;
      u[r] = 0.f;
    }
    if (j < f) {
#pragma unroll 4
      for (int k = warp; k < d; k += kWarps) {
        const float g1 = repro::to_f32(w1e[static_cast<size_t>(k) * f + j]);
        const float g3 = repro::to_f32(w3e[static_cast<size_t>(k) * f + j]);
#pragma unroll
        for (int r = 0; r < BC; ++r) {
          const float xv = repro::to_f32(xs[r * d + k]);
          h[r] = fmaf(xv, g1, h[r]);
          u[r] = fmaf(xv, g3, u[r]);
        }
      }
    }
#pragma unroll
    for (int r = 0; r < BC; ++r) {
      part[((warp * 2 + 0) * BC + r) * kFC + lane] = h[r];
      part[((warp * 2 + 1) * BC + r) * kFC + lane] = u[r];
    }
    __syncthreads();

    // reduce the warps' partials; silu(h) * u in f32 (zero past f)
    for (int q = tid; q < BC * kFC; q += kThreads) {  // q = r * kFC + jj
      float hs = 0.f, us = 0.f;
#pragma unroll
      for (int w = 0; w < kWarps; ++w) {
        hs += part[(w * 2 + 0) * BC * kFC + q];
        us += part[(w * 2 + 1) * BC * kFC + q];
      }
      act[q] = hs / (1.f + expf(-hs)) * us;
    }
    __syncthreads();

    // down: acc[r, c] += sum_jj act[r, jj] * w2[f0 + jj, c]
    const int nf = min(kFC, f - f0);
    for (int c = tid; c < d; c += kThreads) {
      float a[BC];
#pragma unroll
      for (int r = 0; r < BC; ++r) a[r] = acc[r * d + c];
      for (int jj = 0; jj < nf; ++jj) {
        const float g2 = repro::to_f32(w2e[static_cast<size_t>(f0 + jj) * d + c]);
#pragma unroll
        for (int r = 0; r < BC; ++r) a[r] = fmaf(act[r * kFC + jj], g2, a[r]);
      }
#pragma unroll
      for (int r = 0; r < BC; ++r) acc[r * d + c] = a[r];
    }
    __syncthreads();  // part/act are rewritten by the next chunk
  }

  for (int k = tid; k < rows * d; k += kThreads)
    o[k] = repro::from_f32<T>(k < live * d ? acc[k] : 0.f);
}

size_t smem_bytes_tc(int d, int f) {
  return static_cast<size_t>(16) * d * 2 + static_cast<size_t>(16) * f * 2 +
         static_cast<size_t>(kWarps) * kTcWarpBytes;
}

// 16-byte asynchronous copy global -> shared (sm_80+), and its groups
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

// Lane `lane` copies its 16 bytes of the 16 x 16 bf16 tile at `src` (row
// stride `ld` elements) into the dense 16 x 16 tile at `dst`.
__device__ __forceinline__ void copy_tile(__nv_bfloat16* dst,
                                          const __nv_bfloat16* src, int ld,
                                          int lane) {
  const int r = lane >> 1, h = (lane & 1) * 8;
  cp_async16(dst + r * 16 + h, src + static_cast<size_t>(r) * ld + h);
}

// bf16 on the tensor cores; needs d % 16 == 0, f % 16 == 0 and 32-byte
// aligned x, w1, w3, w2 (the wrapper checks).
__global__ void __launch_bounds__(kThreads)
    swiglu_tile_tc(const __nv_bfloat16* __restrict__ x,
                   const __nv_bfloat16* __restrict__ w1,
                   const __nv_bfloat16* __restrict__ w3,
                   const __nv_bfloat16* __restrict__ w2,
                   const int* __restrict__ counts,
                   __nv_bfloat16* __restrict__ out, int E, int C, int d,
                   int f) {
  using namespace nvcuda;
  using bf16 = __nv_bfloat16;
  using FragA = wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major>;
  using FragB = wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major>;
  using FragC = wmma::fragment<wmma::accumulator, 16, 16, 16, float>;
  const int tile = blockIdx.x;
  const int e = blockIdx.y;
  const int s = blockIdx.z;
  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int lane = tid % 32;
  const int c0 = tile * 16;
  const int rows = min(16, C - c0);
  const int live = max(0, min(rows, counts[s * E + e] - c0));
  const size_t first = (static_cast<size_t>(s) * E + e) * C + c0;
  bf16* o = out + first * d;

  if (live == 0) {  // the whole tile is past the group's occupancy
    for (int k = tid; k < rows * d; k += kThreads) o[k] = __float2bfloat16(0.f);
    return;
  }

  extern __shared__ __align__(128) unsigned char smem_tc[];
  bf16* xs = reinterpret_cast<bf16*>(smem_tc);  // [16][d]
  bf16* act = xs + 16 * d;                      // [16][f]
  unsigned char* mine = smem_tc + 32 * d + 32 * f + warp * kTcWarpBytes;
  bf16* ring = reinterpret_cast<bf16*>(mine);   // [kTcStages][2][16][16]
  float* scratch = reinterpret_cast<float*>(mine + kTcStages * 1024);  // [2][16][16]

  const bf16* xg = x + first * d;
  for (int k = tid; k < 16 * d; k += kThreads)
    xs[k] = k < live * d ? xg[k] : __float2bfloat16(0.f);
  __syncthreads();

  const bf16* w1e = w1 + static_cast<size_t>(e) * d * f;
  const bf16* w3e = w3 + static_cast<size_t>(e) * d * f;
  const bf16* w2e = w2 + static_cast<size_t>(e) * f * d;
  FragA a;
  FragB b;

  // gate/up: each warp takes 16-column tiles j of h and u and runs the whole
  // d reduction, streaming the weight tiles through its own ring.
  const int nkd = d / 16;
  for (int j = warp; j < f / 16; j += kWarps) {
    const int col = 16 * j;
    auto issue = [&](int kt) {
      bf16* slot = ring + (kt % kTcStages) * 512;
      copy_tile(slot, w1e + static_cast<size_t>(16 * kt) * f + col, f, lane);
      copy_tile(slot + 256, w3e + static_cast<size_t>(16 * kt) * f + col, f, lane);
    };
    FragC hc, uc;
    wmma::fill_fragment(hc, 0.f);
    wmma::fill_fragment(uc, 0.f);
    for (int kt = 0; kt < kTcStages - 1; ++kt) {
      if (kt < nkd) issue(kt);
      cp_async_commit();
    }
    for (int kt = 0; kt < nkd; ++kt) {
      if (kt + kTcStages - 1 < nkd) issue(kt + kTcStages - 1);
      cp_async_commit();
      cp_async_wait<kTcStages - 1>();  // tile kt has landed
      __syncwarp();
      const bf16* slot = ring + (kt % kTcStages) * 512;
      wmma::load_matrix_sync(a, xs + 16 * kt, d);
      wmma::load_matrix_sync(b, slot, 16);
      wmma::mma_sync(hc, a, b, hc);
      wmma::load_matrix_sync(b, slot + 256, 16);
      wmma::mma_sync(uc, a, b, uc);
      __syncwarp();  // the slot is refilled next iteration
    }
    wmma::store_matrix_sync(scratch, hc, 16, wmma::mem_row_major);
    wmma::store_matrix_sync(scratch + 256, uc, 16, wmma::mem_row_major);
    __syncwarp();
    for (int q = lane; q < 256; q += 32) {  // silu(h) * u in f32 -> bf16
      const float h = scratch[q];
      act[(q / 16) * f + col + q % 16] =
          __float2bfloat16(h / (1.f + expf(-h)) * scratch[256 + q]);
    }
    __syncwarp();
  }
  cp_async_wait<0>();
  __syncthreads();  // act complete

  // down: each warp takes 16-column tiles n of the output and runs the
  // whole f reduction, streaming w2's tiles through its ring
  const int nkf = f / 16;
  for (int n = warp; n < d / 16; n += kWarps) {
    auto issue = [&](int kt) {
      copy_tile(ring + (kt % kTcStages) * 512,
                w2e + static_cast<size_t>(16 * kt) * d + 16 * n, d, lane);
    };
    FragC c;
    wmma::fill_fragment(c, 0.f);
    for (int kt = 0; kt < kTcStages - 1; ++kt) {
      if (kt < nkf) issue(kt);
      cp_async_commit();
    }
    for (int kt = 0; kt < nkf; ++kt) {
      if (kt + kTcStages - 1 < nkf) issue(kt + kTcStages - 1);
      cp_async_commit();
      cp_async_wait<kTcStages - 1>();
      __syncwarp();
      wmma::load_matrix_sync(a, act + 16 * kt, f);
      wmma::load_matrix_sync(b, ring + (kt % kTcStages) * 512, 16);
      wmma::mma_sync(c, a, b, c);
      __syncwarp();
    }
    wmma::store_matrix_sync(scratch, c, 16, wmma::mem_row_major);
    __syncwarp();
    for (int q = lane; q < 256; q += 32) {
      const int r = q / 16;
      if (r < rows)
        o[static_cast<size_t>(r) * d + 16 * n + q % 16] =
            __float2bfloat16(r < live ? scratch[q] : 0.f);
    }
    __syncwarp();
  }
  cp_async_wait<0>();
}

template <typename T, int BC>
int launch(const void* x, const void* w1, const void* w3, const void* w2,
           const void* counts, void* out, int S, int E, int C, int d, int f,
           cudaStream_t stream) {
  const size_t smem = smem_bytes(BC, d, sizeof(T));
  cudaError_t err = cudaFuncSetAttribute(
      swiglu_tile<T, BC>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((C + BC - 1) / BC, E, S);
  swiglu_tile<T, BC><<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(w1),
      static_cast<const T*>(w3), static_cast<const T*>(w2),
      static_cast<const int*>(counts), static_cast<T*>(out), E, C, d, f);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_bc(int bc, const void* x, const void* w1, const void* w3,
              const void* w2, const void* counts, void* out, int S, int E,
              int C, int d, int f, cudaStream_t st) {
  switch (bc) {
    case 16: return launch<T, 16>(x, w1, w3, w2, counts, out, S, E, C, d, f, st);
    case 8: return launch<T, 8>(x, w1, w3, w2, counts, out, S, E, C, d, f, st);
    case 4: return launch<T, 4>(x, w1, w3, w2, counts, out, S, E, C, d, f, st);
    case 2: return launch<T, 2>(x, w1, w3, w2, counts, out, S, E, C, d, f, st);
    case 1: return launch<T, 1>(x, w1, w3, w2, counts, out, S, E, C, d, f, st);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

// x: (S, E, C, d); w1/w3: (E, d, f); w2: (E, f, d); counts: (S, E) int32;
// out: (S, E, C, d); all contiguous, x/w/out of one dtype.  bc: rows per
// tile, one of 1, 2, 4, 8, 16.
extern "C" int fused_swiglu(const void* x, const void* w1, const void* w3,
                            const void* w2, const void* counts, void* out,
                            int S, int E, int C, int d, int f, int dtype,
                            int bc, void* stream) {
  if (S == 0 || E == 0 || C == 0 || d == 0) return static_cast<int>(cudaSuccess);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case repro::kF32:
      return launch_bc<float>(bc, x, w1, w3, w2, counts, out, S, E, C, d, f, st);
    case repro::kBF16:
      return launch_bc<__nv_bfloat16>(bc, x, w1, w3, w2, counts, out, S, E, C,
                                      d, f, st);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

// The tensor-core variant: bf16 only, d % 16 == 0, f % 16 == 0, 32-byte
// aligned x, w1, w3, w2 and out; 16-row tiles.  Same arguments otherwise.
extern "C" int fused_swiglu_tc(const void* x, const void* w1, const void* w3,
                               const void* w2, const void* counts, void* out,
                               int S, int E, int C, int d, int f,
                               void* stream) {
  if (S == 0 || E == 0 || C == 0 || d == 0) return static_cast<int>(cudaSuccess);
  if (d % 16 != 0 || f % 16 != 0) return static_cast<int>(cudaErrorInvalidValue);
  const size_t smem = smem_bytes_tc(d, f);
  cudaError_t err = cudaFuncSetAttribute(
      swiglu_tile_tc, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((C + 15) / 16, E, S);
  swiglu_tile_tc<<<grid, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const __nv_bfloat16*>(x), static_cast<const __nv_bfloat16*>(w1),
      static_cast<const __nv_bfloat16*>(w3), static_cast<const __nv_bfloat16*>(w2),
      static_cast<const int*>(counts), static_cast<__nv_bfloat16*>(out), E, C,
      d, f);
  return static_cast<int>(cudaGetLastError());
}

// Fused grouped SwiGLU over the landed dispatch buffer:
//   out[s, e, c, :] = (silu(x[s,e,c] @ w1[e]) * (x[s,e,c] @ w3[e])) @ w2[e]
// for rows c < counts[s, e]; rows at or past counts are written as zeros.
//
// Replaces the Pallas kernel repro/kernels/fused_staging.py:
// fused_swiglu_pallas (_swiglu_kernel), the expert FFN of the prefill
// shuffle (repro/core/fusco.py:55) and of the decode MoE
// (repro/layers/moe.py:374).
//
// Bound on the H100: bytes.  Every call reads the weights of each expert
// with a live row: at the qwen3-moe-30b-a3b shape (128 experts, d 2048, f
// 768, bf16) that is 3 * 128 * 2048 * 768 * 2 B ~= 1.2 GB (~0.36 ms at
// 3.35 TB/s), against 6 * d * f flops per live row (4096 live rows: ~39
// GFLOP, ~39 us at the bf16 tensor-core peak).
//
// Two kernels; the wrapper (repro_torch/kernels/fused_staging.py) picks the
// C entry from the inputs.  Both keep a tile's (rows, f) hidden activations
// on the SM -- the property the Pallas kernel got from VMEM -- so they
// never reach device memory; a tile whose first row is at or past counts[s,
// e] writes zeros and reads no weights; tiles of one expert are neighbours
// in the grid (blockIdx.x), so they run together and share its weights
// through the L2.
//
// swiglu_wgmma (bf16, d and f multiples of 8; the Hopper form).  A 64-row
// tile of one (s, e) group is taken by a cluster of kSplit = 2 CTAs of 288
// threads: two consumer warpgroups on wgmma and one producer warp whose
// first lane streams every operand tile with TMA into a ring of
// kStageBytes slots (hopper.cuh), guarded by full/empty mbarriers.
//   phase 1 (gate/up): f in chunks of kFChunk = 128, CTA r taking the
//     chunks r mod 2; d in k steps of kBK = 32.  A stage holds the x k-tile
//     (64 x 32, 64-byte swizzle) and, per warpgroup, its 64 columns of w1
//     and of w3 as two adjacent boxes, so one m64n128k16 wgmma (B MN-major,
//     LBO = the box stride) forms h and u together: accumulator elements i
//     and i + 32 are h and u of the same (row, column).  The chunk's
//     epilogue writes silu(h) * u, f32 rounded to bf16, into `act` (64 x f,
//     resident in shared memory) in the 128-byte-swizzled K-major layout
//     that phase 2's A descriptor reads -- in this CTA and, through
//     distributed shared memory, in its neighbour.  Every consumer thread of
//     both CTAs then arrives on both CTAs' act_ready barrier.
//   phase 2 (down): d in chunks of kDChunk = 256, CTA r taking the chunks r
//     mod 2; f in k steps of 32; A is the whole `act`, B the w2 tile (32 x
//     256, four boxes) from the same ring; each warpgroup owns 64 x 128 of
//     the output, stored as bf16 with the rows at or past counts zeroed.
// So each expert's weights pass once through each tile's cluster, half
// through each SM.  What bounds it on this card: what one SM's TMA stream
// delivers (~45-65 GB/s measured, PERF.md), not the L2's total or HBM's,
// except at qwen3-moe's one tile per expert (HBM).  A 64-row tile gets
// 52-64 flop per byte loaded, so that feed caps an SM near half its tensor
// peak; `act` (96 KiB at f 768, 128 KiB at f 1024) leaves the ring the rest
// of the 227 KiB; splitting the tile over two SMs halves each SM's bytes
// and doubles the SMs a decode call (one tile per expert) can use.  The x
// tile is not kept whole (at d 2048 it is 256 KiB): its k-tiles are re-read
// from the L2 once per f chunk.  Ragged edges come from TMA: elements past
// d, f, C (the x map is 3-D, so a tile never reads the next group's rows)
// or the box read as zeros; silu(0) * 0 = 0 pads `act`; stores are masked.
//
// swiglu_tile (any dtype and shape, BC rows per tile): FMA on the CUDA
// cores, with an f32 output accumulator (BC x d) in shared memory, walking f
// in chunks.  The 8 warps split d to form h and u for kFC = 32
// columns (each thread owns one column, so every weight element is read once
// per block, coalesced along f) and reduce their partials in shared memory;
// silu(h) * u stays in f32.  float32 runs here (no TF32: the card-vs-CPU
// checks hold f32 to 1e-3), and so does a bf16 shape swiglu_wgmma refuses.
//
// Shared memory per CTA (mirrored by repro_torch/kernels/fused_staging.py):
//   swiglu_tile:  BC*d*4 (acc) + kWarps*2*BC*kFC*4 (partials)
//                 + BC*kFC*4 (act) + BC*d*sizeof(T) (x)
//   swiglu_wgmma: kSmemFixed (alignment slack, barriers)
//                 + 64 * round_up(f, 64) * 2 (act) + stages * kStageBytes,
//                 stages = min(kMaxStages, what fits in kSmemOptin), >= 2
// At d 2048, f 768 in bf16: 231,424 B (swiglu_tile, BC = 16) and 222,464 B
// (swiglu_wgmma, 6 stages) of the 232,448 B a block may opt into; at f 1024
// swiglu_wgmma has 4 stages (214,272 B).
#include <algorithm>

#include "common.cuh"
#include "hopper.cuh"

namespace {

using bf16 = __nv_bfloat16;

constexpr int kFC = 32;    // swiglu_tile: f columns per chunk, one warp's width
constexpr int kWarps = 8;
constexpr int kThreads = kWarps * 32;

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

// ------------------------------------------------- swiglu_wgmma (bf16, sm_90a)

constexpr int kTileM = 64;         // rows of x per block
constexpr int kBK = 32;            // contraction depth of a stage
constexpr int kFChunk = 128;       // phase 1: f columns per step, 64 per warpgroup
constexpr int kDChunk = 256;       // phase 2: d columns per step, 128 per warpgroup
constexpr int kXBytes = kTileM * kBK * 2;  // x k-tile: 64 rows of 64 bytes
constexpr int kWBytes = 64 * kBK * 2;      // weight box: kBK rows of 64 columns
constexpr int kActBlock = kTileM * 64 * 2; // act: 64 rows of 64 columns
constexpr int kStageBytes = kXBytes + 4 * kWBytes;  // x + 2 x (w1, w3)
constexpr int kMaxStages = 8;
constexpr int kSmemOptin = 232448;       // bytes a Hopper block may opt into
constexpr int kSmemFixed = 1024 + 256;   // 1024-byte alignment slack, barriers
constexpr int kHopperThreads = 288;      // two consumer warpgroups, one producer warp
constexpr int kSplit = 2;                // CTAs (a cluster) per row tile

size_t act_bytes(int f) {
  return static_cast<size_t>((f + 63) / 64) * kActBlock;
}

int hopper_stages(int f) {
  const long room = kSmemOptin - kSmemFixed - static_cast<long>(act_bytes(f));
  return static_cast<int>(std::min<long>(kMaxStages, room / kStageBytes));
}

size_t smem_bytes_hopper(int f) {
  return kSmemFixed + act_bytes(f) +
         static_cast<size_t>(hopper_stages(f)) * kStageBytes;
}

__device__ __forceinline__ float silu_mul(float h, float u) {
  return h / (1.f + __expf(-h)) * u;
}

// kSplit CTAs, a thread-block cluster, share one row tile: CTA r takes the
// f chunks j = r mod kSplit in phase 1 and writes its silu(h) * u columns
// into both CTAs' `act` (its own and, through distributed shared memory,
// its neighbour's); once every consumer thread of both has arrived on
// act_ready, each CTA holds the whole `act` and takes the d chunks r mod
// kSplit in phase 2.  So each CTA streams half of the expert's weights,
// and twice as many SMs work on a call with few live tiles (decode).
__global__ void __launch_bounds__(kHopperThreads, 1)
    swiglu_wgmma(const __grid_constant__ CUtensorMap xmap,
                 const __grid_constant__ CUtensorMap w1map,
                 const __grid_constant__ CUtensorMap w3map,
                 const __grid_constant__ CUtensorMap w2map,
                 const int* __restrict__ counts, bf16* __restrict__ out, int E,
                 int C, int d, int f, int stages) {
  using namespace hopper;
  const int e = blockIdx.y;
  const int se = blockIdx.z * E + e;
  const int tid = threadIdx.x;
  const int rank = static_cast<int>(cluster_rank());
  const int c0 = blockIdx.x / kSplit * kTileM;
  const int rows = min(kTileM, C - c0);
  const int live = max(0, min(rows, counts[se] - c0));
  bf16* o = out + (static_cast<size_t>(se) * C + c0) * d;
  if (live == 0) {  // the whole tile is past the group's occupancy
    if (rank == 0) zero_rows(o, d, rows, d, tid, kHopperThreads);
    return;  // (both CTAs of a cluster return here, before any barrier)
  }

  extern __shared__ __align__(1024) unsigned char smem_h[];
  uint64_t* full = reinterpret_cast<uint64_t*>(smem_h);  // [kMaxStages]
  uint64_t* empty = full + kMaxStages;                    // [kMaxStages]
  uint64_t* act_ready = empty + kMaxStages;  // both CTAs' act columns written
  const uint32_t s0 = smem_addr(smem_h);
  unsigned char* act = smem_h + (((s0 + 256 + 1023) & ~1023u) - s0);
  const int nkb = (f + 63) / 64;  // 64-column blocks of act: [nkb][64][128 B]
  unsigned char* ring = act + static_cast<size_t>(nkb) * kActBlock;
  const int nk1 = (d + kBK - 1) / kBK;  // phase 1 k steps per f chunk
  const int nf1 = (f + kFChunk - 1) / kFChunk;
  const int nk2 = (f + kBK - 1) / kBK;  // phase 2 k steps per d chunk
  const int nd2 = (d + kDChunk - 1) / kDChunk;

  if (tid == 0) {
    for (int i = 0; i < stages; ++i) {
      mbar_init(&full[i], 1);
      mbar_init(&empty[i], 8);  // lane 0 of each consumer warp
    }
    mbar_init(act_ready, 256 * kSplit);  // every consumer thread of the cluster
    fence_barrier_init();
  }
  cluster_sync();  // the neighbour's act and act_ready exist before use

  const int warp = tid / 32;
  if (warp == 8) {  // producer: one lane issues every load
    if (tid % 32 == 0) {
      prefetch_map(&xmap);
      prefetch_map(&w1map);
      prefetch_map(&w3map);
      prefetch_map(&w2map);
      int st = 0;
      uint32_t ph = 0;
      for (int j = rank; j < nf1; j += kSplit) {
        for (int kt = 0; kt < nk1; ++kt) {
          mbar_wait(&empty[st], ph ^ 1);
          unsigned char* slot = ring + st * kStageBytes;
          if constexpr (kLoads) {
            mbar_expect_tx(&full[st], kStageBytes);
            tma_load_3d(slot, &xmap, &full[st], kt * kBK, c0, se);
            for (int h = 0; h < 2; ++h) {  // warpgroup h's w1 box, then its w3 box
              const int col = j * kFChunk + 64 * h;
              tma_load_3d(slot + kXBytes + 2 * h * kWBytes, &w1map, &full[st],
                          col, kt * kBK, e);
              tma_load_3d(slot + kXBytes + (2 * h + 1) * kWBytes, &w3map,
                          &full[st], col, kt * kBK, e);
            }
          } else {
            mbar_arrive(&full[st]);
          }
          if (++st == stages) { st = 0; ph ^= 1; }
        }
      }
      for (int dc = rank; dc < nd2; dc += kSplit) {
        for (int kt = 0; kt < nk2; ++kt) {
          mbar_wait(&empty[st], ph ^ 1);
          unsigned char* slot = ring + st * kStageBytes;
          if constexpr (kLoads) {
            mbar_expect_tx(&full[st], 4 * kWBytes);
            for (int q = 0; q < 4; ++q)
              tma_load_3d(slot + q * kWBytes, &w2map, &full[st],
                          dc * kDChunk + 64 * q, kt * kBK, e);
          } else {
            mbar_arrive(&full[st]);
          }
          if (++st == stages) { st = 0; ph ^= 1; }
        }
      }
    }
  } else {  // consumers: warpgroup wg owns half of each chunk's columns
    const int wg = warp / 4;
    const int t = tid % 128;
    float acc[64];  // the first product of every chunk overwrites it
    int st = 0, prev = -1;
    uint32_t ph = 0;
    auto release = [&](int slot) {
      if (t % 32 == 0) mbar_arrive(&empty[slot]);
    };
    // One k step's products stay in flight: after issuing step st, wait for
    // the step before it and release its stage; at the end of a chunk, wait
    // for all and release the last.
    auto release_previous = [&](float (&a)[64], int cur) {
      wgmma_commit();
      wgmma_wait<1>();
      fence_acc(a);
      if (prev >= 0) release(prev);
      prev = cur;
    };
    auto drain = [&](float (&a)[64]) {
      wgmma_wait<0>();
      fence_acc(a);
      release(prev);
      prev = -1;
    };

    // act's address in the neighbouring CTA of the cluster
    const uint32_t act_peer = map_shared(smem_addr(act), (rank + 1) % kSplit);
    for (int j = rank; j < nf1; j += kSplit) {  // phase 1: h | u, 64 columns of f
      for (int kt = 0; kt < nk1; ++kt) {
        mbar_wait(&full[st], ph);
        const unsigned char* slot = ring + st * kStageBytes;
        const unsigned char* b = slot + kXBytes + 2 * wg * kWBytes;  // w1 | w3
        fence_acc(acc);
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < kBK / 16 && kProducts; ++kk)
          wgmma_m64n128k16<1>(acc, desc<64>(slot + 32 * kk, 16, 512),
                              desc(b + 2048 * kk, kWBytes, 1024),
                              (kt | kk) != 0);
        release_previous(acc, st);
        if (++st == stages) { st = 0; ph ^= 1; }
      }
      drain(acc);
      const int kb = 2 * j + wg;  // this warpgroup's 64 columns of act
      if (kb < nkb) {
#pragma unroll
        for (int i = 0; i < 32; i += 2) {
          const int r = acc_row(t, i), c = acc_col(t, i);
          const int at = kb * kActBlock + r * 128 + (((c >> 3) ^ (r & 7)) << 4) +
                         (c & 7) * 2;
          const __nv_bfloat162 v =
              __floats2bfloat162_rn(silu_mul(acc[i], acc[i + 32]),
                                    silu_mul(acc[i + 1], acc[i + 33]));
          *reinterpret_cast<__nv_bfloat162*>(act + at) = v;
          st_cluster_b32(act_peer + at, *reinterpret_cast<const uint32_t*>(&v));
        }
      }
    }
    // act is read by wgmma next, here and in the neighbour
    // every consumer thread of both CTAs: its act writes, local and remote,
    // are read by wgmma next
    fence_proxy_async();
    mbar_arrive(act_ready);
    mbar_arrive_cluster(map_shared(smem_addr(act_ready), (rank + 1) % kSplit));
    mbar_wait<true>(act_ready, 0);

    for (int dc = rank; dc < nd2; dc += kSplit) {  // phase 2: 64 x 128 of the output
      for (int kt = 0; kt < nk2; ++kt) {
        mbar_wait(&full[st], ph);
        const unsigned char* b = ring + st * kStageBytes + 2 * wg * kWBytes;
        const unsigned char* a = act + (kt / 2) * kActBlock + (kt % 2) * 64;
        fence_acc(acc);
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < kBK / 16 && kProducts; ++kk)
          wgmma_m64n128k16<1>(acc, desc(a + 32 * kk, 16, 1024),
                              desc(b + 2048 * kk, kWBytes, 1024),
                              (kt | kk) != 0);
        release_previous(acc, st);
        if (++st == stages) { st = 0; ph ^= 1; }
      }
      drain(acc);
      const int col = dc * kDChunk + wg * 128;
      store_acc(o + col, d, rows, live, d - col, acc, t);
    }
  }
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

// The Hopper form: bf16 only, d and f multiples of 8, 16-byte aligned x,
// w1, w3, w2 and out, and f small enough for the resident activations and
// two stages (the wrapper checks; otherwise it takes fused_swiglu).  Same
// arguments as fused_swiglu without dtype and bc.  Returns
// hopper::kErrTensorMap if a tensor map cannot be encoded.
extern "C" int fused_swiglu_tc(const void* x, const void* w1, const void* w3,
                               const void* w2, const void* counts, void* out,
                               int S, int E, int C, int d, int f,
                               void* stream) {
  if (S == 0 || E == 0 || C == 0 || d == 0) return static_cast<int>(cudaSuccess);
  if (d % 8 != 0 || f % 8 != 0 || f <= 0 || hopper_stages(f) < 2)
    return static_cast<int>(cudaErrorInvalidValue);
  const uint64_t es = sizeof(bf16);
  const uint64_t ud = d, uf = f, uc = C;
  CUtensorMap xm, w1m, w3m, w2m;
  if (!hopper::make_map_3d(&xm, x, ud, uc, static_cast<uint64_t>(S) * E,
                           ud * es, uc * ud * es, kBK, kTileM,
                           CU_TENSOR_MAP_SWIZZLE_64B) ||
      !hopper::make_map_3d(&w1m, w1, uf, ud, E, uf * es, ud * uf * es, 64, kBK) ||
      !hopper::make_map_3d(&w3m, w3, uf, ud, E, uf * es, ud * uf * es, 64, kBK) ||
      !hopper::make_map_3d(&w2m, w2, ud, uf, E, ud * es, uf * ud * es, 64, kBK))
    return hopper::kErrTensorMap;
  const size_t smem = smem_bytes_hopper(f);
  cudaError_t err = cudaFuncSetAttribute(
      swiglu_wgmma, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((C + kTileM - 1) / kTileM * kSplit, E, S);
  cfg.blockDim = dim3(kHopperThreads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = static_cast<cudaStream_t>(stream);
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = kSplit;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  err = cudaLaunchKernelEx(&cfg, swiglu_wgmma, xm, w1m, w3m, w2m,
                           static_cast<const int*>(counts),
                           static_cast<bf16*>(out), E, C, d, f, hopper_stages(f));
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

// Gated scatter-add (the dComm combine) as a deterministic owner-reduce,
// its counting build of the owner lists, and its one-pass backward.
//
// Replaces the Pallas kernel
// repro/kernels/segment_scatter_add.py:segment_scatter_add
// (_scatter_kernel), the combine that sends expert outputs home in token
// order (repro/core/dcomm.py:231): out[dst[i]] += gates[i] * src[i], f32
// sums, one cast to src's dtype, dst < 0 rows dropped.  That kernel is
// race-free only because a TPU grid runs in order on one core; Hopper runs
// blocks in parallel.  Instead of float atomics into a zeroed f32 buffer
// (the first form: three passes, an order of sums that changed from run to
// run), each output row is reduced by one block from its OWNER LIST, the
// source rows that land on it, in the list's order:
//
//   owner_reduce: block t reads list t, accumulates gates[i] * src[i] in f32
//   registers over 16-byte vectors (a product rounded, then a sum rounded,
//   as the plain version does) and writes row t once, in src's dtype; a row
//   with no owner is written as zeros by the same block.  No zero fill, no
//   f32 buffer, no cast pass, no atomics: two calls give the same bits.
//
// The lists come as CSR, offsets (out_rows + 1,) and rows (nnz,), with -1
// entries skipped; or, with no offsets, as a (out_rows, width) table whose
// list t is row t.  The combine's caller holds that table already: the flat
// plan's slot table (T, K) names the buffer row of every (token, k), the
// exact inverse of src_of_slot.  A caller with no lists gets them from the
// counting build (count per destination with integer atomics, one-block
// scan, fill through a per-list cursor, then each list ranked into
// ascending source-row order, so the reduce is deterministic there too; the
// rank is quadratic in a list's length, which is top-k on every path).
//
// scatter_add_bwd: one warp per source row i, a gather: back = dout[dst[i]]
// (no read where dst < 0), dsrc[i] = gates[i] * back in src's dtype, and
// dgates[i] = sum_d back * src[i] in f32, summed per lane in order and
// across lanes by a fixed butterfly.  No owners and no atomics.
//
// Bound on the H100: bytes (two flops per element against 4-6 bytes).  The
// forward reads each live source row once and writes each output row once
// (qwen3-moe serve: 4096 live rows of 4 KiB in, 512 out, ~19 MB, 5.7 us at
// 3.35 TB/s); the backward reads dout and src and writes dsrc (training
// shape: 32768 x 2048 bf16, ~277 MB, 83 us).  One block per output row
// keeps each thread's loads independent (top-k of them in flight), so the
// reduce streams at the memory's rate without an f32 round trip.
#include "common.cuh"

namespace {

// V elements of T at p as floats: one 16-byte load when V * sizeof(T) is 16.
template <typename T, int V>
__device__ __forceinline__ void load_f32(const T* __restrict__ p,
                                         float (&f)[V]) {
  if constexpr (V * sizeof(T) == 16) {
    const uint4 u = __ldg(reinterpret_cast<const uint4*>(p));
    const T* e = reinterpret_cast<const T*>(&u);
#pragma unroll
    for (int v = 0; v < V; ++v) f[v] = repro::to_f32(e[v]);
  } else {
#pragma unroll
    for (int v = 0; v < V; ++v) f[v] = repro::to_f32(p[v]);
  }
}

template <typename T, int V>
__device__ __forceinline__ void store_f32(T* __restrict__ p,
                                          const float (&f)[V]) {
  if constexpr (V * sizeof(T) == 16) {
    uint4 u;
    T* e = reinterpret_cast<T*>(&u);
#pragma unroll
    for (int v = 0; v < V; ++v) e[v] = repro::from_f32<T>(f[v]);
    *reinterpret_cast<uint4*>(p) = u;
  } else {
#pragma unroll
    for (int v = 0; v < V; ++v) p[v] = repro::from_f32<T>(f[v]);
  }
}

constexpr int kUnroll = 4;  // owners whose rows are loaded together

template <typename T, int V>
__global__ void owner_reduce(const T* __restrict__ src,
                             const float* __restrict__ gates,
                             const int* __restrict__ offsets,
                             const int* __restrict__ owners,
                             T* __restrict__ out, int n_src, int d,
                             int width) {
  const int t = blockIdx.x;
  const int begin = offsets != nullptr ? offsets[t] : t * width;
  const int end = offsets != nullptr ? offsets[t + 1] : begin + width;
  const int row_vecs = d / V;
  for (int j = threadIdx.x; j < row_vecs; j += blockDim.x) {
    float acc[V];
#pragma unroll
    for (int v = 0; v < V; ++v) acc[v] = 0.f;
    for (int e0 = begin; e0 < end; e0 += kUnroll) {
      int ii[kUnroll];
      float gg[kUnroll], x[kUnroll][V];
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        const int i = e0 + u < end ? owners[e0 + u] : -1;
        ii[u] = (i >= 0 && i < n_src) ? i : -1;
        gg[u] = ii[u] >= 0 ? gates[i] : 0.f;
      }
#pragma unroll
      for (int u = 0; u < kUnroll; ++u)
        if (ii[u] >= 0)
          load_f32<T, V>(src + static_cast<size_t>(ii[u]) * d + j * V, x[u]);
#pragma unroll
      for (int u = 0; u < kUnroll; ++u)
        if (ii[u] >= 0) {
#pragma unroll
          for (int v = 0; v < V; ++v)
            acc[v] = __fadd_rn(acc[v], __fmul_rn(x[u][v], gg[u]));
        }
    }
    store_f32<T, V>(out + static_cast<size_t>(t) * d + j * V, acc);
  }
}

// ------------------------------------------------------- the counting build

__global__ void count_owners(const int* __restrict__ dst, int rows,
                             int out_rows, int* __restrict__ counts) {
  for (int i = blockIdx.x * blockDim.x + threadIdx.x; i < rows;
       i += gridDim.x * blockDim.x) {
    const int t = dst[i];
    if (t >= 0 && t < out_rows) atomicAdd(&counts[t], 1);
  }
}

constexpr int kScanThreads = 1024;

// One block: offsets = the exclusive scan of counts (n + 1 entries), and
// counts overwritten with the same offsets, as the fill's cursors.
__global__ void __launch_bounds__(kScanThreads)
    scan_offsets(int* __restrict__ counts, int n, int* __restrict__ offsets) {
  __shared__ int part[kScanThreads];
  const int tid = threadIdx.x;
  const int per = (n + kScanThreads - 1) / kScanThreads;
  const int lo = min(n, tid * per), hi = min(n, lo + per);
  int sum = 0;
  for (int k = lo; k < hi; ++k) sum += counts[k];
  part[tid] = sum;
  __syncthreads();
  for (int s = 1; s < kScanThreads; s <<= 1) {  // inclusive Hillis-Steele
    const int add = tid >= s ? part[tid - s] : 0;
    __syncthreads();
    part[tid] += add;
    __syncthreads();
  }
  int run = part[tid] - sum;  // exclusive
  for (int k = lo; k < hi; ++k) {
    const int c = counts[k];
    offsets[k] = run;
    counts[k] = run;
    run += c;
  }
  if (tid == kScanThreads - 1) offsets[n] = part[tid];
}

__global__ void fill_owners(const int* __restrict__ dst, int rows,
                            int out_rows, int* __restrict__ cursor,
                            int* __restrict__ unsorted) {
  for (int i = blockIdx.x * blockDim.x + threadIdx.x; i < rows;
       i += gridDim.x * blockDim.x) {
    const int t = dst[i];
    if (t >= 0 && t < out_rows) unsorted[atomicAdd(&cursor[t], 1)] = i;
  }
}

// Block t: each entry of list t goes to its rank among the list's entries
// (the source rows are distinct), so the list comes out ascending whatever
// order the fill's atomics left it in.
__global__ void rank_owners(const int* __restrict__ offsets,
                            const int* __restrict__ unsorted,
                            int* __restrict__ owners) {
  const int b = offsets[blockIdx.x], n = offsets[blockIdx.x + 1] - b;
  for (int e = threadIdx.x; e < n; e += blockDim.x) {
    const int v = unsorted[b + e];
    int rank = 0;
    for (int x = 0; x < n; ++x) rank += unsorted[b + x] < v;
    owners[b + rank] = v;
  }
}

// ----------------------------------------------------------------- backward

constexpr int kBwdThreads = 256;  // 8 source rows per block, a warp each

template <typename T, int V>
__global__ void __launch_bounds__(kBwdThreads)
    scatter_add_bwd(const T* __restrict__ src, const int* __restrict__ dst,
                    const float* __restrict__ gates,
                    const T* __restrict__ dout, T* __restrict__ dsrc,
                    float* __restrict__ dgates, int rows, int d,
                    int out_rows) {
  const int i = (blockIdx.x * kBwdThreads + threadIdx.x) / 32;
  const int lane = threadIdx.x % 32;
  if (i >= rows) return;
  const int t = dst[i];
  const int row_vecs = d / V;
  T* ds = dsrc + static_cast<size_t>(i) * d;
  if (t < 0 || t >= out_rows) {  // dropped: zeros, nothing read
    float z[V];
#pragma unroll
    for (int v = 0; v < V; ++v) z[v] = 0.f;
    for (int j = lane; j < row_vecs; j += 32) store_f32<T, V>(ds + j * V, z);
    if (lane == 0) dgates[i] = 0.f;
    return;
  }
  const float g = gates[i];
  const T* back = dout + static_cast<size_t>(t) * d;
  const T* s = src + static_cast<size_t>(i) * d;
  float dot = 0.f;
#pragma unroll 4
  for (int j = lane; j < row_vecs; j += 32) {
    float b[V], x[V], o[V];
    load_f32<T, V>(back + j * V, b);
    load_f32<T, V>(s + j * V, x);
#pragma unroll
    for (int v = 0; v < V; ++v) {
      o[v] = __fmul_rn(b[v], g);
      dot = fmaf(b[v], x[v], dot);
    }
    store_f32<T, V>(ds + j * V, o);
  }
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) dot += __shfl_xor_sync(0xffffffffu, dot, o);
  if (lane == 0) dgates[i] = dot;
}

template <typename T, int V>
int launch_reduce(const void* src, const void* gates, const void* offsets,
                  const void* owners, void* out, int n_src, int d,
                  int out_rows, int width, cudaStream_t st) {
  const int row_vecs = d / V;
  int threads = ((row_vecs + 31) / 32) * 32;
  threads = threads > 256 ? 256 : threads;
  owner_reduce<T, V><<<out_rows, threads, 0, st>>>(
      static_cast<const T*>(src), static_cast<const float*>(gates),
      static_cast<const int*>(offsets), static_cast<const int*>(owners),
      static_cast<T*>(out), n_src, d, width);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, int V>
int launch_bwd(const void* src, const void* dst, const void* gates,
               const void* dout, void* dsrc, void* dgates, int rows, int d,
               int out_rows, cudaStream_t st) {
  const int blocks = (rows + kBwdThreads / 32 - 1) / (kBwdThreads / 32);
  scatter_add_bwd<T, V><<<blocks, kBwdThreads, 0, st>>>(
      static_cast<const T*>(src), static_cast<const int*>(dst),
      static_cast<const float*>(gates), static_cast<const T*>(dout),
      static_cast<T*>(dsrc), static_cast<float*>(dgates), rows, d, out_rows);
  return static_cast<int>(cudaGetLastError());
}

// Dispatch by dtype and vector width: vec is 1, or 16 bytes' worth of
// elements when the wrapper found d and every row pointer aligned for it.
#define REPRO_BY_TYPE(fn, ...)                                              \
  switch (dtype * 2 + (vec > 1)) {                                          \
    case repro::kF32 * 2:                                                   \
      return fn<float, 1>(__VA_ARGS__);                                     \
    case repro::kF32 * 2 + 1:                                               \
      return vec == 4 ? fn<float, 4>(__VA_ARGS__)                           \
                      : static_cast<int>(cudaErrorInvalidValue);            \
    case repro::kBF16 * 2:                                                  \
      return fn<__nv_bfloat16, 1>(__VA_ARGS__);                             \
    case repro::kBF16 * 2 + 1:                                              \
      return vec == 8 ? fn<__nv_bfloat16, 8>(__VA_ARGS__)                   \
                      : static_cast<int>(cudaErrorInvalidValue);            \
    default:                                                                \
      return static_cast<int>(cudaErrorInvalidValue);                       \
  }

}  // namespace

// out (out_rows, d) = the gated sum of each row's owners: list t is
// owners[offsets[t] .. offsets[t + 1]) or, with offsets null, owners[t *
// width .. + width); entries < 0 or >= n_src are skipped.  gates f32 (n_src,).
extern "C" int segment_scatter_add(const void* src, const void* gates,
                                   const void* offsets, const void* owners,
                                   void* out, int n_src, int d, int out_rows,
                                   int width, int dtype, int vec,
                                   void* stream) {
  if (out_rows == 0 || d == 0) return static_cast<int>(cudaSuccess);
  if (vec < 1 || d % vec != 0) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  REPRO_BY_TYPE(launch_reduce, src, gates, offsets, owners, out, n_src, d,
                out_rows, width, st)
}

// The owner lists of dst (rows,) over [0, out_rows): offsets (out_rows + 1,)
// and owners (rows,), each list ascending; counts (out_rows,) and unsorted
// (rows,) are scratch.
extern "C" int segment_scatter_add_owners(const void* dst, void* counts,
                                          void* offsets, void* unsorted,
                                          void* owners, int rows,
                                          int out_rows, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err = cudaMemsetAsync(counts, 0, sizeof(int) * out_rows, st);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int* d = static_cast<const int*>(dst);
  int* c = static_cast<int*>(counts);
  int* off = static_cast<int*>(offsets);
  const int blocks = rows > 0 ? (rows + 255) / 256 : 1;
  const int grid = blocks > 4096 ? 4096 : blocks;
  if (rows > 0) count_owners<<<grid, 256, 0, st>>>(d, rows, out_rows, c);
  scan_offsets<<<1, kScanThreads, 0, st>>>(c, out_rows, off);
  if (rows > 0) {
    fill_owners<<<grid, 256, 0, st>>>(d, rows, out_rows, c,
                                      static_cast<int*>(unsorted));
    if (out_rows > 0)
      rank_owners<<<out_rows, 32, 0, st>>>(off, static_cast<int*>(unsorted),
                                           static_cast<int*>(owners));
  }
  return static_cast<int>(cudaGetLastError());
}

// dsrc (rows, d) = gates[i] * dout[dst[i]] in src's dtype, dgates (rows,) f32
// = sum_d dout[dst[i]] * src[i]; both zero where dst[i] is outside
// [0, out_rows).
extern "C" int segment_scatter_add_bwd(const void* src, const void* dst,
                                       const void* gates, const void* dout,
                                       void* dsrc, void* dgates, int rows,
                                       int d, int out_rows, int dtype,
                                       int vec, void* stream) {
  if (rows == 0) return static_cast<int>(cudaSuccess);
  if (vec < 1 || d % vec != 0) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  REPRO_BY_TYPE(launch_bwd, src, dst, gates, dout, dsrc, dgates, rows, d,
                out_rows, st)
}

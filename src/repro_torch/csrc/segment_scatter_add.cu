// Gated scatter-add: out[dst[i]] += gates[i] * src[i], accumulated in
// float32 and cast to src's dtype; dst < 0 rows are dropped.
//
// Replaces the Pallas kernel
// repro/kernels/segment_scatter_add.py:segment_scatter_add
// (_scatter_kernel), the combine that sends expert outputs home in token
// order (repro/core/dcomm.py:231).  That kernel is race-free only because a
// TPU grid runs in order on one core; Hopper runs blocks in parallel, so
// two rows with the same destination race.  Here every contribution is an
// f32 atomicAdd (a RED instruction, no return value) into a zeroed
// (out_rows, d) f32 buffer the wrapper allocates, then one cast pass writes
// the source dtype.  The order of the sums changes from run to run, so the
// result is exact only up to f32 rounding of a reordered sum.
//
// Bound on the H100: bytes (two flops per element against ~4-6 bytes).  At
// the main-path shape (8192 x 2048 bf16 rows in, 512 rows out) the live rows
// read are about 16 MiB.  The f32 accumulator (4 MiB there) stays in the
// 50 MB L2, where the atomics resolve.  Design: one block per source row;
// an empty slot (dst < 0) returns before reading its row.
#include "common.cuh"

namespace {

template <typename T>
__global__ void scatter_add_rows(const T* __restrict__ src,
                                 const int* __restrict__ dst,
                                 const float* __restrict__ gates,
                                 float* __restrict__ acc, int out_rows,
                                 int d) {
  const int i = blockIdx.x;
  const int t = dst[i];
  if (t < 0 || t >= out_rows) return;  // dropped row
  const float g = gates[i];
  const T* s = src + static_cast<size_t>(i) * d;
  float* a = acc + static_cast<size_t>(t) * d;
  for (int j = threadIdx.x; j < d; j += blockDim.x)
    atomicAdd(a + j, repro::to_f32(s[j]) * g);
}

template <typename T>
__global__ void cast_from_f32(const float* __restrict__ acc,
                              T* __restrict__ out, size_t n) {
  for (size_t k = blockIdx.x * static_cast<size_t>(blockDim.x) + threadIdx.x;
       k < n; k += static_cast<size_t>(gridDim.x) * blockDim.x)
    out[k] = repro::from_f32<T>(acc[k]);
}

template <typename T>
int launch(const void* src, const void* dst, const void* gates, void* acc,
           void* out, int rows, int d, int out_rows, cudaStream_t stream) {
  if (rows > 0 && d > 0) {
    scatter_add_rows<T><<<rows, 256, 0, stream>>>(
        static_cast<const T*>(src), static_cast<const int*>(dst),
        static_cast<const float*>(gates), static_cast<float*>(acc), out_rows,
        d);
    cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const size_t n = static_cast<size_t>(out_rows) * d;
  if (acc == out || n == 0) return static_cast<int>(cudaSuccess);
  const size_t want = (n + 255) / 256;
  const int blocks = static_cast<int>(want > 4096 ? 4096 : want);
  cast_from_f32<T><<<blocks, 256, 0, stream>>>(static_cast<const float*>(acc),
                                               static_cast<T*>(out), n);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// acc: zeroed f32 (out_rows, d); out: (out_rows, d) of dtype.  For float32
// the wrapper passes the same buffer as acc and out and no cast runs.
extern "C" int segment_scatter_add(const void* src, const void* dst,
                                   const void* gates, void* acc, void* out,
                                   int rows, int d, int out_rows, int dtype,
                                   void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case repro::kF32:
      return launch<float>(src, dst, gates, acc, out, rows, d, out_rows, st);
    case repro::kBF16:
      return launch<__nv_bfloat16>(src, dst, gates, acc, out, rows, d,
                                   out_rows, st);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

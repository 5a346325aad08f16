// Descriptor-driven row gather: out[i] = src[idx[i]], idx < 0 -> zero row.
//
// Replaces the Pallas kernel repro/kernels/segment_gather.py:segment_gather
// (_gather_kernel), the dispatch-side copy that stages tokens into the
// (lane x local expert x capacity) send buffer (repro/core/dcomm.py:215).
//
// Bound on the H100: bytes.  It does no arithmetic; it reads each live
// source row and writes every output row (at the main-path shape, 8192 rows
// of 4 KiB written, about 16 MiB of live rows read: ~15 us at 3.35 TB/s).
// Design: one block per output row, each thread moving 16-byte vectors
// along the row, so a warp reads and writes 512 contiguous bytes per step.
// The block reads its own descriptor (the TPU version scalar-prefetched it
// into the BlockSpec index map) and writes zeros for an empty slot without
// touching the source.  The copy is dtype-agnostic: the wrapper passes the
// row size in bytes and the widest vector the row and the pointers allow.
#include "common.cuh"

namespace {

template <typename V>
__global__ void gather_rows(const V* __restrict__ src,
                            const int* __restrict__ idx, V* __restrict__ out,
                            int n_src, int row_vecs) {
  const int i = blockIdx.x;
  const int s = idx[i];
  V* o = out + static_cast<size_t>(i) * row_vecs;
  if (s < 0 || s >= n_src) {  // empty slot
    for (int j = threadIdx.x; j < row_vecs; j += blockDim.x) o[j] = V{};
    return;
  }
  const V* r = src + static_cast<size_t>(s) * row_vecs;
  for (int j = threadIdx.x; j < row_vecs; j += blockDim.x) o[j] = r[j];
}

template <typename V>
int launch(const void* src, const void* idx, void* out, int n_src, int rows,
           int row_vecs, cudaStream_t stream) {
  int threads = ((row_vecs + 31) / 32) * 32;
  threads = threads > 256 ? 256 : threads;
  gather_rows<V><<<rows, threads, 0, stream>>>(
      static_cast<const V*>(src), static_cast<const int*>(idx),
      static_cast<V*>(out), n_src, row_vecs);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" int segment_gather(const void* src, const void* idx, void* out,
                              int n_src, int rows, int row_bytes,
                              int vec_bytes, void* stream) {
  if (rows == 0 || row_bytes == 0) return static_cast<int>(cudaSuccess);
  if (vec_bytes <= 0 || row_bytes % vec_bytes != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const int row_vecs = row_bytes / vec_bytes;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (vec_bytes) {
    case 16: return launch<uint4>(src, idx, out, n_src, rows, row_vecs, st);
    case 8: return launch<uint2>(src, idx, out, n_src, rows, row_vecs, st);
    case 4: return launch<unsigned int>(src, idx, out, n_src, rows, row_vecs, st);
    case 2: return launch<unsigned short>(src, idx, out, n_src, rows, row_vecs, st);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

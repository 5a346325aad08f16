// Shared helpers for the port's CUDA kernels: element types by code and
// float32 conversions.  Every kernel library has a plain C interface (bound
// with ctypes from repro_torch/kernels/*.py), returns cudaGetLastError() as
// an int, launches on the stream it is given and allocates nothing.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstddef>
#include <cstdint>

namespace repro {

// dtype codes passed from the wrappers (repro_torch/kernels/_build.py)
enum Dtype : int { kF32 = 0, kBF16 = 1 };

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

template <typename T>
__device__ __forceinline__ T from_f32(float v);
template <>
__device__ __forceinline__ float from_f32<float>(float v) {
  return v;
}
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float v) {
  return __float2bfloat16(v);  // round to nearest even, as torch's cast
}

}  // namespace repro

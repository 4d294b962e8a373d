// Shared by every kernel library of the port.  Each csrc/<name>.cu builds
// on its own into lib<name>.so with a plain C interface (see
// utils/cuda_build.py): entry points take raw device pointers and the
// stream as integers, launch on that stream, do not synchronise, and
// return cudaGetLastError() so the Python wrapper can raise.
#pragma once

#include <cstdint>
#include <cuda_runtime.h>

#define GSR_EXPORT extern "C" __attribute__((visibility("default")))

GSR_EXPORT const char* gsr_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

namespace gsr {

// 12-bit positive minifloat bias of the packed conic word (ops/geometry.py).
constexpr uint32_t MF12_K = (127u - 8u) << 7;

inline unsigned int blocks_for(long long n, int threads) {
  return static_cast<unsigned int>((n + threads - 1) / threads);
}

}  // namespace gsr

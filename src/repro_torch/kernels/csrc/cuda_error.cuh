// The one symbol every kernel library exports beside its launcher: the
// text of a cudaError_t, so the Python wrapper can name a failed launch.
// Each csrc/*.cu builds into its own shared library, so each includes this
// header exactly once.
#pragma once

#include <cuda_runtime.h>

extern "C" const char* repro_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// Error strings for the codes the launchers return.
#include "common.cuh"

ADDV_EXPORT const char* addv_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

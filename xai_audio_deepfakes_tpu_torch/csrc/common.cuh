// Shared helpers of the port's hand-written kernels. Every kernel is built
// with nvcc into one shared library with a plain C interface and called
// through ctypes (xai_audio_deepfakes_tpu_torch/ops/_cuda.py). Each exported
// launcher takes PyTorch's current stream and returns cudaGetLastError().
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#define ADDV_EXPORT extern "C" __attribute__((visibility("default")))

// dtype codes passed by the Python wrappers
enum AddvDtype { ADDV_F32 = 0, ADDV_BF16 = 1 };

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }

template <typename T> __device__ __forceinline__ T from_f32(float x);
template <> __device__ __forceinline__ float from_f32<float>(float x) { return x; }
// round to nearest even, as astype(bfloat16) does in JAX
template <> __device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);
}

// GELU in f32: exact (erff) or the tanh form.
__device__ __forceinline__ float gelu_f32(float x, int tanh_form) {
  if (tanh_form) {
    const float inner = 0.7978845608028654f * (x + 0.044715f * x * x * x);
    return 0.5f * x * (1.f + tanhf(inner));
  }
  return 0.5f * x * (1.f + erff(x * 0.7071067811865476f));
}

// The cast points that kernels D and E share: the normalised value is rounded
// to the compute dtype, GELU is taken in f32 from that rounded value, and the
// result is rounded again.
template <typename T>
__device__ __forceinline__ T ln_gelu_value(float v, float mu, float rs, float scale, float bias,
                                           int tanh_form) {
  const float normed = (v - mu) * rs * scale + bias;
  return from_f32<T>(gelu_f32(to_f32(from_f32<T>(normed)), tanh_form));
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

// Opt a kernel into more than 48 KB of dynamic shared memory.
template <typename K>
static cudaError_t allow_smem(K kernel, size_t bytes) {
  if (bytes <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(bytes));
}

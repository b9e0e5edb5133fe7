// Kernel D: channel LayerNorm + GELU, the conv frontend's epilogue.
//
// Replaces xai_audio_deepfakes_tpu/ops/pallas_ln_gelu.py::_ln_gelu_pallas
// (the Pallas kernel behind ln_gelu), with the GELU formulations of
// ops/pallas_conv.py::_gelu_kernel.
//
// Per (batch, frame) row over C channels: f32 mean, centred f32 variance,
// rsqrt(var + eps), f32 scale and bias, cast to the compute dtype; then GELU
// (exact erf, or tanh) computed in f32 from that rounded value and cast back.
// These are the cast points of the Pallas kernel. The Pallas version builds
// erf from exp (Abramowitz & Stegun) only because Mosaic has no erf; CUDA
// has erff, and this kernel uses it.
//
// Layout: the activation stays in the [B, C, L] layout that F.conv1d gives
// and takes, so the frontend never transposes its largest tensor
// ([3B, 512, 15999] at the main path's shape). A row's C values are L apart;
// a warp walks 32 neighbouring frames of one channel, so loads and stores
// stay coalesced.
//
// What bounds it on the H100: the bytes. It reads each element once and
// writes it once (~1.56 GB of bf16 over the seven frontend layers at the
// main path's shape, ~0.47 ms at 3.35 TB/s); the arithmetic is a few dozen
// operations per element.
//
// Design: one block per (32 frames, batch row) with 8 channel groups of 32
// threads; each thread keeps its C / 8 values of its frame in registers
// between the statistics and the output, so each element is read from
// device memory exactly once. The output may be the input buffer (the
// wrapper writes in place): every element is read and written by the same
// thread, and read before it is written.
#include <math.h>

#include "common.cuh"

namespace {

constexpr int COLS = 32;                 // frames per block (one warp-width)
constexpr int GROUPS = 8;                // channel groups per block
constexpr int THREADS = COLS * GROUPS;
constexpr int MAX_C = 512;
constexpr int PER_THREAD = MAX_C / GROUPS;

template <typename T>
__global__ void __launch_bounds__(THREADS)
    ln_gelu_kernel(const T* x, const float* __restrict__ scale, const float* __restrict__ bias,
                   T* y, int c, int l, float eps, int tanh_form) {
  __shared__ float red[GROUPS][COLS];
  __shared__ float stat[2][COLS];
  const int col = threadIdx.x % COLS;
  const int grp = threadIdx.x / COLS;
  const int li = blockIdx.x * COLS + col;
  const bool valid = li < l;
  const long long row = static_cast<long long>(blockIdx.y) * c * l + li;

  float vals[PER_THREAD];
  float s = 0.f;
#pragma unroll
  for (int i = 0; i < PER_THREAD; ++i) {
    const int ch = grp + i * GROUPS;
    vals[i] = (valid && ch < c) ? to_f32(x[row + static_cast<long long>(ch) * l]) : 0.f;
    s += vals[i];
  }
  red[grp][col] = s;
  __syncthreads();
  if (grp == 0) {
    float t = 0.f;
#pragma unroll
    for (int g = 0; g < GROUPS; ++g) t += red[g][col];
    stat[0][col] = t / c;
  }
  __syncthreads();
  const float mu = stat[0][col];

  s = 0.f;
#pragma unroll
  for (int i = 0; i < PER_THREAD; ++i) {
    const int ch = grp + i * GROUPS;
    if (ch < c) {
      const float d = vals[i] - mu;
      s += d * d;
    }
  }
  red[grp][col] = s;
  __syncthreads();
  if (grp == 0) {
    float t = 0.f;
#pragma unroll
    for (int g = 0; g < GROUPS; ++g) t += red[g][col];
    stat[1][col] = rsqrtf(t / c + eps);
  }
  __syncthreads();
  const float rs = stat[1][col];
  if (!valid) return;

#pragma unroll
  for (int i = 0; i < PER_THREAD; ++i) {
    const int ch = grp + i * GROUPS;
    if (ch < c) {
      y[row + static_cast<long long>(ch) * l] =
          ln_gelu_value<T>(vals[i], mu, rs, scale[ch], bias[ch], tanh_form);
    }
  }
}

template <typename T>
int launch(const void* x, const void* scale, const void* bias, void* y, int batch, int c, int l,
           float eps, int tanh_form, cudaStream_t stream) {
  const dim3 grid((l + COLS - 1) / COLS, batch);
  ln_gelu_kernel<T><<<grid, THREADS, 0, stream>>>(
      static_cast<const T*>(x), static_cast<const float*>(scale), static_cast<const float*>(bias),
      static_cast<T*>(y), c, l, eps, tanh_form);
  return cudaGetLastError();
}

}  // namespace

ADDV_EXPORT int addv_ln_gelu_max_c() { return MAX_C; }

ADDV_EXPORT int addv_ln_gelu(const void* x, const void* scale, const void* bias, void* y,
                             int batch, int c, int l, float eps, int tanh_form, int dtype,
                             void* stream) {
  if (batch < 1 || c < 1 || c > MAX_C || l < 1) return cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == ADDV_F32) return launch<float>(x, scale, bias, y, batch, c, l, eps, tanh_form, st);
  if (dtype == ADDV_BF16)
    return launch<__nv_bfloat16>(x, scale, bias, y, batch, c, l, eps, tanh_form, st);
  return cudaErrorInvalidValue;
}

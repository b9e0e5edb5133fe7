// Kernel C: inverse DFT + window + overlap-add + envelope division (iSTFT).
//
// Replaces xai_audio_deepfakes_tpu/ops/pallas_stft.py::_make_istft_call (the
// Pallas kernel behind istft_pallas / make_fused_istft, which the JAX
// package only ever ran in interpret mode).
//
// The TPU kernel carries its overlap-add accumulator across sequential grid
// steps. Blocks on the card run in parallel and in no order, so this kernel
// uses the gather form instead: each block owns a span of output samples
// and, for each sample p, sums the (at most ceil(n_fft / hop) + 1) frames
// that cover it, computing only those frames' taps:
//   y[p] = sum_t win[n] * sum_k (re[k, t] A[k, n] + im[k, t] B[k, n]),
//   n = p - t * hop,
// with A, B the inverse bases [bins, n_fft] of ops/stft.py::_idft_bases.
// The operation count equals the frame products', there are no atomics, the
// result does not depend on block order, and no frame tensor is written to
// device memory. The epilogue divides by the window-square envelope (where
// it exceeds 1e-11), applies the centre trim and crops or zero-pads to
// `length`.
//
// What bounds it on the H100: ~4.2 GFLOP of f32 against ~11 MB per call at
// the main path's shape (B = 8), so operations bound it (~63 us at
// 67 TFLOP/s). In this first version each FMA pair needs two basis values
// from L1/L2, so L2 bandwidth limits it; a block serves BT batch rows at once
// so that every basis value it loads feeds BT rows.
//
// Design: one block per (256 output samples, BT batch rows), one thread per
// sample. The coefficients of the frames that cover the span are staged in
// shared memory (BT x 5 frames x 2 x 513 f32 = 82 KB at hop 322).
#include "common.cuh"

namespace {

constexpr int SPAN = 256;  // output samples per block, one per thread
constexpr int BT = 4;      // batch rows per block

int max_frames(int n_fft, int hop) { return (SPAN + n_fft - 2) / hop + 2; }

__global__ void __launch_bounds__(SPAN)
    istft_kernel(const float* __restrict__ re, const float* __restrict__ im,
                 const float* __restrict__ basis_a, const float* __restrict__ basis_b,
                 const float* __restrict__ win, const float* __restrict__ env,
                 float* __restrict__ y, int batch, int bins, int t_len, int n_fft, int hop,
                 int offset, int padded_len, int length, int nf_max) {
  extern __shared__ float coef[];  // [BT][nf_max][2][bins]
  const int b0 = blockIdx.y * BT;
  const int nb = min(BT, batch - b0);
  const int o = blockIdx.x * SPAN + threadIdx.x;  // output sample
  const int p0 = blockIdx.x * SPAN + offset;      // first padded position of the span
  const int t_lo = p0 - n_fft + 1 <= 0 ? 0 : (p0 - n_fft + 1 + hop - 1) / hop;
  const int t_hi = min(t_len - 1, (p0 + SPAN - 1) / hop);
  const int nf = t_hi - t_lo + 1;

  for (int i = threadIdx.x; i < nb * nf * bins; i += SPAN) {
    const int k = i % bins;
    const int f = (i / bins) % nf;
    const int bb = i / (bins * nf);
    const long long src = (static_cast<long long>(b0 + bb) * bins + k) * t_len + t_lo + f;
    float* dst = coef + ((bb * nf_max + f) * 2) * bins;
    dst[k] = re[src];
    dst[bins + k] = im[src];
  }
  __syncthreads();
  if (o >= length) return;

  const int p = o + offset;
  float acc[BT];
#pragma unroll
  for (int bb = 0; bb < BT; ++bb) acc[bb] = 0.f;
  if (p < padded_len) {
    for (int f = 0; f < nf; ++f) {
      const int n = p - (t_lo + f) * hop;
      if (n < 0 || n >= n_fft) continue;
      float fr[BT];
#pragma unroll
      for (int bb = 0; bb < BT; ++bb) fr[bb] = 0.f;
      for (int k = 0; k < bins; ++k) {
        const float a = basis_a[k * n_fft + n];
        const float c = basis_b[k * n_fft + n];
#pragma unroll
        for (int bb = 0; bb < BT; ++bb) {
          const float* cr = coef + ((bb * nf_max + f) * 2) * bins;
          fr[bb] = fmaf(cr[k], a, fmaf(cr[bins + k], c, fr[bb]));
        }
      }
      const float w = win[n];
#pragma unroll
      for (int bb = 0; bb < BT; ++bb) acc[bb] += fr[bb] * w;
    }
  }
  float denom = 1.f;
  if (p < padded_len) {
    const float e = env[p];
    denom = e > 1e-11f ? e : 1.f;
  }
#pragma unroll
  for (int bb = 0; bb < BT; ++bb) {
    if (bb < nb) y[static_cast<long long>(b0 + bb) * length + o] = acc[bb] / denom;
  }
}

}  // namespace

ADDV_EXPORT int addv_istft(const void* re, const void* im, const void* basis_a,
                           const void* basis_b, const void* win, const void* env, void* y,
                           int batch, int t_len, int n_fft, int hop, int center, int length,
                           void* stream) {
  if (batch < 1 || t_len < 1 || n_fft < 2 || hop < 1 || length < 1) return cudaErrorInvalidValue;
  const int bins = n_fft / 2 + 1;
  const int nf_max = max_frames(n_fft, hop);
  const size_t smem = sizeof(float) * static_cast<size_t>(BT) * nf_max * 2 * bins;
  cudaError_t err = allow_smem(istft_kernel, smem);
  if (err != cudaSuccess) return err;
  const int padded_len = n_fft + hop * (t_len - 1);
  const dim3 grid((length + SPAN - 1) / SPAN, (batch + BT - 1) / BT);
  istft_kernel<<<grid, SPAN, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(re), static_cast<const float*>(im),
      static_cast<const float*>(basis_a), static_cast<const float*>(basis_b),
      static_cast<const float*>(win), static_cast<const float*>(env), static_cast<float*>(y),
      batch, bins, t_len, n_fft, hop, center ? n_fft / 2 : 0, padded_len, length, nf_max);
  return cudaGetLastError();
}

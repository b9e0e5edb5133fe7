// Kernel B: fused framing + window + DFT (forward STFT).
//
// Replaces xai_audio_deepfakes_tpu/ops/pallas_stft.py::_make_stft_call (the
// Pallas kernel behind stft_pallas / make_fused_stft).
//
// Input: the reflect-padded signal xp [B, Lp] f32 (the pad is F.pad in the
// wrapper). Frame t starts at t * hop; it is read straight from xp inside
// the kernel, multiplied by the window, and reduced against the cosine and
// (-sine) bases [n_fft, bins] of ops/stft.py::_dft_bases. No [B, T, n_fft]
// frame tensor is written to device memory, which is the point of the TPU
// kernel. Output: re, im [B, bins, T] f32, the layout torch.stft returns.
//
// What bounds it on the H100: at the main path's shape (B = 8, 80000
// samples) the DFT is ~4.2 GFLOP of f32 against ~11 MB of input and output,
// so it is bound by operations (~63 us at the 67 TFLOP/s f32 rate of the
// CUDA cores). The bases (2 x 2.1 MB) stay in L2.
//
// Design: one block per (128 bins, 16 frames, batch row). The 16 windowed
// frames sit in shared memory (16 x 1024 f32 = 64 KB); each thread owns one
// bin and keeps 16 real and 16 imaginary sums in registers, so each basis
// value read from L2 feeds 16 FMAs and each frame value is a shared-memory
// broadcast. No TPU tiling (batch padding, 128-aligned loads plus rotate) is
// carried over: a thread reads any sample offset directly.
#include "common.cuh"

namespace {

constexpr int TT = 16;   // frames per block
constexpr int KB = 128;  // bins per block, one per thread

__global__ void __launch_bounds__(KB)
    stft_kernel(const float* __restrict__ xp, const float* __restrict__ win,
                const float* __restrict__ cosb, const float* __restrict__ sinb,
                float* __restrict__ re, float* __restrict__ im, int padded_len, int t_len,
                int n_fft, int hop, int bins) {
  extern __shared__ float frames[];  // [TT][n_fft]
  const int b = blockIdx.z;
  const int t0 = blockIdx.y * TT;
  const int k = blockIdx.x * KB + threadIdx.x;
  const float* x = xp + static_cast<long long>(b) * padded_len;

  for (int i = threadIdx.x; i < TT * n_fft; i += KB) {
    const int tt = i / n_fft, n = i % n_fft;
    const int t = t0 + tt;
    frames[i] = t < t_len ? x[static_cast<long long>(t) * hop + n] * win[n] : 0.f;
  }
  __syncthreads();
  if (k >= bins) return;

  float acc_re[TT], acc_im[TT];
#pragma unroll
  for (int tt = 0; tt < TT; ++tt) acc_re[tt] = acc_im[tt] = 0.f;
  for (int n = 0; n < n_fft; ++n) {
    const float c = cosb[n * bins + k];
    const float s = sinb[n * bins + k];
#pragma unroll
    for (int tt = 0; tt < TT; ++tt) {
      const float f = frames[tt * n_fft + n];
      acc_re[tt] = fmaf(f, c, acc_re[tt]);
      acc_im[tt] = fmaf(f, s, acc_im[tt]);
    }
  }
  const long long out = (static_cast<long long>(b) * bins + k) * t_len;
#pragma unroll
  for (int tt = 0; tt < TT; ++tt) {
    if (t0 + tt < t_len) {
      re[out + t0 + tt] = acc_re[tt];
      im[out + t0 + tt] = acc_im[tt];
    }
  }
}

}  // namespace

ADDV_EXPORT int addv_stft(const void* xp, const void* win, const void* cosb, const void* sinb,
                          void* re, void* im, int batch, int padded_len, int t_len, int n_fft,
                          int hop, void* stream) {
  if (batch < 1 || t_len < 1 || n_fft < 1 || hop < 1 ||
      static_cast<long long>(t_len - 1) * hop + n_fft > padded_len)
    return cudaErrorInvalidValue;
  const int bins = n_fft / 2 + 1;
  const size_t smem = sizeof(float) * TT * static_cast<size_t>(n_fft);
  cudaError_t err = allow_smem(stft_kernel, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((bins + KB - 1) / KB, (t_len + TT - 1) / TT, batch);
  stft_kernel<<<grid, KB, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(xp), static_cast<const float*>(win),
      static_cast<const float*>(cosb), static_cast<const float*>(sinb), static_cast<float*>(re),
      static_cast<float*>(im), padded_len, t_len, n_fft, hop, bins);
  return cudaGetLastError();
}

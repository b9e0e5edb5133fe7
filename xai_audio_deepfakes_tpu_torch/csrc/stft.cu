// Kernel B: fused framing + window + one-sided DFT (forward STFT).
//
// Replaces xai_audio_deepfakes_tpu/ops/pallas_stft.py::_make_stft_call (the
// Pallas kernel behind stft_pallas / make_fused_stft).
//
// Input: the signal x [B, L] f32. Frame t covers the padded signal's samples
// t * hop .. t * hop + n_fft - 1. With pad > 0 (center with reflect padding)
// the reflect pad is folded into the read: padded index p reads x[p - pad],
// where an index i < 0 reads x[-i] and i >= L reads x[2L - 2 - i], so no
// padded copy is made. With pad = 0 the caller has padded x itself. Each
// sample is multiplied by the window as it is read. No [B, T, n_fft] frame
// tensor reaches device memory, which is the point of the TPU kernel.
// Output: re, im [B, bins, T] f32, the layout torch.stft returns.
//
// What bounds it on the H100: at the main path's shape (B = 8, 80000
// samples, n_fft 1024, 249 frames) the function moves ~10.7 MB (the signal
// read once, re and im written once: 3.2 us at 3.35 TB/s) against ~27 MFLOP
// through an FFT, so it is bound by bytes.
//
// Two bodies:
//  * a power-of-two n_fft up to 8192 (every configuration of the repo): an
//    FFT in shared memory, stft_fft_kernel;
//  * any other n_fft: a direct DFT against the cosine and (-sine) bases
//    [n_fft, bins] of ops/stft.py::_dft_bases, stft_dft_kernel.
#include <algorithm>

#include "fft.cuh"

namespace {

// Sample p of the padded signal (see above).
__device__ __forceinline__ float padded_sample(const float* __restrict__ x, int p, int len,
                                               int pad) {
  int i = p - pad;
  if (i < 0) i = -i;
  else if (i >= len) i = 2 * len - 2 - i;
  return x[i];
}

// ---------------------------------------------------------------------------
// FFT body.
//
// A real frame of N = n_fft samples is one complex FFT of M = N / 2 points,
// z[n] = x[2n] + i x[2n + 1], then a split step gives bins 0 .. M:
//   X[k] = (Z[k] + Z*[M - k]) / 2 - i W^k (Z[k] - Z*[M - k]) / 2,
// W = e^{-2 pi i / N}, Z[M] = Z[0]. The M-point FFT is the Stockham core of
// fft.cuh, shared with kernel C.
// A block takes `frames` frames of one batch row (8 at n_fft 1024: 256
// blocks for 8 clips of 249 frames). The split step writes its bins
// [bin][frame] over the free buffer, so that each bin's run of consecutive
// frames is written to device memory together.
constexpr int FFT_THREADS = 256;
constexpr int FFT_MAX_N = 8192;

int fft_frames(int n_fft) { return std::max(1, std::min(8, FFT_MAX_N / n_fft)); }

size_t fft_smem_bytes(int n_fft) {
  const size_t m = n_fft / 2;
  return sizeof(float2) * (n_fft + 2 * static_cast<size_t>(fft_frames(n_fft)) * (m + 1));
}

__global__ void __launch_bounds__(FFT_THREADS)
    stft_fft_kernel(const float* __restrict__ x, const float* __restrict__ win,
                    const float2* __restrict__ twiddles, float* __restrict__ re,
                    float* __restrict__ im, int sig_len, int pad, int t_len, int n_fft, int hop,
                    int frames) {
  extern __shared__ float2 fft_smem[];
  const int m = n_fft / 2, bins = m + 1;
  float2* tw = fft_smem;                // [n_fft]
  float2* src = tw + n_fft;             // [frames][m + 1]
  float2* dst = src + frames * (m + 1);  // [frames][m + 1]
  const int b = blockIdx.y, t0 = blockIdx.x * frames;
  const int nf = min(frames, t_len - t0);
  const float* xb = x + static_cast<long long>(b) * sig_len;

  for (int i = threadIdx.x; i < n_fft; i += FFT_THREADS) tw[i] = twiddles[i];
  // unrolled so that several samples' loads are in flight at once
#pragma unroll 4
  for (int i = threadIdx.x; i < frames * m; i += FFT_THREADS) {
    const int f = i / m, n = i % m;
    float2 z = make_float2(0.f, 0.f);
    if (f < nf) {
      const int p = (t0 + f) * hop + 2 * n;
      z = make_float2(padded_sample(xb, p, sig_len, pad) * win[2 * n],
                      padded_sample(xb, p + 1, sig_len, pad) * win[2 * n + 1]);
    }
    src[f * (m + 1) + n] = z;
  }
  __syncthreads();

  {
    float2* out = fft_all_stages<FFT_THREADS>(src, dst, tw, frames, m, n_fft);
    dst = out == src ? dst : src;
    src = out;
  }

  // split step; the bins go [bin][frame] over the free buffer
  float* out_re = reinterpret_cast<float*>(dst);
  float* out_im = out_re + bins * frames;
  for (int i = threadIdx.x; i < frames * bins; i += FFT_THREADS) {
    const int k = i / frames, f = i % frames;
    const float2* z = src + f * (m + 1);
    const float2 zk = z[k == m ? 0 : k];
    const float2 zr = z[k == 0 ? 0 : m - k];
    const float2 sum = make_float2(zk.x + zr.x, zk.y - zr.y);  // Z[k] + Z*[M - k]
    const float2 dif = make_float2(zk.x - zr.x, zk.y + zr.y);  // Z[k] - Z*[M - k]
    const float2 w = cmul(tw[k], dif);
    out_re[i] = 0.5f * (sum.x + w.y);  // sum / 2 - i w / 2
    out_im[i] = 0.5f * (sum.y - w.x);
  }
  __syncthreads();
  for (int i = threadIdx.x; i < bins * nf; i += FFT_THREADS) {
    const int k = i / nf, f = i % nf;
    const long long o = (static_cast<long long>(b) * bins + k) * t_len + t0 + f;
    re[o] = out_re[k * frames + f];
    im[o] = out_im[k * frames + f];
  }
}

// ---------------------------------------------------------------------------
// Direct-DFT body, for an n_fft that is not a power of two.
//
// One block per (128 bins, 16 frames, batch row). The 16 windowed frames
// sit in shared memory (16 x n_fft f32); each thread owns one bin and keeps
// 16 real and 16 imaginary sums in registers, so each basis value read from
// L2 feeds 16 FMAs and each frame value is a shared-memory broadcast. It
// does 4 N (N/2 + 1) operations per frame, N/log2 N times an FFT's.
constexpr int TT = 16;   // frames per block
constexpr int KB = 128;  // bins per block, one per thread

__global__ void __launch_bounds__(KB)
    stft_dft_kernel(const float* __restrict__ x, const float* __restrict__ win,
                    const float* __restrict__ cosb, const float* __restrict__ sinb,
                    float* __restrict__ re, float* __restrict__ im, int sig_len, int pad,
                    int t_len, int n_fft, int hop, int bins) {
  extern __shared__ float frames[];  // [TT][n_fft]
  const int b = blockIdx.z;
  const int t0 = blockIdx.y * TT;
  const int k = blockIdx.x * KB + threadIdx.x;
  const float* xb = x + static_cast<long long>(b) * sig_len;

  for (int i = threadIdx.x; i < TT * n_fft; i += KB) {
    const int tt = i / n_fft, n = i % n_fft;
    const int t = t0 + tt;
    frames[i] = t < t_len ? padded_sample(xb, t * hop + n, sig_len, pad) * win[n] : 0.f;
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

// The frames fit the padded signal, and a folded reflect pad is shorter
// than the signal (as F.pad's reflect mode requires).
bool frames_fit(int batch, int sig_len, int pad, int t_len, int n_fft, int hop) {
  return batch >= 1 && t_len >= 1 && n_fft >= 1 && hop >= 1 && pad >= 0 &&
         (pad == 0 || pad < sig_len) &&
         static_cast<long long>(t_len - 1) * hop + n_fft <= static_cast<long long>(sig_len) + 2 * pad;
}

}  // namespace

ADDV_EXPORT int addv_stft_fft(const void* x, const void* win, const void* twiddles, void* re,
                              void* im, int batch, int sig_len, int pad, int t_len, int n_fft,
                              int hop, void* stream) {
  if (!frames_fit(batch, sig_len, pad, t_len, n_fft, hop) || n_fft < 2 || n_fft > FFT_MAX_N ||
      (n_fft & (n_fft - 1)) != 0)
    return cudaErrorInvalidValue;
  const size_t smem = fft_smem_bytes(n_fft);
  cudaError_t err = allow_smem(stft_fft_kernel, smem);
  if (err != cudaSuccess) return err;
  const int frames = fft_frames(n_fft);
  const dim3 grid((t_len + frames - 1) / frames, batch);
  stft_fft_kernel<<<grid, FFT_THREADS, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(x), static_cast<const float*>(win),
      static_cast<const float2*>(twiddles), static_cast<float*>(re), static_cast<float*>(im),
      sig_len, pad, t_len, n_fft, hop, frames);
  return cudaGetLastError();
}

ADDV_EXPORT int addv_stft(const void* x, const void* win, const void* cosb, const void* sinb,
                          void* re, void* im, int batch, int sig_len, int pad, int t_len,
                          int n_fft, int hop, void* stream) {
  if (!frames_fit(batch, sig_len, pad, t_len, n_fft, hop)) return cudaErrorInvalidValue;
  const int bins = n_fft / 2 + 1;
  const size_t smem = sizeof(float) * TT * static_cast<size_t>(n_fft);
  cudaError_t err = allow_smem(stft_dft_kernel, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((bins + KB - 1) / KB, (t_len + TT - 1) / TT, batch);
  stft_dft_kernel<<<grid, KB, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(x), static_cast<const float*>(win),
      static_cast<const float*>(cosb), static_cast<const float*>(sinb), static_cast<float*>(re),
      static_cast<float*>(im), sig_len, pad, t_len, n_fft, hop, bins);
  return cudaGetLastError();
}

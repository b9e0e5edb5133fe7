// Kernel C: inverse DFT + window + overlap-add + envelope division (iSTFT).
//
// Replaces xai_audio_deepfakes_tpu/ops/pallas_stft.py::_make_istft_call (the
// Pallas kernel behind istft_pallas / make_fused_istft, which the JAX
// package only ever ran in interpret mode).
//
//   y[p] = sum_t win[p - t hop] frame_t[p - t hop],  frame_t = irDFT(re[:, t], im[:, t]),
// then division by the window-square envelope where it exceeds 1e-11, the
// centre trim (n_fft / 2) and a crop or zero-pad to `length`. The inverse
// DFT is the one of ops/stft.py::_idft_bases, whose sine rows are 0 at bins
// 0 and n_fft / 2: Im[0] and Im[n_fft / 2] never reach the result.
//
// The TPU kernel carries its overlap-add accumulator across sequential grid
// steps. Blocks on the card run in parallel and in no order, so this kernel
// gathers instead: each block owns a span of output samples and sums, for
// each of them, the frames that cover it. No atomics, no dependence on block
// order, no frame tensor in device memory.
//
// What bounds it on the H100: at the main path's shape (B = 8, 249 frames,
// n_fft 1024) it moves 10.74 MB (re and im read once, y written once:
// 3.2 us at 3.35 TB/s) against ~27 MFLOP through an FFT, so it is bound by
// bytes.
//
// Two bodies:
//  * a power-of-two n_fft up to 8192 with hop <= n_fft (every configuration
//    of the repo): inverse real FFTs in shared memory on kernel B's Stockham
//    core (fft.cuh), istft_fft_kernel;
//  * anything else: a direct inverse DFT against the bases [bins, n_fft] of
//    _idft_bases, istft_dft_kernel.
#include <algorithm>

#include "fft.cuh"

namespace {

// ---------------------------------------------------------------------------
// FFT body.
//
// Inverse real FFT by the half-length trick: with M = n_fft / 2 and
// W = e^{-2 pi i / n_fft}, the M-point spectrum
//   Z[k] = (X[k] + X*[M - k]) + i W^{-k} (X[k] - X*[M - k]),  k = 0 .. M - 1,
// after Im[0] and Im[M] are set to 0, has the inverse M-point DFT
// z[n] = n_fft x[2n] + i n_fft x[2n + 1]. The inverse runs as
// conj(FFT(conj(Z))) on the forward core, and the 1 / n_fft (a power of two)
// is exact.
//
// Tiling: a block owns SF frames' hop (SF = 8 at n_fft 1024: 2576 padded
// positions, 32 spans per clip, 256 blocks at B = 8) of one batch row. It
// transforms the SF + (n_fft - 1) / hop frames that touch the span (11 at
// n_fft 1024, hop 322: 1.4x the frames, the overlap's redundancy), G at a
// time (all 11 at once there), each chunk in four kinds of barrier-separated
// phases: load the bins [frame][bin], pack Z, log8 M Stockham stages (3), and
// the gather that adds each covering frame's windowed sample to the
// span's accumulator in shared memory, in frame order. The epilogue divides by
// the envelope, trims and crops. Shared memory at n_fft 1024: the twiddles
// (8 KB), two 11 x 513 float2 buffers (90 KB) and the span (10 KB), so two
// blocks an SM.
constexpr int FFT_THREADS = 256;
constexpr int FFT_MAX_N = 8192;
constexpr size_t FFT_SMEM_BUDGET = 220 * 1024;

int span_frames(int n_fft) { return std::max(1, std::min(8, FFT_MAX_N / n_fft)); }

__global__ void __launch_bounds__(FFT_THREADS)
    istft_fft_kernel(const float* __restrict__ re, const float* __restrict__ im,
                     const float* __restrict__ win, const float2* __restrict__ twiddles,
                     const float* __restrict__ env, float* __restrict__ y, int t_len, int n_fft,
                     int hop, int offset, int padded_len, int length, int span, int first_span,
                     int chunk) {
  extern __shared__ float2 fft_smem[];
  const int m = n_fft / 2, bins = m + 1;
  float2* tw = fft_smem;                 // [n_fft]
  float2* buf_a = tw + n_fft;            // [chunk][m + 1]
  float2* buf_b = buf_a + chunk * bins;  // [chunk][m + 1]
  float* acc = reinterpret_cast<float*>(buf_b + chunk * bins);  // [span]
  const int b = blockIdx.y;
  const int p0 = (blockIdx.x + first_span) * span;  // first padded position of the span
  const int t_first = p0 - n_fft + 1 <= 0 ? 0 : (p0 - n_fft + hop) / hop;
  const int t_last = min(t_len - 1, (p0 + span - 1) / hop);
  const float* re_b = re + static_cast<long long>(b) * bins * t_len;
  const float* im_b = im + static_cast<long long>(b) * bins * t_len;
  const float inv_n = 1.f / n_fft;

  for (int i = threadIdx.x; i < n_fft; i += FFT_THREADS) tw[i] = twiddles[i];
  for (int i = threadIdx.x; i < span; i += FFT_THREADS) acc[i] = 0.f;

  for (int c0 = t_first; c0 <= t_last; c0 += chunk) {
    const int g = min(chunk, t_last - c0 + 1);
    // the bins [frame][bin], Im[0] and Im[M] dropped
    for (int i = threadIdx.x; i < g * bins; i += FFT_THREADS) {
      const int k = i / g, f = i % g;
      const long long src = static_cast<long long>(k) * t_len + c0 + f;
      buf_a[f * bins + k] = make_float2(re_b[src], k == 0 || k == m ? 0.f : im_b[src]);
    }
    __syncthreads();
    // conj(Z[k]) for k < M
    for (int i = threadIdx.x; i < g * m; i += FFT_THREADS) {
      const int f = i / m, k = i % m;
      const float2 xk = buf_a[f * bins + k], xr = buf_a[f * bins + m - k];
      const float2 sum = make_float2(xk.x + xr.x, xk.y - xr.y);  // X[k] + X*[M - k]
      const float2 dif = make_float2(xk.x - xr.x, xk.y + xr.y);  // X[k] - X*[M - k]
      const float2 q = cmul(make_float2(tw[k].x, -tw[k].y), dif);  // W^{-k} dif
      buf_b[f * bins + k] = make_float2(sum.x - q.y, -(sum.y + q.x));  // conj(sum + i q)
    }
    __syncthreads();
    const float2* z = fft_all_stages<FFT_THREADS>(buf_b, buf_a, tw, g, m, n_fft);
    // each span sample adds its covering frames of this chunk, in frame order
    for (int i = threadIdx.x; i < span; i += FFT_THREADS) {
      const int p = p0 + i;
      if (p >= padded_len) continue;
      const int t_lo = max(c0, p - n_fft + 1 <= 0 ? 0 : (p - n_fft + hop) / hop);
      const int t_hi = min(c0 + g - 1, p / hop);
      float a = acc[i];
      for (int t = t_lo; t <= t_hi; ++t) {
        const int n = p - t * hop;
        const float2 v = z[(t - c0) * bins + n / 2];
        a += win[n] * ((n & 1 ? -v.y : v.x) * inv_n);  // conj of the forward result
      }
      acc[i] = a;
    }
    __syncthreads();
  }

  float* yb = y + static_cast<long long>(b) * length;
  for (int i = threadIdx.x; i < span; i += FFT_THREADS) {
    const int p = p0 + i, o = p - offset;
    if (o < 0 || o >= length) continue;
    float v = 0.f;  // zero-pad past the signal
    if (p < padded_len) {
      const float e = env[p];
      v = acc[i] / (e > 1e-11f ? e : 1.f);
    }
    yb[o] = v;
  }
}

// ---------------------------------------------------------------------------
// Direct-DFT body, for any other n_fft or hop.
//
// For each output sample p the block sums the (at most
// ceil(n_fft / hop) + 1) covering frames, computing only those frames' taps:
//   y[p] = sum_t win[n] * sum_k (re[k, t] A[k, n] + im[k, t] B[k, n]),
//   n = p - t * hop,
// with A, B the inverse bases [bins, n_fft] of ops/stft.py::_idft_bases.
// Each FMA pair reads two basis values from L1/L2, so L2 bandwidth limits
// it; a block serves BT batch rows at once so that every basis value it
// loads feeds BT rows. One block per (256 output samples, BT batch rows),
// one thread per sample; the coefficients of the frames that cover the span
// are staged in shared memory (BT x 5 frames x 2 x 513 f32 = 82 KB at hop
// 322).

constexpr int SPAN = 256;  // output samples per block, one per thread
constexpr int BT = 4;      // batch rows per block

int max_frames(int n_fft, int hop) { return (SPAN + n_fft - 2) / hop + 2; }

__global__ void __launch_bounds__(SPAN)
    istft_dft_kernel(const float* __restrict__ re, const float* __restrict__ im,
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

ADDV_EXPORT int addv_istft_fft(const void* re, const void* im, const void* win,
                               const void* twiddles, const void* env, void* y, int batch, int t_len,
                               int n_fft, int hop, int center, int length, void* stream) {
  if (batch < 1 || batch > 65535 || t_len < 1 || n_fft < 2 || n_fft > FFT_MAX_N ||
      (n_fft & (n_fft - 1)) != 0 || hop < 1 || hop > n_fft || length < 1)
    return cudaErrorInvalidValue;
  const int bins = n_fft / 2 + 1;
  const int span = span_frames(n_fft) * hop;
  const int frames_touching = span_frames(n_fft) + (n_fft - 1) / hop;
  const size_t fixed = sizeof(float2) * n_fft + sizeof(float) * span;
  const size_t per_frame = 2 * sizeof(float2) * bins;
  if (fixed + per_frame > FFT_SMEM_BUDGET) return cudaErrorInvalidValue;
  const int chunk = static_cast<int>(
      std::min<size_t>(frames_touching, (FFT_SMEM_BUDGET - fixed) / per_frame));
  const size_t smem = fixed + per_frame * chunk;
  cudaError_t err = allow_smem(istft_fft_kernel, smem);
  if (err != cudaSuccess) return err;
  const int offset = center ? n_fft / 2 : 0;
  const int first_span = offset / span;
  const dim3 grid((offset + length + span - 1) / span - first_span, batch);
  istft_fft_kernel<<<grid, FFT_THREADS, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(re), static_cast<const float*>(im),
      static_cast<const float*>(win), static_cast<const float2*>(twiddles),
      static_cast<const float*>(env), static_cast<float*>(y), t_len, n_fft, hop, offset,
      n_fft + hop * (t_len - 1), length, span, first_span, chunk);
  return cudaGetLastError();
}

ADDV_EXPORT int addv_istft(const void* re, const void* im, const void* basis_a,
                           const void* basis_b, const void* win, const void* env, void* y,
                           int batch, int t_len, int n_fft, int hop, int center, int length,
                           void* stream) {
  if (batch < 1 || t_len < 1 || n_fft < 2 || hop < 1 || length < 1) return cudaErrorInvalidValue;
  const int bins = n_fft / 2 + 1;
  const int nf_max = max_frames(n_fft, hop);
  const size_t smem = sizeof(float) * static_cast<size_t>(BT) * nf_max * 2 * bins;
  cudaError_t err = allow_smem(istft_dft_kernel, smem);
  if (err != cudaSuccess) return err;
  const int padded_len = n_fft + hop * (t_len - 1);
  const dim3 grid((length + SPAN - 1) / SPAN, (batch + BT - 1) / BT);
  istft_dft_kernel<<<grid, SPAN, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(re), static_cast<const float*>(im),
      static_cast<const float*>(basis_a), static_cast<const float*>(basis_b),
      static_cast<const float*>(win), static_cast<const float*>(env), static_cast<float*>(y),
      batch, bins, t_len, n_fft, hop, center ? n_fft / 2 : 0, padded_len, length, nf_max);
  return cudaGetLastError();
}

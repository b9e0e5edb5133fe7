// The shared-memory FFT core of kernels B (stft.cu) and C (istft.cu).
//
// A Stockham autosort FFT of m points (natural order in and out, no
// bit-reversal pass): radix-8 stages, then one radix-4 or radix-2 stage for
// what is left (512 = 8^3 at n_fft 1024). Each stage reads one shared buffer
// and writes the other. Twiddles come from a table of W^j = e^{-2 pi i j /
// n_fft}, j = 0 .. n_fft - 1, made in float64 on the host
// (ops/stft.py::_fft_twiddles), never from __sinf / __cosf; a stage's
// W_{ns R}^{r k} is W^{r k n_fft / (ns R)}. The transform is the forward one
// (e^{-i}); kernel C gets the inverse as conj(FFT(conj(z))).
#pragma once

#include "common.cuh"

__device__ __forceinline__ float2 cadd(float2 a, float2 b) { return make_float2(a.x + b.x, a.y + b.y); }
__device__ __forceinline__ float2 csub(float2 a, float2 b) { return make_float2(a.x - b.x, a.y - b.y); }
__device__ __forceinline__ float2 cmul(float2 a, float2 b) {
  return make_float2(a.x * b.x - a.y * b.y, a.x * b.y + a.y * b.x);
}
__device__ __forceinline__ float2 mul_neg_i(float2 a) { return make_float2(a.y, -a.x); }

// In-register DFT of R points, natural order in and out.
template <int R>
__device__ __forceinline__ void dft(float2 (&v)[R]);

template <>
__device__ __forceinline__ void dft<2>(float2 (&v)[2]) {
  const float2 a = v[0], b = v[1];
  v[0] = cadd(a, b);
  v[1] = csub(a, b);
}

template <>
__device__ __forceinline__ void dft<4>(float2 (&v)[4]) {
  const float2 t0 = cadd(v[0], v[2]), t1 = csub(v[0], v[2]);
  const float2 t2 = cadd(v[1], v[3]), t3 = mul_neg_i(csub(v[1], v[3]));
  v[0] = cadd(t0, t2);
  v[1] = cadd(t1, t3);
  v[2] = csub(t0, t2);
  v[3] = csub(t1, t3);
}

template <>
__device__ __forceinline__ void dft<8>(float2 (&v)[8]) {
  float2 e[4] = {v[0], v[2], v[4], v[6]}, o[4] = {v[1], v[3], v[5], v[7]};
  dft<4>(e);
  dft<4>(o);
  constexpr float c = 0.70710678118654752f;
  o[1] = make_float2(c * (o[1].x + o[1].y), c * (o[1].y - o[1].x));   // * (1 - i) / sqrt 2
  o[2] = mul_neg_i(o[2]);                                              // * -i
  o[3] = make_float2(c * (o[3].y - o[3].x), -c * (o[3].x + o[3].y));  // * -(1 + i) / sqrt 2
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    v[k] = cadd(e[k], o[k]);
    v[k + 4] = csub(e[k], o[k]);
  }
}

// One Stockham stage over `frames` frames of m points (frame stride m + 1),
// run by THREADS threads: butterfly j takes src[j + r m / R], r = 0 .. R - 1,
// twiddles them by W_{ns R}^{r k} with k = j mod ns, and writes its R
// outputs to dst[(j - k) R + k + r ns].
template <int R, int THREADS>
__device__ __forceinline__ void fft_stage(const float2* src, float2* dst, const float2* tw,
                                          int frames, int m, int ns, int n_fft) {
  const int per_frame = m / R;
  const int tw_step = n_fft / (ns * R);
  for (int i = threadIdx.x; i < frames * per_frame; i += THREADS) {
    const int f = i / per_frame, j = i % per_frame;
    const float2* s = src + f * (m + 1);
    float2* d = dst + f * (m + 1);
    const int k = j % ns;
    float2 v[R];
#pragma unroll
    for (int r = 0; r < R; ++r) v[r] = s[j + r * per_frame];
#pragma unroll
    for (int r = 1; r < R; ++r) v[r] = cmul(v[r], tw[r * k * tw_step]);
    dft<R>(v);
    const int out0 = (j - k) * R + k;
#pragma unroll
    for (int r = 0; r < R; ++r) d[out0 + r * ns] = v[r];
  }
}

// The whole m-point FFT of `frames` frames held in `src`, ping-ponging with
// `dst`, one barrier after each stage. Returns the buffer that holds the
// result; the other one is free.
template <int THREADS>
__device__ __forceinline__ float2* fft_all_stages(float2* src, float2* dst, const float2* tw,
                                                  int frames, int m, int n_fft) {
  for (int ns = 1; ns < m;) {
    const int left = m / ns;
    if (left >= 8) {
      fft_stage<8, THREADS>(src, dst, tw, frames, m, ns, n_fft);
      ns *= 8;
    } else if (left == 4) {
      fft_stage<4, THREADS>(src, dst, tw, frames, m, ns, n_fft);
      ns *= 4;
    } else {
      fft_stage<2, THREADS>(src, dst, tw, frames, m, ns, n_fft);
      ns *= 2;
    }
    __syncthreads();
    float2* done = dst;
    dst = src;
    src = done;
  }
  return src;
}

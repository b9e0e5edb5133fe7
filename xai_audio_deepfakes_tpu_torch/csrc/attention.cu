// Kernel A: fused multi-head attention on head-padded activations.
//
// Replaces xai_audio_deepfakes_tpu/ops/attention.py::_make_attention_call
// (the Pallas kernel behind attention_pallas / attention).
//
// Computes, per (batch, head): s = q k^T in f32 over the T valid keys,
// p = exp(s - rowmax), ctx = (p cast to the compute dtype) . v with f32
// accumulation, and only then ctx / rowsum(p) with the f32 p, cast to the
// compute dtype. That is the Pallas kernel's order of operations, not
// attention_reference's (which normalises p before the pv product).
// q, k, v, out: [B, T, NH * 128] row-major, q pre-scaled by hd^-0.5, head dim
// zero-padded to 128 by the port's HeadDense (pad lanes are exact zeros).
//
// What bounds it on the H100: at the main path's shape (3B = 24, T = 249,
// 16 heads) a layer moves ~98 MB of bf16 and does ~12 GFLOP, so on the
// tensor cores it would be bound by memory (~29 us). This first version
// computes on the CUDA cores in f32 from shared memory, so it is bound by
// shared-memory loads (about two per FMA), not by either roofline term.
//
// Design: one block per (32-query-row tile, head, batch). The whole
// [32 x T] score tile sits in shared memory (32 x 249 f32 = 32 KB), so no
// online softmax is needed, as in the TPU kernel. Keys and values are staged
// 64 rows at a time as f32 with a padded row stride (129) so that a warp
// walking 32 keys hits 32 banks. Rows >= T are never loaded or written:
// loops are bounded by T instead of masking padded bits.
#include <math.h>

#include "common.cuh"

namespace {

constexpr int ROWS = 32;     // query rows per block
constexpr int KCHUNK = 64;   // key / value rows staged at once
constexpr int HDP = 128;     // padded head dim
constexpr int LD = HDP + 1;  // shared-memory row stride (bank-conflict free)
constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
constexpr int OUT_PER_THREAD = ROWS * HDP / THREADS;

size_t smem_bytes(int t_len) {
  return sizeof(float) * (static_cast<size_t>(ROWS) * LD + static_cast<size_t>(KCHUNK) * LD +
                          static_cast<size_t>(ROWS) * t_len + ROWS);
}

template <typename T>
__global__ void __launch_bounds__(THREADS)
    attention_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                     T* __restrict__ out, int t_len, int nh) {
  extern __shared__ float smem[];
  float* qs = smem;                // [ROWS][LD]
  float* kv = qs + ROWS * LD;      // [KCHUNK][LD]
  float* s = kv + KCHUNK * LD;     // [ROWS][t_len]
  float* row_sum = s + ROWS * t_len;  // [ROWS]

  const int row0 = blockIdx.x * ROWS;
  const int rows = min(ROWS, t_len - row0);
  const long long stride_t = static_cast<long long>(nh) * HDP;
  const long long base =
      static_cast<long long>(blockIdx.z) * t_len * stride_t + static_cast<long long>(blockIdx.y) * HDP;
  const int tid = threadIdx.x;

  for (int i = tid; i < ROWS * HDP; i += THREADS) {
    const int r = i / HDP, d = i % HDP;
    qs[r * LD + d] = r < rows ? to_f32(q[base + (row0 + r) * stride_t + d]) : 0.f;
  }

  // scores, f32
  for (int j0 = 0; j0 < t_len; j0 += KCHUNK) {
    const int kn = min(KCHUNK, t_len - j0);
    __syncthreads();
    for (int i = tid; i < kn * HDP; i += THREADS) {
      const int j = i / HDP, d = i % HDP;
      kv[j * LD + d] = to_f32(k[base + (j0 + j) * stride_t + d]);
    }
    __syncthreads();
    for (int i = tid; i < rows * KCHUNK; i += THREADS) {
      const int r = i / KCHUNK, j = i % KCHUNK;
      if (j < kn) {
        const float* qr = qs + r * LD;
        const float* kr = kv + j * LD;
        float acc = 0.f;
#pragma unroll 16
        for (int d = 0; d < HDP; ++d) acc = fmaf(qr[d], kr[d], acc);
        s[r * t_len + j0 + j] = acc;
      }
    }
  }
  __syncthreads();

  // softmax numerator: one warp per row. The row sum uses the f32 p; the
  // tile keeps p rounded to the compute dtype for the pv product.
  const int warp = tid / 32, lane = tid % 32;
  for (int r = warp; r < rows; r += WARPS) {
    float* sr = s + r * t_len;
    float m = -INFINITY;
    for (int j = lane; j < t_len; j += 32) m = fmaxf(m, sr[j]);
    m = warp_max(m);
    float sum = 0.f;
    for (int j = lane; j < t_len; j += 32) {
      const float p = expf(sr[j] - m);
      sum += p;
      sr[j] = to_f32(from_f32<T>(p));
    }
    sum = warp_sum(sum);
    if (lane == 0) row_sum[r] = sum;
  }

  // ctx = p . v, each thread owns OUT_PER_THREAD (row, lane) outputs; a warp
  // covers 32 consecutive lanes of one row
  float acc[OUT_PER_THREAD];
#pragma unroll
  for (int n = 0; n < OUT_PER_THREAD; ++n) acc[n] = 0.f;
  for (int j0 = 0; j0 < t_len; j0 += KCHUNK) {
    const int kn = min(KCHUNK, t_len - j0);
    __syncthreads();
    for (int i = tid; i < kn * HDP; i += THREADS) {
      const int j = i / HDP, d = i % HDP;
      kv[j * LD + d] = to_f32(v[base + (j0 + j) * stride_t + d]);
    }
    __syncthreads();
#pragma unroll
    for (int n = 0; n < OUT_PER_THREAD; ++n) {
      const int idx = tid + n * THREADS;
      const int r = idx / HDP, d = idx % HDP;
      if (r < rows) {
        const float* pr = s + r * t_len + j0;
        float a = acc[n];
        for (int j = 0; j < kn; ++j) a = fmaf(pr[j], kv[j * LD + d], a);
        acc[n] = a;
      }
    }
  }

#pragma unroll
  for (int n = 0; n < OUT_PER_THREAD; ++n) {
    const int idx = tid + n * THREADS;
    const int r = idx / HDP, d = idx % HDP;
    if (r < rows) out[base + (row0 + r) * stride_t + d] = from_f32<T>(acc[n] / row_sum[r]);
  }
}

template <typename T>
int launch(const void* q, const void* k, const void* v, void* out, int b, int t_len, int nh,
           cudaStream_t stream) {
  const size_t smem = smem_bytes(t_len);
  cudaError_t err = allow_smem(attention_kernel<T>, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((t_len + ROWS - 1) / ROWS, nh, b);
  attention_kernel<T><<<grid, THREADS, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<T*>(out), t_len, nh);
  return cudaGetLastError();
}

}  // namespace

// Largest T the score tile fits for (the wrapper checks it before launching).
ADDV_EXPORT int addv_attention_max_t() {
  int t = 1;
  while (smem_bytes(t + 1) <= 227 * 1024) ++t;
  return t;
}

ADDV_EXPORT int addv_attention(const void* q, const void* k, const void* v, void* out, int b,
                               int t_len, int nh, int hdp, int dtype, void* stream) {
  if (hdp != HDP || t_len < 1 || b < 1 || nh < 1) return cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == ADDV_F32) return launch<float>(q, k, v, out, b, t_len, nh, st);
  if (dtype == ADDV_BF16) return launch<__nv_bfloat16>(q, k, v, out, b, t_len, nh, st);
  return cudaErrorInvalidValue;
}

// Kernel A: fused multi-head attention on head-padded activations.
//
// Replaces xai_audio_deepfakes_tpu/ops/attention.py::_make_attention_call
// (the Pallas kernel behind attention_pallas / attention).
//
// Computes, per (batch, head): s = q k^T in f32 over the T valid keys,
// p = exp(s - rowmax), ctx = (p cast to the compute dtype) . v with f32
// accumulation, and only then ctx / rowsum(p) with the f32 p, cast to the
// compute dtype. That is the Pallas kernel's order of operations, not
// attention_reference's (which normalises p before the pv product), and not
// FlashAttention's (whose online rescaling rounds p against a running max).
// q, k, v, out: [B, T, NH * 128] row-major, q pre-scaled by hd^-0.5, head dim
// zero-padded to 128 by the port's HeadDense (pad lanes are exact zeros).
//
// What bounds it on the H100: at the main path's shape (3B = 24, T = 249,
// 16 heads) a layer moves ~98 MB of bf16 and does ~12 GFLOP: 125 FLOP per
// byte, under the card's ~295 for bf16, so on the tensor cores it is bound
// by memory (~29 us).
//
// Two bodies behind one launcher:
//  * bf16 (the main path): tensor cores, mma.sync m16n8k16 with f32 sums
//    from ldmatrix fragments, K and V streamed through a cp.async ring; the
//    whole score row in registers for T <= 256, two passes over the keys
//    beyond (see attention_bf16_kernel).
//  * f32 (EmbedderConfig's default dtype and the tiny checks): full-f32 FMAs
//    on the CUDA cores, no TF32. One block per (32-query-row tile, head,
//    batch); the whole [32 x T] score tile sits in shared memory (32 x 249
//    f32 = 32 KB), so T is bounded by shared memory
//    (addv_attention_max_t). Keys and values are staged 64 rows at a time
//    as f32 with a padded row stride (129) so that a warp walking 32 keys
//    hits 32 banks. Rows >= T are never loaded or written.
#include <math.h>
#include <stdint.h>

#include "mma.cuh"

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

__global__ void __launch_bounds__(THREADS)
    attention_f32_kernel(const float* __restrict__ q, const float* __restrict__ k,
                         const float* __restrict__ v, float* __restrict__ out, int t_len, int nh) {
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
    qs[r * LD + d] = r < rows ? q[base + (row0 + r) * stride_t + d] : 0.f;
  }

  // scores, f32
  for (int j0 = 0; j0 < t_len; j0 += KCHUNK) {
    const int kn = min(KCHUNK, t_len - j0);
    __syncthreads();
    for (int i = tid; i < kn * HDP; i += THREADS) {
      const int j = i / HDP, d = i % HDP;
      kv[j * LD + d] = k[base + (j0 + j) * stride_t + d];
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

  // softmax numerator: one warp per row; p and its row sum in f32
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
      sr[j] = p;
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
      kv[j * LD + d] = v[base + (j0 + j) * stride_t + d];
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
    if (r < rows) out[base + (row0 + r) * stride_t + d] = acc[n] / row_sum[r];
  }
}

int launch_f32(const void* q, const void* k, const void* v, void* out, int b, int t_len, int nh,
               cudaStream_t stream) {
  const size_t smem = smem_bytes(t_len);
  cudaError_t err = allow_smem(attention_f32_kernel, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((t_len + ROWS - 1) / ROWS, nh, b);
  attention_f32_kernel<<<grid, THREADS, smem, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k), static_cast<const float*>(v),
      static_cast<float*>(out), t_len, nh);
  return cudaGetLastError();
}

// ---------------------------------------------------------------------------
// bf16 body on the tensor cores.
//
// One block per (64 query rows, head, batch), 4 warps of 16 query rows. The
// warp's Q rows live in registers as mma A fragments for the whole kernel.
// K and V stream through a ring of STAGES shared-memory tiles of 64 keys,
// filled by 16-byte cp.async copies issued STAGES - 1 tiles ahead, with one
// barrier per tile. Keys at or past T are zero-filled (cp.async with
// src-size 0: 0 * NaN would be NaN) and their scores set to -inf, so the T
// axis pads to a multiple of 64 and the p.v product has whole k-steps.
//
// The row max has to be known before any p is rounded to bf16 (the TPU's
// cast point), so every score is taken before the first p. Two schedules:
//  * resident (NCH = 4, T <= 256, the main path's 249): K_0 .. K_3 give the
//    whole 16 x 256 f32 score row of each warp in registers (128 a thread)
//    and the row max; then V_0 .. V_3 each take p = exp(s - m) in f32, add p
//    to the row sum, round p to bf16 and run ctx += p . v. K and V are read
//    once.
//  * streamed (NCH = 0, any T): pass 1 walks K_0 .. K_{n-1} for the row max
//    only; pass 2 walks K_0, V_0, K_1, V_1, ..., recomputing each score chunk
//    (bit-identical) before its p. One score chunk in registers, no limit on
//    T; q k^T is computed twice.
// The rounded p is packed straight into A fragments: an m16n8 C fragment has
// the layout of the m16n8k16 A operand, so p never goes back to shared
// memory. Registers: 32 for the Q fragments, 64 for the 16 x 128 f32
// context, 128 (resident) or 32 (streamed) for scores; ptxas reports no
// spill. Shared memory rows are 128 + 8 bf16 (272 bytes), so the 8 row
// addresses of an ldmatrix land in 8 distinct 16-byte bank groups.
namespace tc {

constexpr int ROWS = 64;      // query rows per block
constexpr int WARPS = 4;      // 16 query rows each
constexpr int THREADS = 32 * WARPS;
constexpr int KC = 64;        // keys per streamed tile
constexpr int LDS = HDP + 8;  // shared-memory row stride, bf16 elements
constexpr int TILE = KC * LDS;
constexpr int STAGES = 4;     // ring depth
constexpr int RESIDENT = 4;   // key tiles the resident schedule holds
constexpr float LOG2E = 1.4426950408889634f;
// the ring, then the Q tile: two blocks an SM, as the registers allow
constexpr size_t SMEM = sizeof(__nv_bfloat16) * (STAGES + 1) * TILE;

// column of an mma fragment)
__device__ __forceinline__ unsigned pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<unsigned*>(&v);
}

// Copy rows row0 .. row0 + 63 of one head ([T, stride_t], 128 wide) into a
// [64][LDS] tile; rows at or past T become zeros.
__device__ __forceinline__ void load_tile(__nv_bfloat16* dst, const __nv_bfloat16* src, int row0,
                                          int t_len, long long stride_t) {
  constexpr int PIECES = HDP / 8;  // 16-byte pieces per row
  for (int i = threadIdx.x; i < KC * PIECES; i += THREADS) {
    const int r = i / PIECES, c = (i % PIECES) * 8;
    const bool valid = row0 + r < t_len;
    cp_async16(dst + r * LDS + c, valid ? src + (row0 + r) * stride_t + c : src, valid);
  }
}

// s[j] (keys 8j .. 8j + 7 of the chunk) = this warp's 16 query rows . k^T
__device__ __forceinline__ void chunk_scores(float (&s)[8][4], const unsigned (&qf)[8][4],
                                             const __nv_bfloat16* ks, int lane) {
#pragma unroll
  for (int j = 0; j < 8; ++j) s[j][0] = s[j][1] = s[j][2] = s[j][3] = 0.f;
#pragma unroll
  for (int kk = 0; kk < HDP / 16; ++kk) {
#pragma unroll
    for (int jp = 0; jp < 4; ++jp) {
      // four 8x8 matrices: keys 16jp + {0..7, 0..7, 8..15, 8..15} at dims
      // 16kk + {0, 8, 0, 8}: the B fragments of key tiles 2jp and 2jp + 1
      unsigned b[4];
      ldmatrix_x4(b, ks + (16 * jp + (lane % 8) + (lane / 16) * 8) * LDS + 16 * kk +
                         ((lane / 8) % 2) * 8);
      mma_bf16(s[2 * jp], qf[kk], b[0], b[1]);
      mma_bf16(s[2 * jp + 1], qf[kk], b[2], b[3]);
    }
  }
}

template <int NCH>
__global__ void __launch_bounds__(THREADS, 2)
    attention_bf16_kernel(const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
                          const __nv_bfloat16* __restrict__ v, __nv_bfloat16* __restrict__ out,
                          int t_len, int nh) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __nv_bfloat16* ring = reinterpret_cast<__nv_bfloat16*>(smem_raw);  // [STAGES][KC][LDS]
  __nv_bfloat16* qs = ring + STAGES * TILE;                           // [ROWS][LDS]

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, tq = lane % 4;  // fragment row group and column pair
  const int row0 = blockIdx.x * ROWS;
  const long long stride_t = static_cast<long long>(nh) * HDP;
  const long long base =
      static_cast<long long>(blockIdx.z) * t_len * stride_t + static_cast<long long>(blockIdx.y) * HDP;
  const int chunks = NCH ? NCH : (t_len + KC - 1) / KC;
  const int items = NCH ? 2 * NCH : 3 * chunks;
  // the schedules above: which tile item i is, and whether it is a V tile
  auto is_v = [&](int item) { return item >= chunks && (NCH || (item - chunks) % 2 == 1); };
  auto chunk_of = [&](int item) {
    return item < chunks ? item : NCH ? item - chunks : (item - chunks) / 2;
  };
  auto issue = [&](int item) {
    if (item < items)
      load_tile(ring + (item % STAGES) * TILE, (is_v(item) ? v : k) + base, chunk_of(item) * KC,
                t_len, stride_t);
    cp_async_commit();  // an empty group past the end keeps the count uniform
  };
  load_tile(qs, q + base, row0, t_len, stride_t);
#pragma unroll
  for (int i = 0; i < STAGES - 1; ++i) issue(i);

  unsigned qf[HDP / 16][4];             // Q A fragments, one per 16 dims
  float s[(NCH ? NCH : 1) * 8][4];      // scores, keys 8j .. 8j + 7 of their tile
  float m[2] = {-INFINITY, -INFINITY};  // row max of rows g and g + 8
  float l[2] = {0.f, 0.f};              // row sum of the f32 p
  float acc[HDP / 8][4];                // ctx, dims 8j .. 8j + 7

#pragma unroll
  for (int item = 0; item < items; ++item) {
    cp_async_wait<STAGES - 2>();  // this item's tile (and the Q tile) has landed
    __syncthreads();              // ... for every thread, and item - 1's stage is free
    issue(item + STAGES - 1);
    const __nv_bfloat16* tile = ring + (item % STAGES) * TILE;
    if (item == 0) {
#pragma unroll
      for (int kk = 0; kk < HDP / 16; ++kk)
        ldmatrix_x4(qf[kk], qs + (warp * 16 + lane % 16) * LDS + 16 * kk + (lane / 16) * 8);
    }
    const int c = chunk_of(item);
    float(&sc)[8][4] = *reinterpret_cast<float(*)[8][4]>(&s[NCH ? c * 8 : 0]);

    if (!is_v(item)) {  // scores of key tile c
      chunk_scores(sc, qf, tile, lane);
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int key = c * KC + 8 * j + 2 * tq;
        if (key >= t_len) sc[j][0] = sc[j][2] = -INFINITY;
        if (key + 1 >= t_len) sc[j][1] = sc[j][3] = -INFINITY;
      }
      if (item < chunks) {  // every score is seen once here: the row max
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          m[0] = fmaxf(m[0], fmaxf(sc[j][0], sc[j][1]));
          m[1] = fmaxf(m[1], fmaxf(sc[j][2], sc[j][3]));
        }
        if (item == chunks - 1) {
          m[0] = quad_max(m[0]);
          m[1] = quad_max(m[1]);
#pragma unroll
          for (int j = 0; j < HDP / 8; ++j) acc[j][0] = acc[j][1] = acc[j][2] = acc[j][3] = 0.f;
        }
      }
    } else {  // p of key tile c in f32, its row sum, p in bf16 through p . v
      // exp(s - m) as 2^(s log2 e - m log2 e): one FMA and one MUFU.EX2,
      // within a few f32 ulp of expf
      const float ml[2] = {m[0] * LOG2E, m[1] * LOG2E};
#pragma unroll
      for (int j = 0; j < 8; ++j) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          sc[j][e] = exp2f(fmaf(sc[j][e], LOG2E, -ml[e / 2]));
          l[e / 2] += sc[j][e];
        }
      }
#pragma unroll
      for (int kk = 0; kk < KC / 16; ++kk) {  // keys 16kk .. 16kk + 15
        const unsigned a[4] = {pack_bf16(sc[2 * kk][0], sc[2 * kk][1]),
                               pack_bf16(sc[2 * kk][2], sc[2 * kk][3]),
                               pack_bf16(sc[2 * kk + 1][0], sc[2 * kk + 1][1]),
                               pack_bf16(sc[2 * kk + 1][2], sc[2 * kk + 1][3])};
#pragma unroll
        for (int jp = 0; jp < HDP / 16; ++jp) {
          // transposed 8x8 matrices: keys 16kk + {0..7, 8..15, 0..7, 8..15}
          // at dims 16jp + {0, 0, 8, 8}: B fragments of dim tiles 2jp, 2jp + 1
          unsigned b[4];
          ldmatrix_x4_trans(b, tile + (16 * kk + (lane % 8) + ((lane / 8) % 2) * 8) * LDS +
                                   16 * jp + (lane / 16) * 8);
          mma_bf16(acc[2 * jp], a, b[0], b[1]);
          mma_bf16(acc[2 * jp + 1], a, b[2], b[3]);
        }
      }
    }
  }

  // ctx / rowsum, rounded to bf16 once, staged in this warp's own Q rows
  // (only this warp read them) and written as 16-byte rows
  l[0] = quad_sum(l[0]);
  l[1] = quad_sum(l[1]);
  __nv_bfloat16* stage = qs + warp * 16 * LDS;
#pragma unroll
  for (int j = 0; j < HDP / 8; ++j) {
    const int d = 8 * j + 2 * tq;
    *reinterpret_cast<unsigned*>(stage + g * LDS + d) = pack_bf16(acc[j][0] / l[0], acc[j][1] / l[0]);
    *reinterpret_cast<unsigned*>(stage + (g + 8) * LDS + d) =
        pack_bf16(acc[j][2] / l[1], acc[j][3] / l[1]);
  }
  __syncwarp();
  constexpr int PIECES = HDP / 8;
  for (int i = lane; i < 16 * PIECES; i += 32) {
    const int r = i / PIECES, col = (i % PIECES) * 8;
    const int row = row0 + warp * 16 + r;
    if (row < t_len)
      *reinterpret_cast<uint4*>(out + base + row * stride_t + col) =
          *reinterpret_cast<const uint4*>(stage + r * LDS + col);
  }
}

template <int NCH>
int launch_body(const void* q, const void* k, const void* v, void* out, int b, int t_len, int nh,
                cudaStream_t stream) {
  cudaError_t err = allow_smem(attention_bf16_kernel<NCH>, SMEM);
  if (err != cudaSuccess) return err;
  const dim3 grid((t_len + ROWS - 1) / ROWS, nh, b);
  attention_bf16_kernel<NCH><<<grid, THREADS, SMEM, stream>>>(
      static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v), static_cast<__nv_bfloat16*>(out), t_len, nh);
  return cudaGetLastError();
}

int launch_bf16(const void* q, const void* k, const void* v, void* out, int b, int t_len, int nh,
                cudaStream_t stream) {
  // cp.async and the output's 16-byte stores need 16-byte aligned rows
  if ((reinterpret_cast<uintptr_t>(q) | reinterpret_cast<uintptr_t>(k) |
       reinterpret_cast<uintptr_t>(v) | reinterpret_cast<uintptr_t>(out)) % 16 != 0)
    return cudaErrorMisalignedAddress;
  if (t_len <= RESIDENT * KC) return launch_body<RESIDENT>(q, k, v, out, b, t_len, nh, stream);
  return launch_body<0>(q, k, v, out, b, t_len, nh, stream);
}

}  // namespace tc

}  // namespace

// Largest T the f32 body's score tile fits for (the wrapper checks it before
// launching that body; the bf16 body streams the keys and has no limit).
ADDV_EXPORT int addv_attention_max_t() {
  int t = 1;
  while (smem_bytes(t + 1) <= 227 * 1024) ++t;
  return t;
}

ADDV_EXPORT int addv_attention(const void* q, const void* k, const void* v, void* out, int b,
                               int t_len, int nh, int hdp, int dtype, void* stream) {
  if (hdp != HDP || t_len < 1 || b < 1 || nh < 1) return cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == ADDV_F32) {
    if (t_len > addv_attention_max_t()) return cudaErrorInvalidValue;
    return launch_f32(q, k, v, out, b, t_len, nh, st);
  }
  if (dtype == ADDV_BF16) return tc::launch_bf16(q, k, v, out, b, t_len, nh, st);
  return cudaErrorInvalidValue;
}

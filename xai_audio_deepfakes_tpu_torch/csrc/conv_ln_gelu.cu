// Kernel E: stride-2 conv1d + channel LayerNorm + GELU, the conv frontend's
// layers 1-6 in one pass.
//
// Replaces xai_audio_deepfakes_tpu/ops/pallas_conv.py::_conv_ln_gelu_pallas
// (body _kernel_body, the Pallas kernel behind conv_ln_gelu).
//
// Per (batch, output frame t) over all Cout channels:
//   c[co]  = sum_{tap < k, ci < Cin} w[co, ci, tap] * x[ci, 2 t + tap]   (f32 sum)
//   a[co]  = float(round_to_T(c[co])) + conv_bias[co]                    (f32)
//   mu, var = mean and centred variance of a over co                     (f32)
//   n[co]  = round_to_T((a[co] - mu) * rsqrt(var + eps) * scale[co] + bias[co])
//   y[co]  = round_to_T(gelu_f32(float(n[co])))
// These are the cast points of the Pallas body (the conv sum is rounded to the
// compute dtype before the bias is added in f32). With T = float every
// product is a full f32 FMA; nothing goes through TF32.
//
// The TPU kernel's one-hot select matmul, its full-phase taps, its halo block
// and its masking of rows past L are Mosaic work-arounds and are not here:
// the conv is one product with M = B * Lout frames, N = Cout and
// K = k * Cin, and the input is read at stride 2 straight from x.
//
// Layout: x [B, Cin, L] and y [B, Cout, Lout], as F.conv1d takes and gives
// them, so the frontend never transposes. The wrapper rearranges torch's
// [Cout, Cin, k] weight once per call (1.5 MB in bf16): to [k, Cin, Cout]
// for the f32 body, to the bf16 body's stage image for bf16.
//
// What bounds it on the H100: the operations. At the main path's shape
// (batch 24, 512 -> 512, six layers) it is 585 GFLOP against 1.2 GB moved,
// so the tensor cores' 0.59 ms is the bound. What the card pays on top is
// the weights: a block needs all k x 512 x 512 of them for its frames, so
// the weight bytes read from L2 are (blocks) x 1.57 MB at k 3 (1.05 MB at
// k 2).
//
// Two bodies compute the product:
//  - bf16 (the main path, conv_ln_gelu_bf16_kernel below): wgmma on the
//    tensor cores, both operands from a 3- to 5-deep ring of shared-memory
//    stages that a producer warpgroup fills (weights by bulk copy, im2col
//    samples from cp.async rows) on mbarriers; 64 frames x all 512 channels
//    a block, the accumulators (128 a thread) in registers, the LayerNorm
//    taken from them. At batch 24 that is 5952 blocks over layers 1-6, so
//    by the tiling's arithmetic (blocks x k x 512 x 512 x 2 bytes; no
//    profiler counter read it) 9.2 GB of weights from L2 (4.72, 2.38, 1.21,
//    0.60, 0.20, 0.10 GB by layer). Sharing each weight stage across a
//    2-block cluster by multicast halves that, and measured slower on the
//    H100 (PERF.md): the L2 weight stream is not what sets the pace.
//  - f32: full-f32 FMAs on the CUDA cores (tensor cores would mean TF32).
//    A block owns 32 output frames and all Cout channels and walks the
//    input channels 8 at a time, staging the chunk's k * Cout weights and
//    its 2 * 32 + k - 2 samples; a thread keeps 8 frames x (Cout / 64)
//    channels of sums in registers, and a warp's threads own 32
//    neighbouring channels of the same 8 frames, so weight reads are
//    conflict-free and sample reads are broadcasts. After the product the
//    [Cout x 32] f32 tile goes over the staging area and runs kernel D's
//    statistics and epilogue from shared memory. Bound by the f32 FMA rate.
#include <math.h>

#include <type_traits>

#include "mma.cuh"

namespace {

constexpr int TF = 32;        // output frames per block
constexpr int MAX_C = 512;    // largest Cout
constexpr int THREADS = 256;
constexpr int GROUPS = THREADS / TF;  // channel groups of the epilogue

// f32 body
constexpr int FR = 8;            // frames per thread
constexpr int CG = 64;           // a thread owns channels tc + CG * j
constexpr int NJ = MAX_C / CG;   // channel slots per thread
constexpr int KC_F32 = 8;        // input channels staged at once
constexpr int LDT_F32 = TF + 1;  // row stride of the output tile (conflict-free writes)
static_assert(THREADS == (TF / FR) * CG, "f32 body: one thread per (frame group, channel lane)");

__host__ __device__ constexpr int x_cols(int k) { return 2 * TF + k - 2; }  // samples a tile of TF frames reads

// The epilogue's reductions ([GROUPS][TF] partial sums, [2][TF] statistics)
// sit behind the region that staging and the output tile share.
constexpr int EPILOGUE_FLOATS = GROUPS * TF + 2 * TF;

size_t shared_region_bytes(size_t staging_bytes, int cout, int ldt) {
  const size_t tile = sizeof(float) * cout * ldt;
  const size_t region = staging_bytes > tile ? staging_bytes : tile;
  return (region + 127) / 128 * 128;
}

size_t staging_bytes_f32(int k, int cout) {
  return sizeof(float) * (static_cast<size_t>(KC_F32) * k * cout + KC_F32 * x_cols(k));
}

// Channel LayerNorm + GELU over the block's tile, as kernel D does it.
// tile[ch * ldt + col] holds the f32 conv sum of channel ch at frame t0 + col;
// this rounds it to T, adds the conv bias in f32, takes the statistics over
// the channels and writes y. Every (ch, col) is touched by one thread only.
template <typename T>
__device__ void ln_gelu_tile(float* tile, int ldt, float* red, float* stat,
                             const float* __restrict__ conv_bias, const float* __restrict__ scale,
                             const float* __restrict__ bias, T* __restrict__ yb, int cout,
                             int lout, int t0, float eps, int tanh_form) {
  const int col = threadIdx.x % TF;
  const int grp = threadIdx.x / TF;
  float s = 0.f;
  for (int ch = grp; ch < cout; ch += GROUPS) {
    const float a = to_f32(from_f32<T>(tile[ch * ldt + col])) + conv_bias[ch];
    tile[ch * ldt + col] = a;
    s += a;
  }
  red[grp * TF + col] = s;
  __syncthreads();
  if (grp == 0) {
    float t = 0.f;
#pragma unroll
    for (int g = 0; g < GROUPS; ++g) t += red[g * TF + col];
    stat[col] = t / cout;
  }
  __syncthreads();
  const float mu = stat[col];
  s = 0.f;
  for (int ch = grp; ch < cout; ch += GROUPS) {
    const float d = tile[ch * ldt + col] - mu;
    s += d * d;
  }
  red[grp * TF + col] = s;
  __syncthreads();
  if (grp == 0) {
    float t = 0.f;
#pragma unroll
    for (int g = 0; g < GROUPS; ++g) t += red[g * TF + col];
    stat[TF + col] = rsqrtf(t / cout + eps);
  }
  __syncthreads();
  const float rs = stat[TF + col];
  const int li = t0 + col;
  if (li >= lout) return;
  for (int ch = grp; ch < cout; ch += GROUPS)
    yb[static_cast<long long>(ch) * lout + li] =
        ln_gelu_value<T>(tile[ch * ldt + col], mu, rs, scale[ch], bias[ch], tanh_form);
}

template <int K>
__global__ void __launch_bounds__(THREADS, 2)
    conv_ln_gelu_f32_kernel(const float* __restrict__ x, const float* __restrict__ w,
                            const float* __restrict__ conv_bias, const float* __restrict__ scale,
                            const float* __restrict__ bias, float* __restrict__ y, int cin,
                            int cout, int l, int lout, float eps, int tanh_form,
                            int region_floats) {
  constexpr int KC = KC_F32;
  constexpr int XC = x_cols(K);
  constexpr int XV = 2 * FR + K - 2;  // samples a thread's FR frames read
  extern __shared__ __align__(128) unsigned char smem_raw[];
  float* smem = reinterpret_cast<float*>(smem_raw);
  float* ws = smem;                  // [KC][K][cout]
  float* xs = smem + KC * K * cout;  // [KC][XC]
  float* tile = smem;                // [cout][LDT_F32], after the product
  float* red = smem + region_floats;
  float* stat = red + GROUPS * TF;

  const int tid = threadIdx.x;
  const int tc = tid % CG;
  const int tf = tid / CG;
  const int t0 = blockIdx.x * TF;
  const int nj = cout / CG;
  const float* xb = x + static_cast<long long>(blockIdx.y) * cin * l;

  float acc[NJ][FR];
#pragma unroll
  for (int j = 0; j < NJ; ++j)
#pragma unroll
    for (int f = 0; f < FR; ++f) acc[j][f] = 0.f;

  for (int c0 = 0; c0 < cin; c0 += KC) {
    __syncthreads();
#pragma unroll
    for (int r = 0; r < KC * K; ++r) {
      const int ci = r / K, tap = r % K;
      const float* src = w + (static_cast<long long>(tap) * cin + c0 + ci) * cout;
      for (int co = tid; co < cout; co += THREADS) ws[r * cout + co] = src[co];
    }
    for (int i = tid; i < KC * XC; i += THREADS) {
      const int ci = i / XC, p = i % XC;
      const int pos = 2 * t0 + p;
      xs[i] = pos < l ? xb[static_cast<long long>(c0 + ci) * l + pos] : 0.f;
    }
    __syncthreads();
#pragma unroll
    for (int ci = 0; ci < KC; ++ci) {
      float xv[XV];
      const float* xr = xs + ci * XC + 2 * FR * tf;
#pragma unroll
      for (int i = 0; i < XV; ++i) xv[i] = xr[i];
#pragma unroll
      for (int tap = 0; tap < K; ++tap) {
        const float* wr = ws + (ci * K + tap) * cout + tc;
#pragma unroll
        for (int j = 0; j < NJ; ++j) {
          if (j < nj) {
            const float wv = wr[j * CG];
#pragma unroll
            for (int f = 0; f < FR; ++f) acc[j][f] = fmaf(wv, xv[2 * f + tap], acc[j][f]);
          }
        }
      }
    }
  }
  __syncthreads();
#pragma unroll
  for (int j = 0; j < NJ; ++j) {
    if (j < nj) {
#pragma unroll
      for (int f = 0; f < FR; ++f) tile[(tc + j * CG) * LDT_F32 + tf * FR + f] = acc[j][f];
    }
  }
  __syncthreads();
  ln_gelu_tile<float>(tile, LDT_F32, red, stat, conv_bias, scale, bias,
                      y + static_cast<long long>(blockIdx.y) * cout * lout, cout, lout, t0, eps,
                      tanh_form);
}

// ---------------------------------------------------------------------------
// bf16 body: a pipelined wgmma conv with the LayerNorm in the epilogue.
//
// As a product per tap: D[t, co] += X_tap[t, ci] W_tap[co, ci], with
// X_tap[t, ci] = x[ci, 2 (t0 + t) + tap]. Block: TFW = 64 output frames x
// all Cout channels (the LayerNorm's reduction stays in the block): two
// consumer warpgroups, each the 64 frames x Cout / 2 channels of one
// wgmma.m64nNk16 per tap (N = 256 at Cout 512, 128 f32 accumulators a
// thread; 168 registers, no spill), and a producer warpgroup. The product
// walks the input channels KCW = 16 at a time through a ring of STAGES
// shared-memory stages (3 at k 3, 5 at k 2). wgmma reads both operands of
// a stage from shared memory as K-major core matrices (8 rows x 16 bytes):
//   W: [tap][co / 8][2][8][8], the chunk's k x Cout x 16 weights, one bulk
//      copy of the wrapper's pre-arranged image (`weight_image` in
//      ops/cuda_conv.py); 128 bytes between the two 8-channel halves, 256
//      between groups of 8 channels;
//   X: two planes, the even samples x[ci, 2 (t0 + t)] and the odd ones
//      x[ci, 2 (t0 + t) + 1], each [2 halves][72 frames][8 channels] with
//      frames 16 bytes apart, so that X_tap is plane tap % 2 read from
//      frame tap / 2 on: tap 2 is tap 0's descriptor 16 bytes later, and
//      the planes hold 2 x 16 x 64 samples however many taps there are.
// The stride-2 read is why X is not a bulk copy, and rows of odd length
// are why it is not a TMA tensor copy (global strides must be multiples of
// 16 bytes). The producer warpgroup copies each chunk's 16 raw sample rows
// with 16-byte cp.async into a RAW_STAGES-deep ring of its own,
// RAW_STAGES - 1 chunks ahead, and splits them into the planes from shared
// memory, so no load latency sits on its path. Per stage it waits for the
// slot's `empty` barrier, one thread posts the weight bytes on `full` and
// starts the bulk copy, and each producer warp arrives on `full` once its
// plane stores are fenced for the async proxy (4 arrivals + the copy's
// bytes). A consumer warpgroup waits on `full`, issues one wgmma per tap,
// commits, and once the previous chunk's group has completed
// (wgmma.wait_group 1) one lane per warp arrives on that chunk's `empty`.
// Nothing else synchronises the block in the main loop.
//
// Epilogue: the consumers round the sums to bf16, add the conv bias, take
// per-frame sums over their channels (a quad shuffle, then the two
// warpgroups' partial sums through shared memory), the mean, the same for
// the centred variance, and write the rounded normalised values into a
// padded [Cout][72] tile over the now idle ring; then all 12 warps take the
// GELU (its form a template constant, so no branch splits the unrolled
// loop) and write each channel's 64 frames to device memory together.
constexpr int TFW = 64;        // frames per block
constexpr int KCW = 16;        // input channels per stage
constexpr int CWARPS = 8;      // consumer warps: two warpgroups
constexpr int PWARPS = 4;      // producer warps: one warpgroup
constexpr int BF16_THREADS = 32 * (CWARPS + PWARPS);
constexpr int OUT_LD = TFW + 8;  // bf16 row stride of the output tile
constexpr int PRODUCER_ARRIVALS = PWARPS + 1;  // one a producer warp + the copy's
constexpr int RAW_STAGES = 4;  // raw sample rows in flight: chunks c .. c + 3
constexpr int RAW_LD = 144;    // a raw row: 2 * TFW + k - 2 samples from a 16-byte boundary
constexpr int RAW_CHUNKS = RAW_LD / 8;

template <int K>
__host__ __device__ constexpr int bf16_stages() { return K == 3 ? 3 : 5; }

__host__ __device__ inline int w_stage_bytes(int k, int cout) { return k * cout * KCW * 2; }
constexpr int PLANE_ROWS = TFW + 8;                  // frames 0 .. 64 of a plane, in 8-row groups
constexpr int PLANE_HALF = PLANE_ROWS * 8 * 2;        // bytes of one 8-channel half of a plane
constexpr int X_STAGE_BYTES = 2 * 2 * PLANE_HALF;     // the even and the odd plane
__host__ __device__ inline int x_stage_bytes(int) { return X_STAGE_BYTES; }
constexpr int RAW_BYTES = RAW_STAGES * KCW * RAW_LD * 2;

size_t bf16_smem_bytes(int k, int cout) {
  const int stages = k == 3 ? bf16_stages<3>() : bf16_stages<2>();
  return static_cast<size_t>(stages) * (w_stage_bytes(k, cout) + x_stage_bytes(k)) + RAW_BYTES +
         sizeof(float) * 4 * TFW;
}

// barrier of the 256 consumer threads (the producers do not take part)
__device__ __forceinline__ void consumers_sync() { asm volatile("bar.sync 1, 256;\n" ::: "memory"); }
// barrier of the 128 producer threads
__device__ __forceinline__ void producers_sync() { asm volatile("bar.sync 2, 128;\n" ::: "memory"); }

// The producer warpgroup: raw rows by cp.async, im2col planes, weights by
// bulk copy.
template <int K>
__device__ __forceinline__ void produce(unsigned char* smem_raw, uint64_t* full, uint64_t* empty,
                                        int w_bytes, int stage_bytes,
                                        const __nv_bfloat16* __restrict__ x,
                                        const __nv_bfloat16* __restrict__ w_img, int cin, int cout,
                                        int l, int t0) {
  using bf16 = __nv_bfloat16;
  constexpr int STAGES = bf16_stages<K>();
  const int pt = threadIdx.x - 32 * CWARPS;  // 0 .. 127
  const int chunks = cin / KCW;
  const long long total = static_cast<long long>(gridDim.y) * cin * l;  // elements of x
  const long long row0 = static_cast<long long>(blockIdx.y) * cin;
  bf16* raw = reinterpret_cast<bf16*>(smem_raw + STAGES * stage_bytes);  // [RAW_STAGES][KCW][RAW_LD]

  // raw row ci of chunk cc: samples 2 t0 .. 2 t0 + 2 TFW + K - 3 of x's row,
  // copied from the 16-byte boundary at or below the first; a piece past
  // the end of x is zero-filled
  auto issue = [&](int cc) {
    bf16* dst = raw + (cc % RAW_STAGES) * KCW * RAW_LD;
    const long long first = (row0 + cc * KCW) * l + 2 * t0;
    for (int i = pt; i < KCW * RAW_CHUNKS; i += 32 * PWARPS) {
      const int ci = i / RAW_CHUNKS, j = i % RAW_CHUNKS;
      const long long start = (first + static_cast<long long>(ci) * l) / 8 * 8 + 8 * j;
      const long long left = total - start;
      const int bytes = left >= 8 ? 16 : left > 0 ? static_cast<int>(left) * 2 : 0;
      cp_async16_bytes(dst + ci * RAW_LD + 8 * j, bytes > 0 ? x + start : x, bytes);
    }
  };
  for (int cc = 0; cc < RAW_STAGES - 1; ++cc) {
    if (cc < chunks) issue(cc);
    cp_async_commit();
  }
  // this thread's plane entries: frames t = 8 tb + r (tb = 2 pw, 2 pw + 1),
  // input channel pairs 8 h + 2 pp, + 1
  const int pw = pt / 32, r = (pt % 32) >> 2, pp = pt & 3;
  for (int c = 0; c < chunks; ++c) {
    cp_async_wait<RAW_STAGES - 2>();  // chunk c's rows have landed (this thread's copies)
    producers_sync();  // ... every thread's, and every thread is done with chunk c - 1's slot
    if (c + RAW_STAGES - 1 < chunks) issue(c + RAW_STAGES - 1);
    cp_async_commit();  // an empty group past the end keeps the count uniform
    const int s = c % STAGES;
    if (c >= STAGES) mbar_wait(&empty[s], ((c / STAGES) - 1) & 1);
    unsigned char* st = smem_raw + s * stage_bytes;
    if (pt == 0) {
      mbar_arrive_expect_tx(&full[s], w_bytes);
      bulk_copy_to_shared(st, w_img + static_cast<long long>(c) * (w_bytes / 2), w_bytes, &full[s]);
    }
    const unsigned short* rc =
        reinterpret_cast<const unsigned short*>(raw + (c % RAW_STAGES) * KCW * RAW_LD);
    unsigned* xs = reinterpret_cast<unsigned*>(st + w_bytes);
    const long long first = (row0 + c * KCW) * l + 2 * t0;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int ci = 8 * h + 2 * pp;
      const unsigned short* r_lo = rc + ci * RAW_LD + ((first + static_cast<long long>(ci) * l) & 7);
      const unsigned short* r_hi =
          rc + (ci + 1) * RAW_LD + ((first + static_cast<long long>(ci + 1) * l) & 7);
      // even plane frames 16 pw .. 16 pw + 15 (and 64 .. 71 by the last
      // warp, for tap 2 at k 3), odd plane frames 16 pw .. 16 pw + 15
#pragma unroll
      for (int item = 0; item < 5; ++item) {
        const int plane = item < 2 || item == 4 ? 0 : 1;
        const int tb = item == 4 ? 8 : 2 * pw + (item & 1);
        if (item == 4 && (K != 3 || pw != PWARPS - 1)) continue;
        const int t = 8 * tb + r;
        const bool in = t <= TFW && 2 * (t0 + t) + plane < l;
        const unsigned lo = in ? r_lo[2 * t + plane] : 0u, hi = in ? r_hi[2 * t + plane] : 0u;
        xs[(plane * 2 * PLANE_HALF + h * PLANE_HALF + t * 16 + pp * 4) / 4] = lo | (hi << 16);
      }
    }
    fence_proxy_async();  // the plane stores, visible to wgmma
    __syncwarp();         // ... the whole warp's, before its one arrival
    if (pt % 32 == 0) mbar_arrive(&full[s]);
  }
}

// The consumer warpgroups' main loop and epilogue; NW = Cout / 2.
template <int K, int NW>
__device__ __forceinline__ void consume(unsigned char* smem_raw, uint64_t* full, uint64_t* empty,
                                        int w_bytes, int stage_bytes, float* red,
                                        const float* __restrict__ conv_bias,
                                        const float* __restrict__ scale,
                                        const float* __restrict__ bias, int cin, float eps) {
  using bf16 = __nv_bfloat16;
  constexpr int STAGES = bf16_stages<K>();
  constexpr int COUT = 2 * NW;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int wg = warp / 4, w4 = warp % 4;
  const int chunks = cin / KCW;
  float acc[NW / 2];  // the first product overwrites it

  for (int c = 0; c < chunks; ++c) {
    const int s = c % STAGES;
    mbar_wait(&full[s], (c / STAGES) & 1);
    const unsigned char* ws = smem_raw + s * stage_bytes;
    const unsigned char* xs = ws + w_bytes;
    wgmma_fence();
#pragma unroll
    for (int tap = 0; tap < K; ++tap)  // tap 2 is the even plane one frame on
      wgmma_ss<NW>(acc, smem_desc(xs + (tap & 1) * 2 * PLANE_HALF + (tap >> 1) * 16, PLANE_HALF, 128),
                   smem_desc(ws + (tap * COUT + wg * NW) * KCW * 2, 128, 256), c > 0 || tap > 0);
    wgmma_commit();
    wgmma_wait<1>();  // chunk c - 1's products are done: its stage is free
    if (c > 0) {
      __syncwarp();
      if (lane == 0) mbar_arrive(&empty[(c - 1) % STAGES]);
    }
  }
  wgmma_wait<0>();

  // ---- epilogue: frames 16 w4 + g + 8 r, channels wg NW + 8 j + 2 q + e
  const int g = lane >> 2, q = lane & 3;
  float part[2] = {0.f, 0.f};
#pragma unroll
  for (int j = 0; j < NW / 8; ++j)
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const float cb = conv_bias[wg * NW + 8 * j + 2 * q + e];
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        float& v = acc[4 * j + 2 * r + e];
        v = to_f32(from_f32<bf16>(v)) + cb;
        part[r] += v;
      }
    }
  float mean[2], rs[2];
  float* red_sum = red;            // [2 warpgroups][TFW]
  float* red_sq = red + 2 * TFW;   // [2 warpgroups][TFW]
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    part[r] = quad_sum(part[r]);
    if (q == 0) red_sum[wg * TFW + 16 * w4 + g + 8 * r] = part[r];
  }
  consumers_sync();
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int t = 16 * w4 + g + 8 * r;
    mean[r] = (red_sum[t] + red_sum[TFW + t]) / COUT;
    float sq = 0.f;
#pragma unroll
    for (int j = 0; j < NW / 8; ++j)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const float d = acc[4 * j + 2 * r + e] - mean[r];
        sq += d * d;
      }
    sq = quad_sum(sq);
    if (q == 0) red_sq[wg * TFW + t] = sq;
  }
  consumers_sync();
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int t = 16 * w4 + g + 8 * r;
    rs[r] = rsqrtf((red_sq[t] + red_sq[TFW + t]) / COUT + eps);
  }
  // the normalised values, rounded, into the tile over the ring (idle now:
  // every stage was consumed before the first barrier)
  bf16* out = reinterpret_cast<bf16*>(smem_raw);  // [COUT][OUT_LD]
#pragma unroll
  for (int j = 0; j < NW / 8; ++j)
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const int co = wg * NW + 8 * j + 2 * q + e;
      const float sc = scale[co], bi = bias[co];
#pragma unroll
      for (int r = 0; r < 2; ++r)
        out[co * OUT_LD + 16 * w4 + g + 8 * r] =
            from_f32<bf16>((acc[4 * j + 2 * r + e] - mean[r]) * rs[r] * sc + bi);
    }
}

// Every thread of the block: GELU of the tile's normalised values, each
// channel's frames written to device memory together.
template <int COUT, int TANH>
__device__ __forceinline__ void gelu_store(const __nv_bfloat16* out, __nv_bfloat16* __restrict__ y,
                                           int lout, int t0) {
  __nv_bfloat16* yb = y + static_cast<long long>(blockIdx.y) * COUT * lout;
  const int nt = min(TFW, lout - t0);
#pragma unroll 8
  for (int idx = threadIdx.x; idx < COUT * TFW; idx += BF16_THREADS) {
    const int co = idx / TFW, t = idx % TFW;
    if (t < nt)
      yb[static_cast<long long>(co) * lout + t0 + t] =
          from_f32<__nv_bfloat16>(gelu_f32(to_f32(out[co * OUT_LD + t]), TANH));
  }
}

template <int K, int NW>
__global__ void __launch_bounds__(BF16_THREADS, 1)
    conv_ln_gelu_bf16_kernel(const __nv_bfloat16* __restrict__ x,
                             const __nv_bfloat16* __restrict__ w_img,
                             const float* __restrict__ conv_bias,
                             const float* __restrict__ scale, const float* __restrict__ bias,
                             __nv_bfloat16* __restrict__ y, int cin, int l, int lout, float eps,
                             int tanh_form) {
  constexpr int STAGES = bf16_stages<K>();
  constexpr int COUT = 2 * NW;
  extern __shared__ __align__(128) unsigned char smem_raw[];
  __shared__ __align__(8) uint64_t full[STAGES], empty[STAGES];
  const int w_bytes = w_stage_bytes(K, COUT);
  const int stage_bytes = w_bytes + x_stage_bytes(K);
  float* red = reinterpret_cast<float*>(smem_raw + STAGES * stage_bytes + RAW_BYTES);
  const int t0 = blockIdx.x * TFW;

  if (threadIdx.x == 0) {
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(&full[s], PRODUCER_ARRIVALS);
      mbar_init(&empty[s], CWARPS);  // one a consumer warp
    }
    mbar_init_fence();
  }
  __syncthreads();

  if (threadIdx.x / 32 >= CWARPS)
    produce<K>(smem_raw, full, empty, w_bytes, stage_bytes, x, w_img, cin, COUT, l, t0);
  else
    consume<K, NW>(smem_raw, full, empty, w_bytes, stage_bytes, red, conv_bias, scale, bias,
                       cin, eps);
  __syncthreads();  // the tile is complete
  const __nv_bfloat16* out = reinterpret_cast<const __nv_bfloat16*>(smem_raw);
  if (tanh_form)  // the GELU form as a constant, so that no branch splits the unrolled loop
    gelu_store<COUT, 1>(out, y, lout, t0);
  else
    gelu_store<COUT, 0>(out, y, lout, t0);
}

template <typename Kernel>
int launch_f32(Kernel kernel, const void* x, const void* w, const void* conv_bias,
               const void* scale, const void* bias, void* y, int batch, int cin, int cout, int l,
               int k, float eps, int tanh_form, cudaStream_t stream) {
  const int lout = (l - k) / 2 + 1;
  const size_t region = shared_region_bytes(staging_bytes_f32(k, cout), cout, LDT_F32);
  const size_t smem = region + sizeof(float) * EPILOGUE_FLOATS;
  cudaError_t err = allow_smem(kernel, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((lout + TF - 1) / TF, batch);
  kernel<<<grid, THREADS, smem, stream>>>(
      static_cast<const float*>(x), static_cast<const float*>(w),
      static_cast<const float*>(conv_bias), static_cast<const float*>(scale),
      static_cast<const float*>(bias), static_cast<float*>(y), cin, cout, l, lout, eps, tanh_form,
      static_cast<int>(region / sizeof(float)));
  return cudaGetLastError();
}

template <int K, int NW>
int launch_bf16(const void* x, const void* w_img, const void* conv_bias, const void* scale,
                const void* bias, void* y, int batch, int cin, int l, float eps, int tanh_form,
                cudaStream_t stream) {
  auto kernel = conv_ln_gelu_bf16_kernel<K, NW>;
  const int lout = (l - K) / 2 + 1;
  const size_t smem = bf16_smem_bytes(K, 2 * NW);
  cudaError_t err = allow_smem(kernel, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((lout + TFW - 1) / TFW, batch);
  kernel<<<grid, BF16_THREADS, smem, stream>>>(
      static_cast<const __nv_bfloat16*>(x), static_cast<const __nv_bfloat16*>(w_img),
      static_cast<const float*>(conv_bias), static_cast<const float*>(scale),
      static_cast<const float*>(bias), static_cast<__nv_bfloat16*>(y), cin, l, lout, eps,
      tanh_form);
  return cudaGetLastError();
}

template <int K>
int launch_bf16_cout(const void* x, const void* w_img, const void* conv_bias, const void* scale,
                     const void* bias, void* y, int batch, int cin, int cout, int l, float eps,
                     int tanh_form, cudaStream_t stream) {
  switch (cout) {
    case 512:
      return launch_bf16<K, 256>(x, w_img, conv_bias, scale, bias, y, batch, cin, l, eps,
                                 tanh_form, stream);
    case 256:
      return launch_bf16<K, 128>(x, w_img, conv_bias, scale, bias, y, batch, cin, l, eps,
                                 tanh_form, stream);
    case 128:
      return launch_bf16<K, 64>(x, w_img, conv_bias, scale, bias, y, batch, cin, l, eps,
                                tanh_form, stream);
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace

ADDV_EXPORT int addv_conv_ln_gelu_max_c() { return MAX_C; }

// x [batch, cin, l], conv_bias / scale / bias [cout] f32,
// y [batch, cout, (l - k) / 2 + 1]; stride 2, no padding. The weight is
// [k, cin, cout] for f32 and the bf16 body's image [cin / 16][k][cout][2][8]
// (ops/cuda_conv.py::weight_image) for bf16. cin is a multiple of 16. cout is
// a multiple of 128 up to MAX_C for f32, and 128, 256 or 512 for bf16 (the
// two warpgroups of Cout / 2 channels, wgmma's N, one instantiation each).
ADDV_EXPORT int addv_conv_ln_gelu(const void* x, const void* w, const void* conv_bias,
                                  const void* scale, const void* bias, void* y, int batch,
                                  int cin, int cout, int l, int k, float eps, int tanh_form,
                                  int dtype, void* stream) {
  if (batch < 1 || batch > 65535 || (k != 2 && k != 3) || l < k || cin < KCW || cin % KCW ||
      cout < 16 * CWARPS || cout % (16 * CWARPS) || cout > MAX_C)
    return cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == ADDV_F32) {
    if (k == 3)
      return launch_f32(conv_ln_gelu_f32_kernel<3>, x, w, conv_bias, scale, bias, y, batch, cin,
                        cout, l, k, eps, tanh_form, st);
    return launch_f32(conv_ln_gelu_f32_kernel<2>, x, w, conv_bias, scale, bias, y, batch, cin,
                      cout, l, k, eps, tanh_form, st);
  }
  if (dtype == ADDV_BF16) {
    if (k == 3)
      return launch_bf16_cout<3>(x, w, conv_bias, scale, bias, y, batch, cin, cout, l, eps,
                                 tanh_form, st);
    return launch_bf16_cout<2>(x, w, conv_bias, scale, bias, y, batch, cin, cout, l, eps,
                               tanh_form, st);
  }
  return cudaErrorInvalidValue;
}

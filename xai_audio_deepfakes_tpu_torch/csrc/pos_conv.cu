// Kernel F: the embedder's grouped positional convolution, and its input
// gradient, on the tensor cores.
//
// Replaces no Pallas kernel: the JAX package leaves this convolution to XLA
// (xai_audio_deepfakes_tpu/models/wav2vec2.py, PositionalConvEmbedding). It
// was added because cuDNN runs the grouped k = 128 conv on the H100's CUDA
// cores (precomputed_convolve_sgemm forward, dgrad2d_grouped_direct_kernel
// for the input gradient), at about 3% of the tensor cores' rate.
//
// Per clip b, group g of cg channels, output frame t < t_out, channel co:
//   s[t, co] = sum_{tap < k, ci < cg} w[g cg + co, ci, tap] x[b, t + tap - pad_left, g cg + ci]
//   y[b, t, g cg + co] = round(round(s[t, co]) + bias[g cg + co])
// with rows of x outside [0, t_in) zero, s summed in f32, round to bf16 and
// the bias (bf16, optional) added in bf16: the cast points of flax's
// nn.Conv(dtype=bf16). x [B, t_in, H] and y [B, t_out, H] are the residual
// stream's own layout, so nothing is transposed on either side. The
// forward takes pad_left = k / 2 and t_out = t_in: the frame that HF drops
// after an even k is never computed. For a stride-1 conv the input gradient
// is the same conv over the output's gradient with the taps flipped and the
// in and out channels swapped within each group (the wrapper's gradient
// image), pad_left' = k - 1 - pad_left and no bias; the dropped frame's
// gradient is zero, which the zero rows past t_in give.
//
// What bounds it on the H100: the operations. At the offline explain's
// shape (192 clips of [249, 1920], k 128, 16 groups of 120) it is 2.82
// TFLOP against 0.43 GB, 2.85 ms at 989 TFLOP/s and 0.13 ms at 3.35 TB/s.
//
// Design: an implicit GEMM per (tile of TM = 256 output frames, clip,
// group): M = frames, N = the group's channels (wgmma's N = 120, XLS-R's
// group; a narrower group's extra columns are zeros in the weight image and
// the epilogue never stores them), K = k taps x cg channels, tap-major. It needs no im2col: one A tile in shared memory
// holds every input row the block's frames read (TM + k rows of the group's
// cg channels) as planes of 8 channels with rows 16 bytes apart, so a
// K-major descriptor (core matrices of 8 rows x 16 bytes, 128 bytes between
// 8-row groups) reads tap j's operand from the same planes by starting j
// rows, 16 bytes, later. A k16 step of K is two 8-channel chunks `lbo` bytes
// apart; where cg / 8 is odd a step straddles two taps (the last chunk of
// tap j and the first of tap j + 1), and a copy of plane 0 behind the last
// plane keeps that offset positive: the step reads the copy from row j + 1.
// So K is exactly k cg, and no step multiplies another group's channels.
// Where K is not a whole number of weight stages, the image pads it with
// zero weights, and the padded steps read rows past the last tap (the tile
// holds PAD_ROWS more): the activations there are finite, so they add exact
// zeros. XLS-R's K (960 steps, 160 stages) has no padded step.
//
// The weights stream through a ring of STAGES stages of STAGE_STEPS k16
// steps (the wrapper's image, [group][step][N / 8][2][8][8]: K-major core
// matrices, 128 bytes between a step's two chunks, 256 between groups of 8
// output channels), each one bulk copy that one producer thread issues on
// mbarriers, while the producer warpgroup loads the A tile with 16-byte
// cp.async (zero-filled outside [0, t_in): no padded copy of x exists).
// Two consumer warpgroups each own 128 of the tile's frames: two
// m64n120k16 wgmma a step against the same weight stage, 2 x 60 f32
// accumulators a thread. Blocks run group by group (blockIdx.z), so the
// blocks resident on the card at once share one group's weights (3.7 MB for
// XLS-R) in L2. The epilogue rounds, adds the bias and stores bf16 pairs
// from the registers straight into y.
//
// Determinism: every output element is the sum of one block in a fixed
// order; no split of K, no atomics. Two launches on the same inputs give
// the same bits.
#include "mma.cuh"

namespace {

using bf16 = __nv_bfloat16;

constexpr int TM = 256;       // output frames per block
constexpr int CWARPS = 8;     // consumers: two warpgroups of 128 frames
constexpr int PWARPS = 4;     // producer: one warpgroup
constexpr int THREADS = 32 * (CWARPS + PWARPS);
constexpr int STAGE_STEPS = 6;  // k16 steps of K in a weight stage
constexpr int STAGES = 5;       // weight stages in the ring
constexpr int N = 120;          // wgmma's N: output channels of a group, padded
constexpr int MAX_TAPS = 128;
// rows past tap k - 1 that a step reads: the straddle's row j + 1 and the
// padded steps of the last stage (fewer than 2 STAGE_STEPS chunks)
constexpr int PAD_ROWS = 2 * STAGE_STEPS + 1;

constexpr int STEP_BYTES = N * 32;  // a k16 step of the image: 16 K x N bf16
constexpr int SB = STAGE_STEPS * STEP_BYTES;  // bytes of a weight stage
__host__ __device__ inline int planes_of(int cg) { return cg / 8 + ((cg / 8) & 1); }
__host__ __device__ inline int tile_rows(int k) { return TM + k + PAD_ROWS; }

size_t smem_bytes(int cg, int k) {
  return static_cast<size_t>(STAGES) * SB + static_cast<size_t>(planes_of(cg)) * tile_rows(k) * 16;
}

__device__ __forceinline__ void pos_conv_body(const bf16* __restrict__ x,
                                              const bf16* __restrict__ w_img,
                                              const bf16* __restrict__ bias,
                                              bf16* __restrict__ y, int t_in, int t_out, int h,
                                              int cg, int k, int pad_left, int stages_total) {
  extern __shared__ __align__(128) unsigned char smem[];
  __shared__ __align__(8) uint64_t full[STAGES], empty[STAGES], a_full;
  unsigned char* ring = smem;
  unsigned char* a_tile = smem + STAGES * SB;  // [plane][row][8 channels]
  const int rows = tile_rows(k);
  const int nch = cg / 8;
  const int t0 = blockIdx.x * TM, b = blockIdx.y, g = blockIdx.z;

  if (threadIdx.x == 0) {
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(&full[s], 1);          // the copy's issuing thread + its bytes
      mbar_init(&empty[s], CWARPS);    // one a consumer warp
    }
    mbar_init(&a_full, PWARPS);        // one a producer warp
    mbar_init_fence();
  }
  __syncthreads();

  if (threadIdx.x >= 32 * CWARPS) {
    // ---- producer warpgroup
    const int pt = threadIdx.x - 32 * CWARPS;
    const bf16* wg = w_img + static_cast<long long>(g) * stages_total * (SB / 2);
    if (pt == 0) {
      for (int st = 0; st < STAGES && st < stages_total; ++st) {
        mbar_arrive_expect_tx(&full[st], SB);
        bulk_copy_to_shared(ring + st * SB, wg + static_cast<long long>(st) * (SB / 2), SB,
                            &full[st]);
      }
    }
    // the A tile: plane p holds channels 8 c .. 8 c + 7 of the group (c = p,
    // and c = 0 for the copy behind the last plane), row r frame
    // t0 - pad_left + r
    const bf16* xb = x + static_cast<long long>(b) * t_in * h + g * cg;
    const int planes = planes_of(cg);
    for (int i = pt; i < planes * rows; i += 32 * PWARPS) {
      const int p = i / rows, r = i - p * rows;
      const int c = p < nch ? p : 0;
      const int t = t0 - pad_left + r;
      const bool in = t >= 0 && t < t_in;
      cp_async16(a_tile + (p * rows + r) * 16, in ? xb + static_cast<long long>(t) * h + 8 * c : x,
                 in);
    }
    cp_async_commit();
    cp_async_wait<0>();
    fence_proxy_async();  // this thread's rows, visible to wgmma
    __syncwarp();         // ... the whole warp's, before its one arrival
    if (pt % 32 == 0) mbar_arrive(&a_full);
    if (pt == 0) {
      for (int st = STAGES; st < stages_total; ++st) {
        const int s = st % STAGES;
        mbar_wait(&empty[s], ((st / STAGES) - 1) & 1);
        mbar_arrive_expect_tx(&full[s], SB);
        bulk_copy_to_shared(ring + s * SB, wg + static_cast<long long>(st) * (SB / 2), SB,
                            &full[s]);
      }
    }
    return;
  }

  // ---- consumer warpgroups: frames 128 wgp .. 128 wgp + 127 of the tile
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int wgp = warp / 4, w4 = warp % 4;
  float acc[2][N / 2];  // the first step overwrites them
  const unsigned char* a_wg = a_tile + wgp * 128 * 16;
  int tap = 0, c = 0;  // the first chunk of the next step: tap, 8-channel chunk
  mbar_wait(&a_full, 0);
  for (int st = 0; st < stages_total; ++st) {
    const int s = st % STAGES;
    mbar_wait(&full[s], (st / STAGES) & 1);
    const unsigned char* ws = ring + s * SB;
    wgmma_fence();
#pragma unroll
    for (int j = 0; j < STAGE_STEPS; ++j) {
      // chunks (tap, c) and (tap, c + 1); past the last chunk of a tap the
      // second is plane c + 1 = nch, the copy of plane 0, one row on
      const unsigned lbo = rows * 16 + (c + 1 == nch ? 16 : 0);
      const unsigned char* a0 = a_wg + (c * rows + tap) * 16;
      const uint64_t db = smem_desc(ws + j * STEP_BYTES, 128, 256);
      const int accumulate = st > 0 || j > 0;
      wgmma_ss<N>(acc[0], smem_desc(a0, lbo, 128), db, accumulate);
      wgmma_ss<N>(acc[1], smem_desc(a0 + 64 * 16, lbo, 128), db, accumulate);
      c += 2;
      if (c >= nch) {  // the next tap (twice where a tap is one chunk)
        c -= nch;
        ++tap;
        if (c >= nch) {
          c -= nch;
          ++tap;
        }
      }
    }
    wgmma_commit();
    wgmma_wait<1>();  // stage st - 1's products are done: its slot is free
    if (st > 0) {
      __syncwarp();
      if (lane == 0) mbar_arrive(&empty[(st - 1) % STAGES]);
    }
  }
  wgmma_wait<0>();

  // ---- epilogue: acc[i][4 j + 2 r + e] is frame 128 wgp + 64 i + 16 w4 +
  // lane / 4 + 8 r, channel 8 j + 2 (lane % 4) + e
  const int gq = lane >> 2, q = lane & 3;
  bf16* yb = y + static_cast<long long>(b) * t_out * h + g * cg;
  const bf16* bg = bias == nullptr ? nullptr : bias + g * cg;
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int t = t0 + 128 * wgp + 64 * i + 16 * w4 + gq + 8 * r;
      if (t >= t_out) continue;
      bf16* row = yb + static_cast<long long>(t) * h;
#pragma unroll
      for (int j = 0; j < N / 8; ++j) {
        const int co = 8 * j + 2 * q;
        if (co >= cg) continue;
        float v0 = to_f32(from_f32<bf16>(acc[i][4 * j + 2 * r]));
        float v1 = to_f32(from_f32<bf16>(acc[i][4 * j + 2 * r + 1]));
        if (bg != nullptr) {
          v0 += to_f32(bg[co]);
          v1 += to_f32(bg[co + 1]);
        }
        *reinterpret_cast<__nv_bfloat162*>(row + co) = __floats2bfloat162_rn(v0, v1);
      }
    }
}

// Two entry points over one body, so that a device trace tells the forward
// launches from the gradient's by name.
__global__ void __launch_bounds__(THREADS, 1)
    pos_conv_fwd_kernel(const bf16* __restrict__ x, const bf16* __restrict__ w_img,
                        const bf16* __restrict__ bias, bf16* __restrict__ y, int t_in, int t_out,
                        int h, int cg, int k, int pad_left, int stages_total) {
  pos_conv_body(x, w_img, bias, y, t_in, t_out, h, cg, k, pad_left, stages_total);
}

__global__ void __launch_bounds__(THREADS, 1)
    pos_conv_dgrad_kernel(const bf16* __restrict__ x, const bf16* __restrict__ w_img,
                          bf16* __restrict__ y, int t_in, int t_out, int h, int cg, int k,
                          int pad_left, int stages_total) {
  pos_conv_body(x, w_img, nullptr, y, t_in, t_out, h, cg, k, pad_left, stages_total);
}

}  // namespace

// x [batch, t_in, h] bf16, y [batch, t_out, h] bf16, bias [h] bf16 or null
// (always null with grad). The weight image is
// [groups][stages][STAGE_STEPS][N / 8][2][8][8] bf16
// (ops/cuda_pos_conv.py::pos_conv_image). h = groups x cg, cg a multiple
// of 8 up to N; k taps up to MAX_TAPS; 0 <= pad_left < k. x, y and the
// image 16-byte aligned.
ADDV_EXPORT int addv_pos_conv(const void* x, const void* w_img, const void* bias, void* y,
                              int batch, int t_in, int t_out, int h, int groups, int k,
                              int pad_left, int grad, void* stream) {
  if (batch < 1 || batch > 65535 || groups < 1 || groups > 65535 || h % groups || t_in < 1 ||
      t_out < 1 || k < 1 || k > MAX_TAPS || pad_left < 0 || pad_left >= k || (grad && bias))
    return cudaErrorInvalidValue;
  const int cg = h / groups;
  if (cg % 8 || cg > N) return cudaErrorInvalidValue;
  const int stages_total = ((k * cg + 15) / 16 + STAGE_STEPS - 1) / STAGE_STEPS;
  const size_t smem = smem_bytes(cg, k);
  const dim3 grid((t_out + TM - 1) / TM, batch, groups);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const bf16* xp = static_cast<const bf16*>(x);
  const bf16* wp = static_cast<const bf16*>(w_img);
  bf16* yp = static_cast<bf16*>(y);
  cudaError_t err;
  if (grad) {
    err = allow_smem(pos_conv_dgrad_kernel, smem);
    if (err != cudaSuccess) return err;
    pos_conv_dgrad_kernel<<<grid, THREADS, smem, st>>>(xp, wp, yp, t_in, t_out, h, cg, k,
                                                       pad_left, stages_total);
  } else {
    err = allow_smem(pos_conv_fwd_kernel, smem);
    if (err != cudaSuccess) return err;
    pos_conv_fwd_kernel<<<grid, THREADS, smem, st>>>(xp, wp, static_cast<const bf16*>(bias), yp,
                                                     t_in, t_out, h, cg, k, pad_left,
                                                     stages_total);
  }
  return cudaGetLastError();
}

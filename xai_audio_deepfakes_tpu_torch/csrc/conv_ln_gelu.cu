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
// them, so the frontend never transposes. The weight arrives as
// [k, Cin, Cout] (the wrapper permutes torch's [Cout, Cin, k] once per call,
// 1.5 MB in bf16), which makes a staged weight row contiguous over Cout.
//
// What bounds it on the H100: the operations. At the main path's shape
// (batch 24, 512 -> 512, six layers) it is 585 GFLOP against 1.2 GB moved,
// so the tensor cores' 0.59 ms is the bound.
//
// Design: a block owns 32 output frames and ALL Cout channels, because the
// LayerNorm reduces over them, and walks the input channels a chunk at a
// time, staging the chunk's k * Cout weights and its 2 * 32 + k - 2 input
// samples in shared memory. After the product the block writes its
// [Cout x 32] tile of f32 sums over the staging area, rounds them, adds the
// bias, and runs kernel D's statistics and epilogue on the tile from shared
// memory, so the conv result never reaches device memory. Two bodies compute
// the product:
//  - bf16: the tensor cores (`mma.sync` through the WMMA interface, 16x16x16
//    tiles, f32 accumulation). Per tap the conv is C[co, t] += W_tap[co, ci]
//    * X_tap[ci, t] with X_tap[ci, t] = x[ci, 2 t + tap]. The samples are
//    staged transposed, xT[p][ci], so that X_tap is a column-major matrix
//    with leading dimension 2 * 16 starting at row `tap`: the stride-2 read
//    costs nothing. The weights are staged as [tap][ci][co], a column-major
//    A operand. 8 warps; a warp owns Cout / 128 row tiles and both 16-frame
//    column tiles. It is bound by staging: every block reads all weights
//    from L2 once, with no copy overlapped with the products.
//  - f32: full-f32 FMAs on the CUDA cores (tensor cores would mean TF32). A
//    thread keeps 8 frames x (Cout / 64) channels of sums in registers; a
//    warp's threads own 32 neighbouring channels of the same 8 frames, so
//    weight reads are conflict-free and sample reads are broadcasts, and one
//    staged sample row serves all k taps. Bound by the f32 FMA rate.
#include <math.h>
#include <mma.h>

#include "common.cuh"

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

// bf16 body
constexpr int WM = 16;             // WMMA tile edge
constexpr int KC_BF16 = WM;        // input channels staged at once: one k step per tap
constexpr int WARPS = THREADS / 32;
constexpr int MT = MAX_C / WM / WARPS;  // row tiles per warp at Cout = MAX_C
constexpr int NT = TF / WM;        // column tiles per block
constexpr int WPAD = 8;            // pad of a staged weight row (bank spread, keeps 16-byte rows)
constexpr int LDT_BF16 = TF + 4;   // row stride of the output tile (store_matrix_sync: multiple of 4)

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

size_t staging_bytes_bf16(int k, int cout) {
  return sizeof(__nv_bfloat16) *
         (static_cast<size_t>(KC_BF16) * k * (cout + WPAD) + x_cols(k) * KC_BF16);
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

template <int K>
__global__ void __launch_bounds__(THREADS, 2)
    conv_ln_gelu_bf16_kernel(const __nv_bfloat16* __restrict__ x,
                             const __nv_bfloat16* __restrict__ w,
                             const float* __restrict__ conv_bias,
                             const float* __restrict__ scale, const float* __restrict__ bias,
                             __nv_bfloat16* __restrict__ y, int cin, int cout, int l, int lout,
                             float eps, int tanh_form, int region_floats) {
  using namespace nvcuda;
  using bf16 = __nv_bfloat16;
  constexpr int KC = KC_BF16;
  constexpr int XC = x_cols(K);
  extern __shared__ __align__(128) unsigned char smem_raw[];
  const int wld = cout + WPAD;                        // staged weight row stride
  bf16* ws = reinterpret_cast<bf16*>(smem_raw);       // [K][KC][wld]
  bf16* xt = ws + K * KC * wld;                       // [XC][KC]: samples, transposed
  float* tile = reinterpret_cast<float*>(smem_raw);   // [cout][LDT_BF16], after the product
  float* red = tile + region_floats;
  float* stat = red + GROUPS * TF;

  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int t0 = blockIdx.x * TF;
  const int mt = cout / WM / WARPS;  // row tiles of this warp: warp + WARPS * i
  const bf16* xb = x + static_cast<long long>(blockIdx.y) * cin * l;

  wmma::fragment<wmma::accumulator, WM, WM, WM, float> acc[MT][NT];
#pragma unroll
  for (int i = 0; i < MT; ++i)
#pragma unroll
    for (int n = 0; n < NT; ++n) wmma::fill_fragment(acc[i][n], 0.f);

  const int vec_per_row = cout / 8;  // 16-byte vectors in a weight row
  for (int c0 = 0; c0 < cin; c0 += KC) {
    __syncthreads();
    // weights: [tap][ci] rows of cout values, contiguous in w, 16 bytes a thread
    for (int i = tid; i < K * KC * vec_per_row; i += THREADS) {
      const int r = i / vec_per_row, v = i % vec_per_row;  // r = tap * KC + ci
      const int tap = r / KC, ci = r % KC;
      const uint4* src = reinterpret_cast<const uint4*>(
          w + (static_cast<long long>(tap) * cin + c0 + ci) * cout);
      reinterpret_cast<uint4*>(ws + r * wld)[v] = src[v];
    }
    // samples: read along the signal, stored transposed
    for (int i = tid; i < KC * XC; i += THREADS) {
      const int ci = i / XC, p = i % XC;
      const int pos = 2 * t0 + p;
      xt[p * KC + ci] =
          pos < l ? xb[static_cast<long long>(c0 + ci) * l + pos] : __float2bfloat16_rn(0.f);
    }
    __syncthreads();
#pragma unroll
    for (int tap = 0; tap < K; ++tap) {
      // X_tap[ci, t] = xt[(2 t + tap) * KC + ci]: column-major, leading dimension 2 * KC
      wmma::fragment<wmma::matrix_b, WM, WM, WM, bf16, wmma::col_major> b[NT];
#pragma unroll
      for (int n = 0; n < NT; ++n)
        wmma::load_matrix_sync(b[n], xt + (2 * n * WM + tap) * KC, 2 * KC);
#pragma unroll
      for (int i = 0; i < MT; ++i) {
        if (i < mt) {
          // W_tap[co, ci] = ws[(tap * KC + ci) * wld + co]: column-major
          wmma::fragment<wmma::matrix_a, WM, WM, WM, bf16, wmma::col_major> a;
          wmma::load_matrix_sync(a, ws + tap * KC * wld + (warp + WARPS * i) * WM, wld);
#pragma unroll
          for (int n = 0; n < NT; ++n) wmma::mma_sync(acc[i][n], a, b[n], acc[i][n]);
        }
      }
    }
  }
  __syncthreads();
#pragma unroll
  for (int i = 0; i < MT; ++i) {
    if (i < mt) {
#pragma unroll
      for (int n = 0; n < NT; ++n)
        wmma::store_matrix_sync(tile + (warp + WARPS * i) * WM * LDT_BF16 + n * WM, acc[i][n],
                                LDT_BF16, wmma::mem_row_major);
    }
  }
  __syncthreads();
  ln_gelu_tile<bf16>(tile, LDT_BF16, red, stat, conv_bias, scale, bias,
                     y + static_cast<long long>(blockIdx.y) * cout * lout, cout, lout, t0, eps,
                     tanh_form);
}

template <typename T, typename Kernel>
int launch(Kernel kernel, size_t region_bytes, const void* x, const void* w,
           const void* conv_bias, const void* scale, const void* bias, void* y, int batch,
           int cin, int cout, int l, int k, float eps, int tanh_form, cudaStream_t stream) {
  const int lout = (l - k) / 2 + 1;
  const size_t smem = region_bytes + sizeof(float) * EPILOGUE_FLOATS;
  cudaError_t err = allow_smem(kernel, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((lout + TF - 1) / TF, batch);
  kernel<<<grid, THREADS, smem, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(w), static_cast<const float*>(conv_bias),
      static_cast<const float*>(scale), static_cast<const float*>(bias), static_cast<T*>(y), cin,
      cout, l, lout, eps, tanh_form, static_cast<int>(region_bytes / sizeof(float)));
  return cudaGetLastError();
}

}  // namespace

ADDV_EXPORT int addv_conv_ln_gelu_max_c() { return MAX_C; }

// x [batch, cin, l], w [k, cin, cout], conv_bias / scale / bias [cout] f32,
// y [batch, cout, (l - k) / 2 + 1]; stride 2, no padding. cin is a multiple
// of 16 and cout of 128 (the bf16 body's warp tiling), up to MAX_C.
ADDV_EXPORT int addv_conv_ln_gelu(const void* x, const void* w, const void* conv_bias,
                                  const void* scale, const void* bias, void* y, int batch,
                                  int cin, int cout, int l, int k, float eps, int tanh_form,
                                  int dtype, void* stream) {
  if (batch < 1 || batch > 65535 || (k != 2 && k != 3) || l < k || cin < KC_BF16 ||
      cin % KC_BF16 || cout < WM * WARPS || cout % (WM * WARPS) || cout > MAX_C)
    return cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == ADDV_F32) {
    const size_t region = shared_region_bytes(staging_bytes_f32(k, cout), cout, LDT_F32);
    if (k == 3)
      return launch<float>(conv_ln_gelu_f32_kernel<3>, region, x, w, conv_bias, scale, bias, y,
                           batch, cin, cout, l, k, eps, tanh_form, st);
    return launch<float>(conv_ln_gelu_f32_kernel<2>, region, x, w, conv_bias, scale, bias, y,
                         batch, cin, cout, l, k, eps, tanh_form, st);
  }
  if (dtype == ADDV_BF16) {
    const size_t region = shared_region_bytes(staging_bytes_bf16(k, cout), cout, LDT_BF16);
    if (k == 3)
      return launch<__nv_bfloat16>(conv_ln_gelu_bf16_kernel<3>, region, x, w, conv_bias, scale,
                                   bias, y, batch, cin, cout, l, k, eps, tanh_form, st);
    return launch<__nv_bfloat16>(conv_ln_gelu_bf16_kernel<2>, region, x, w, conv_bias, scale,
                                 bias, y, batch, cin, cout, l, k, eps, tanh_form, st);
  }
  return cudaErrorInvalidValue;
}

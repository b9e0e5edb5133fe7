// Kernel D: channel LayerNorm + GELU, the conv frontend's epilogue.
//
// Replaces xai_audio_deepfakes_tpu/ops/pallas_ln_gelu.py::_ln_gelu_pallas
// (the Pallas kernel behind ln_gelu), with the GELU formulations of
// ops/pallas_conv.py::_gelu_kernel.
//
// Per (batch, frame) row over C channels: f32 mean, centred f32 variance,
// rsqrt(var + eps), f32 scale and bias, cast to the compute dtype; then GELU
// (exact erf, or tanh) computed in f32 from that rounded value and cast back.
// These are the cast points of the Pallas kernel. The Pallas version builds
// erf from exp (Abramowitz & Stegun) only because Mosaic has no erf; CUDA
// has erff, and this kernel uses it.
//
// Layout: the activation stays in the [B, C, L] layout that F.conv1d gives
// and takes, so the frontend never transposes its largest tensor
// ([3B, 512, 15999] at the main path's shape). A frame's C values are L
// apart, and every frontend length is odd, so the channel rows start at every
// residue modulo 16 bytes.
//
// What bounds it on the H100: the bytes (each element read once and written
// once, ~1.56 GB of bf16 over the seven frontend layers at the main path's
// shape, ~0.47 ms at 3.35 TB/s), provided that the instructions per element
// stay few and that no access is narrower than 16 bytes.
//
// Design: a tile is all C channels x F frames of one batch row, 128 bytes of
// each channel row (F = 64 for bf16, 32 for f32). Every row of the tile
// lives in a ring of 16-byte chunks in shared memory (R of them a row),
// filled by cp.async copies of the row's aligned chunks: the tile's frame l0
// sits at the row's shift, (row start + l0) mod VEC counted from the 16-byte
// block of the data pointer (VEC = 16 / sizeof(T)), so a view with a
// storage offset works too; y must have x's shift. A block walks
// a run of consecutive tiles of one batch row, so that the chunk a tile shares
// with the next (its own last frames, the next tile's first ones) is copied
// once, stays in the ring, receives both tiles' outputs and is stored once,
// whole. Each 16-byte chunk is thus read once and written once, and only the
// two chunks at the ends of a run are stored element by element, their own
// frames only; so the kernel may run in place (a block reads its neighbours'
// frames at the ends of its run and discards them). The next tile's copies
// are in flight while a tile computes. A block has 8 x F threads; channel
// group g (warps g, g + 8, ...) owns channels g, g + 8, ...; 8 L is a
// multiple of VEC, so all of them share one shift, and a thread (one frame)
// reads its C / 8 values at constant offsets into registers, where the
// statistics and the output are computed, then writes the output back over
// its input in the ring. The grid is persistent (one block a SM at C = 512),
// each block taking one contiguous range of tiles. The GELU form is a
// template constant, and C = 512 has its own instantiation without
// per-channel predicates.
#include <math.h>
#include <stdint.h>

#include "mma.cuh"

namespace {

constexpr int GROUPS = 8;  // channel groups: warps g, g + 8, ... hold channels g, g + 8, ...
constexpr int MAX_C = 512;
constexpr int PER_THREAD = MAX_C / GROUPS;
constexpr int MAX_F = 64;

// frames of a tile (one a thread of a channel group: 128 bytes of a row for
// both types), threads of a block; elements of one 16-byte chunk; chunks that
// a tile adds to a row's ring (a tile spans NEW + 1, the first shared with the
// tile before); chunks of a row's ring: the tile in work, the next one's
// copies and, when the next tile starts a run, its extra first chunk
template <typename T>
__host__ __device__ constexpr int frames() { return sizeof(T) == 2 ? 64 : 32; }
template <typename T>
__host__ __device__ constexpr int threads() { return GROUPS * frames<T>(); }
template <typename T>
__host__ __device__ constexpr int vec() { return 16 / static_cast<int>(sizeof(T)); }
template <typename T>
__host__ __device__ constexpr int fresh() { return frames<T>() / vec<T>(); }
template <typename T>
__host__ __device__ constexpr int ring() { return 2 * fresh<T>() + 2; }

// dynamic shared memory: C row rings, then (scale, bias) pairs
template <typename T>
size_t smem_bytes(int c) {
  return static_cast<size_t>(c) * ring<T>() * 16 + sizeof(float2) * c;
}

template <typename T>
__device__ __forceinline__ int misalignment(const T* p) {
  return static_cast<int>((reinterpret_cast<uintptr_t>(p) % 16) / sizeof(T));
}

// Chunks j0..NEW of the tile at frame l0 into the rings: chunk j of row r
// holds elements [floor_VEC(mis + (row0 + r) l + l0) + VEC j, + VEC) counted
// from `xa`, the 16-byte block of x, and goes to ring slot (q + j) mod R.
// Chunks past the end of x are zero-filled.
template <typename T>
__device__ __forceinline__ void issue_tile(T* rings, const T* xa, long long x_end, int mis,
                                           long long row0, int c, int l, int l0, int q, int j0) {
  constexpr int VEC = vec<T>(), NEW = fresh<T>(), R = ring<T>();
  const int n = NEW + 1 - j0;
  for (int k = threadIdx.x; k < c * n; k += threads<T>()) {
    const int r = k / n, j = j0 + k - r * n;
    const long long s =
        ((mis + (row0 + r) * l + l0) & ~static_cast<long long>(VEC - 1)) + VEC * j;
    const long long avail = x_end - s;
    const int bytes =
        avail >= VEC ? 16 : (avail > 0 ? static_cast<int>(avail * sizeof(T)) : 0);
    cp_async16_bytes(rings + (r * R + (q + j) % R) * VEC, bytes > 0 ? xa + s : xa, bytes);
  }
}

// rounds two f32 values to T and back (one packed conversion for bf16)
__device__ __forceinline__ void round_pair(float& a, float& b, float) {}
__device__ __forceinline__ void round_pair(float& a, float& b, __nv_bfloat16) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(a, b);
  a = __low2float(h);
  b = __high2float(h);
}

// The sum over frame fr's channels, in the order of PyTorch's CUDA reduction
// for a mean over 512 channels of [B, 512, L] with L odd (Reduce.cuh: 16 rows
// of threads, row t summing channels t mod 16 in four interleaved
// accumulators that it then adds in order, and a tree over the rows), so
// that at C = 512 the statistics equal the plain version's bit for bit and
// the normalised value never rounds to another bf16 value than the plain
// version's. Channel group g holds rows g (its even i) and g + 8 (its odd
// i), so the tree's first level is the thread's own; `red` takes the rest.
// SQUARE sums the rounded squares, as the plain version's mean of
// (x - mu)^2 does.
template <int F, bool FULL, bool SQUARE>
__device__ __forceinline__ float frame_sum(const float (&v)[PER_THREAD], float* red, int c) {
  const int g = threadIdx.x / 32 % GROUPS, fr = threadIdx.x / (32 * GROUPS) * 32 + threadIdx.x % 32;
  float acc[2][4] = {};
#pragma unroll
  for (int i = 0; i < PER_THREAD; ++i)
    if (FULL || g + GROUPS * i < c)
      acc[i % 2][(i / 2) % 4] += SQUARE ? __fmul_rn(v[i], v[i]) : v[i];
  float row[2];
#pragma unroll
  for (int p = 0; p < 2; ++p) row[p] = ((acc[p][0] + acc[p][1]) + acc[p][2]) + acc[p][3];
  red[g * F + fr] = row[0] + row[1];
  __syncthreads();
  const float* u = red + fr;
  return ((u[0] + u[4 * F]) + (u[2 * F] + u[6 * F])) +
         ((u[1 * F] + u[5 * F]) + (u[3 * F] + u[7 * F]));
}

// LayerNorm + GELU of the tile: the thread of warp g + 8 h, lane fr - 32 h
// holds frame fr, channels g + 8 i, read from the rings at element `base` +
// fr (modulo a ring) and written back over the input. The normalisation
// rounds after each operation, as the plain version's separate tensor
// operations do (no fused multiply-add).
template <typename T, int TANH, bool FULL>
__device__ __forceinline__ void compute_tile(T* rings, const float2* sb, float* red, int c,
                                             int base, float eps) {
  constexpr int LD = ring<T>() * vec<T>(), F = frames<T>();  // LD: elements of a row's ring
  const int g = threadIdx.x / 32 % GROUPS, fr = threadIdx.x / (32 * GROUPS) * 32 + threadIdx.x % 32;
  const int pos = base + fr < LD ? base + fr : base + fr - LD;
  T* in = rings + g * LD + pos;
  float v[PER_THREAD];
#pragma unroll
  for (int i = 0; i < PER_THREAD; ++i)
    v[i] = (FULL || g + GROUPS * i < c) ? to_f32(in[i * GROUPS * LD]) : 0.f;
  const float mu = frame_sum<F, FULL, false>(v, red, c) / c;
#pragma unroll
  for (int i = 0; i < PER_THREAD; ++i) v[i] -= mu;
  const float var = frame_sum<F, FULL, true>(v, red + GROUPS * F, c) / c;
  const float rs = rsqrtf(__fadd_rn(var, eps));

  T* out = in;
#pragma unroll
  for (int i = 0; i < PER_THREAD; i += 2) {
    const bool ok0 = FULL || g + GROUPS * i < c, ok1 = FULL || g + GROUPS * (i + 1) < c;
    const float2 p0 = ok0 ? sb[g + GROUPS * i] : make_float2(0.f, 0.f);
    const float2 p1 = ok1 ? sb[g + GROUPS * (i + 1)] : make_float2(0.f, 0.f);
    float n0 = __fadd_rn(__fmul_rn(__fmul_rn(v[i], rs), p0.x), p0.y);
    float n1 = __fadd_rn(__fmul_rn(__fmul_rn(v[i + 1], rs), p1.x), p1.y);
    round_pair(n0, n1, T());
    if (ok0) out[i * GROUPS * LD] = from_f32<T>(gelu_f32(n0, TANH));
    if (ok1) out[(i + 1) * GROUPS * LD] = from_f32<T>(gelu_f32(n1, TANH));
  }
}

// The tile's chunks from the rings to y. A chunk goes as one 16-byte store
// when all its elements are to be stored: the tile's frames (f < nf), and
// with `prev` the previous tile's last frames (f < 0), which that tile left
// in the shared chunk. With `defer` the last chunk waits for the next tile.
// Anything else is stored element by element.
template <typename T>
__device__ __forceinline__ void store_tile(const T* rings, T* ya, int mis, long long row0, int c,
                                           int l, int l0, int nf, int q, bool prev, bool defer) {
  constexpr int VEC = vec<T>(), NEW = fresh<T>(), R = ring<T>();
  const int lo = prev ? -VEC : 0;
  for (int k = threadIdx.x; k < c * (NEW + 1); k += threads<T>()) {
    const int r = k / (NEW + 1), j = k - r * (NEW + 1);
    if (defer && j == NEW) continue;
    const long long ay = mis + (row0 + r) * l + l0;  // frame l0 of row r, from ya
    const int sh = static_cast<int>(ay & (VEC - 1));
    T* dst = ya + (ay - sh) + VEC * j;
    const T* src = rings + (r * R + (q + j) % R) * VEC;
    const int f0 = VEC * j - sh;  // the frame of the chunk's first element
    if (f0 >= lo && f0 + VEC <= nf) {
      *reinterpret_cast<uint4*>(dst) = *reinterpret_cast<const uint4*>(src);
    } else {
#pragma unroll
      for (int e = 0; e < VEC; ++e)
        if (f0 + e >= lo && f0 + e < nf) dst[e] = src[e];
    }
  }
}

// The tile after t in this block's walk (ntiles if none): the next tile of
// its range of `span` tiles, else the first of its next range.
__device__ __forceinline__ int next_tile(int t, int span, int ntiles) {
  int n = t + 1;
  if (n % span == 0) n += static_cast<int>(gridDim.x - 1) * span;
  return n < ntiles ? n : ntiles;
}

template <typename T, int TANH, bool FULL>
__global__ void __launch_bounds__(threads<T>(), 512 / threads<T>())
    ln_gelu_kernel(const T* x, const float* __restrict__ scale, const float* __restrict__ bias,
                   T* y, int batch, int c, int l, float eps, int span) {
  constexpr int VEC = vec<T>(), NEW = fresh<T>(), R = ring<T>(), F = frames<T>();
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ float red[2 * GROUPS * MAX_F];
  T* rings = reinterpret_cast<T*>(smem);
  float2* sb = reinterpret_cast<float2*>(smem + static_cast<size_t>(c) * R * 16);
  for (int ch = threadIdx.x; ch < c; ch += threads<T>()) sb[ch] = make_float2(scale[ch], bias[ch]);

  const int mis = misalignment(x);  // y's too (the launcher checks)
  const T* xa = x - mis;
  T* ya = y - mis;
  const long long x_end = mis + static_cast<long long>(batch) * c * l;
  const int ntl = (l + F - 1) / F;
  const int ntiles = batch * ntl;
  const int g = threadIdx.x / 32 % GROUPS;

  int t = blockIdx.x * span, q = 0;
  bool prev = false;  // t continues a run: its first chunk is in the ring
  if (t < ntiles)
    issue_tile(rings, xa, x_end, mis, static_cast<long long>(t / ntl) * c, c, l, t % ntl * F, 0,
               0);
  cp_async_commit();
  while (t < ntiles) {
    const int tn = next_tile(t, span, ntiles);
    const bool cont = tn == t + 1 && tn % ntl != 0;  // tn continues this run
    const int qn = (q + NEW + (cont ? 0 : 1)) % R;
    if (tn < ntiles)
      issue_tile(rings, xa, x_end, mis, static_cast<long long>(tn / ntl) * c, c, l, tn % ntl * F,
                 qn, cont ? 1 : 0);
    cp_async_commit();  // an empty group past the end keeps the count uniform
    cp_async_wait<1>();  // this tile's copies (this thread's) have landed
    __syncthreads();
    const int b = t / ntl, l0 = (t - b * ntl) * F;
    const long long row0 = static_cast<long long>(b) * c;
    const int sh = static_cast<int>((mis + (row0 + g) * l + l0) & (VEC - 1));
    compute_tile<T, TANH, FULL>(rings, sb, red, c, (q * VEC + sh) % (R * VEC), eps);
    __syncthreads();
    store_tile(rings, ya, mis, row0, c, l, l0, min(F, l - l0), q, prev, cont);
    __syncthreads();  // the stored chunks' slots are free for the copies after next
    prev = cont;
    q = qn;
    t = tn;
  }
  cp_async_wait<0>();
}

template <typename T, int TANH, bool FULL>
int launch(const void* x, const void* scale, const void* bias, void* y, int batch, int c, int l,
           float eps, cudaStream_t stream) {
  auto kernel = ln_gelu_kernel<T, TANH, FULL>;
  const size_t smem = smem_bytes<T>(c);
  cudaError_t err = allow_smem(kernel, smem);
  int dev = 0, sms = 0, per_sm = 0;
  if (err == cudaSuccess) err = cudaGetDevice(&dev);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, threads<T>(), smem);
  if (err != cudaSuccess) return err;
  if (per_sm < 1) return cudaErrorInvalidConfiguration;
  // one range of `span` consecutive tiles a block
  constexpr int F = frames<T>();
  const long long ntiles = static_cast<long long>(batch) * ((l + F - 1) / F);
  const long long blocks = static_cast<long long>(per_sm) * sms;
  const int span = static_cast<int>((ntiles + blocks - 1) / blocks);
  const int grid = static_cast<int>((ntiles + span - 1) / span);
  kernel<<<grid, threads<T>(), smem, stream>>>(static_cast<const T*>(x),
                                          static_cast<const float*>(scale),
                                          static_cast<const float*>(bias), static_cast<T*>(y),
                                          batch, c, l, eps, span);
  return cudaGetLastError();
}

template <typename T>
int launch_form(const void* x, const void* scale, const void* bias, void* y, int batch, int c,
                int l, float eps, int tanh_form, cudaStream_t stream) {
  if (c == MAX_C)
    return tanh_form ? launch<T, 1, true>(x, scale, bias, y, batch, c, l, eps, stream)
                     : launch<T, 0, true>(x, scale, bias, y, batch, c, l, eps, stream);
  return tanh_form ? launch<T, 1, false>(x, scale, bias, y, batch, c, l, eps, stream)
                   : launch<T, 0, false>(x, scale, bias, y, batch, c, l, eps, stream);
}

}  // namespace

ADDV_EXPORT int addv_ln_gelu_max_c() { return MAX_C; }

// x, y [batch, c, l] contiguous (y may be x), at any element-aligned address
// with the same residue modulo 16 bytes for both; scale, bias [c] f32.
ADDV_EXPORT int addv_ln_gelu(const void* x, const void* scale, const void* bias, void* y,
                             int batch, int c, int l, float eps, int tanh_form, int dtype,
                             void* stream) {
  if (batch < 1 || c < 1 || c > MAX_C || l < 1 ||
      reinterpret_cast<uintptr_t>(x) % 16 != reinterpret_cast<uintptr_t>(y) % 16 ||
      static_cast<long long>(batch) * l > 0x7fffffffLL)
    return cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == ADDV_F32)
    return launch_form<float>(x, scale, bias, y, batch, c, l, eps, tanh_form, st);
  if (dtype == ADDV_BF16)
    return launch_form<__nv_bfloat16>(x, scale, bias, y, batch, c, l, eps, tanh_form, st);
  return cudaErrorInvalidValue;
}

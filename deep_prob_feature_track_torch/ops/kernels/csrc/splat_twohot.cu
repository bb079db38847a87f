// Adjoint of the bilinear sample: splat an output cotangent back onto the
// channels-last plane it was sampled from, in fixed point, so that the
// result has the same bits on every run.
//
// Replaces the Pallas TPU kernel splat_twohot
// (deep_prob_feature_track_tpu/ops/pallas/gather.py:283 _splat_kernel,
// pallas_call :363, entry :400) and the XLA banded two-hot splat it falls
// back to (geometry/warp.py:501-636 _splat_twohot):
//
//   d_op[b, y, x, c] = sum_n V[b, n, y] U[b, n, x] g[b, c, n]
//
// where V and U hold (1-dv, dv) at rows (v0, v0+1) and (1-du, du) at columns
// (u0, u0+1).  The TPU builds those two-hot matrices and contracts them on
// the MXU because its scatter-add serialises; it keeps the accumulator plane
// in VMEM across a sequential grid, so its sums run in one order.  Hopper
// has no sequential grid: CTAs add into the plane with atomics, in an order
// that changes from run to run, and float addition is not associative.  So
// the sums here are integers:
//
// - Each product p = g * w is formed in float32 (the plain version's
//   product), scaled by 2^s in float64 (exact) and rounded half to even to
//   an int64.  s is per (b, c): s = min(51, 62 - ceil(log2 N)) - e, where
//   2^e > the largest finite |g[b, c, :]| (frexp's exponent).  A sample's
//   four corners are distinct cells (the starts are clamped to
//   [0, size-2]) and its weights lie in [0, 1], so a cell takes at most N
//   products of at most 2^(62 - ceil(log2 N)) each: its sum stays within
//   2^62, and int64 addition is exact and associative.  Whatever order the
//   atomics and the staged lists take, the integers, and so the bits of the
//   result, are the same.  The quantum 2^-s is 2^-46 of the largest |g| at
//   120x160 (N = 19,200) and 2^-42 at 480x640, far below float32's
//   rounding of the result.
// - Non-finite products (NaN or Inf in g or a weight) are added in float32
//   into d_op itself, with float atomics: whether a cell ends NaN, +Inf or
//   -Inf does not depend on the order.
// - The result is the int64 sum converted to float64, times 2^-s (exact),
//   rounded to float32, wherever d_op holds no non-finite sum (it is 0
//   there); elsewhere the non-finite sum.  ops/kernels/splat.py's plain
//   version computes the same integers and roundings, bit for bit.
//
// The launch function runs, on the caller's stream with no host sync:
// memsets of d_op, of the int64 plane acc and of the per-(b, c) maxima;
// finite_max_kernel, which writes the bits of each (b, c)'s largest finite
// |g| (atomicMax on the bits of a non-negative float orders as the float);
// splat_twohot_kernel; and convert_kernel.
//
// The splat merges the adds of neighbouring samples before they leave the
// CTA, with integer shared atomics only (sm_90 has no shared-memory float
// atomics):
//
// 1. The samples are read as rows of W (the tracker's warps sample the plane
//    at its own size, so sample (r, x) lands near cell (r, x); for any other
//    N the view is only a grouping).  A CTA of tile_h x 32 threads takes a
//    tile_h x 32 tile of them (tile_h = 8 for C <= 32, else 1, so the staged
//    cotangent stays small), one warp per row, loads its coordinates
//    coalesced, clamps the corner starts to [0, size-2], puts each sample's
//    four corner weights in shared memory, stages g[b, :, tile] there
//    (loaded coalesced over n, the [B,C,N] layout the autograd backward hands
//    over), puts each channel's 2^s there and reduces the tile's corner box
//    [vmin, vmax+1] x [umin, umax+1].
// 2. Staged, when the box has at most `capacity` cells: each sample pushes
//    itself onto the list of its 00 cell (atomicExch on an int, native in
//    shared memory).  Then each (cell, channel) of the box sums its
//    contributors' fixed-point products in int64 registers -- the lists of
//    cells (y, x), (y, x-1), (y-1, x) and (y-1, x-1), with their 00, 01, 10
//    and 11 weights -- and adds the sum to acc with one 64-bit integer
//    atomic (neighbouring tiles' boxes overlap); consecutive lanes take
//    consecutive channels and cells.  Under a smooth warp an 8 x 32 tile's
//    256 samples reach ~300 cells: ~3.4x fewer adds, in whole sectors.
// 3. Global, otherwise: the CTA walks the flattened k = s*C + c of its
//    samples with consecutive lanes and adds each fixed-point product
//    straight into acc, so a warp's atomics cover ~32/C samples' contiguous
//    channel runs.
//
// The choice is made per CTA, inside the launch.  Where C is even a lane
// takes two channels (VEC = 2); there is no vector atomic for int64, so it
// issues two.
//
// Bound: bytes (the cotangent, four coordinate arrays, and the plane written
// once), which the memsets, the max pre-pass's read of g, the int64 plane's
// atomics in L2 and the convert's read of it and of d_op exceed; the
// arithmetic is 12 flops per (sample, channel).

#include <climits>
#include <cstdint>
#include <cuda_runtime.h>

// The launch function's one argument; ops/kernels/splat.py packs it with
// the struct format "8P6iP" (native layout).
struct SplatArgs {
  const float* g;  // [B,C,N]
  const int* v0;   // [B,N]
  const float* dv;
  const int* u0;
  const float* du;
  float* d_op;    // [B,H,W,C]: the non-finite sums, then the result
  int64_t* acc;   // [B,H,W,C] scratch: the fixed-point sums
  unsigned* top;  // [B*C] scratch: bits of each (b, c)'s largest finite |g|
  int B, H, W, C, N;
  int capacity;  // corner-box cells a CTA may stage
  void* stream;
};

namespace {

constexpr int kTileW = 32;   // one warp per tile row
constexpr int kMaxRows = 8;  // tile rows for C <= 32: 256 threads per CTA
constexpr size_t kMaxShared = 227 * 1024;
constexpr int kSumBits = 62;      // a cell's sum stays below 2^62
constexpr int kProductBits = 51;  // each product's below 2^51 (the plain
                                  // version rounds by adding 1.5 * 2^52)
constexpr int kMaxChunk = 4096;   // samples of one (b, c) a pre-pass CTA scans
constexpr int kThreads = 256;

size_t shared_bytes(int tile_h, int C, int capacity) {
  const size_t S = (size_t)tile_h * kTileW;
  return S * (sizeof(float4) + sizeof(int2) + sizeof(int) + sizeof(float) * C) +
         (size_t)C * sizeof(double) + (size_t)capacity * sizeof(int);
}

// frexp's exponent of the finite float >= 0 with these bits (0 for 0)
__device__ __forceinline__ int frexp_exponent(unsigned bits) {
  if (bits == 0) return 0;
  const int biased = (int)(bits >> 23);
  return biased ? biased - 126 : (32 - __clz((int)bits)) - 149;
}

// 2^s of channel (b, c) whose largest finite |g| has the bits `top`
__device__ __forceinline__ int fixed_shift(unsigned top, int log2n) {
  return min(kProductBits, kSumBits - log2n) - frexp_exponent(top);
}

// 2^e, exactly, for e in [-1022, 1023]
__device__ __forceinline__ double pow2(int e) {
  return __longlong_as_double((long long)(e + 1023) << 52);
}

// the product p into the int64 sum a (finite) or the float sum f (not)
__device__ __forceinline__ void take(float p, double scale, long long& a, float& f) {
  if (isfinite(p))
    a += __double2ll_rn(__dmul_rn((double)p, scale));
  else
    f += p;
}

__device__ __forceinline__ void add_sums(int64_t* acc, float* d_op, long long a, float f) {
  if (a != 0)
    atomicAdd(reinterpret_cast<unsigned long long*>(acc), (unsigned long long)a);
  if (f != 0.0f) atomicAdd(d_op, f);  // NaN != 0 too
}

__global__ void __launch_bounds__(kThreads) finite_max_kernel(
    const float* __restrict__ g, unsigned* __restrict__ top, int N) {
  const long long row = blockIdx.x;  // (b, c)
  const float* gr = g + row * N;
  const int end = min(N, (int)blockIdx.y * kMaxChunk + kMaxChunk);
  unsigned m = 0;
  for (int n = blockIdx.y * kMaxChunk + threadIdx.x; n < end; n += kThreads) {
    const unsigned bits = __float_as_uint(gr[n]) & 0x7fffffffu;
    if (bits < 0x7f800000u) m = max(m, bits);  // finite
  }
  m = __reduce_max_sync(0xffffffffu, m);
  if ((threadIdx.x & 31) == 0 && m != 0) atomicMax(top + row, m);
}

template <int VEC>
__global__ void __launch_bounds__(kTileW * kMaxRows) splat_twohot_kernel(
    const float* __restrict__ g, const int* __restrict__ v0,
    const float* __restrict__ dv, const int* __restrict__ u0,
    const float* __restrict__ du, float* __restrict__ d_op,
    int64_t* __restrict__ acc, const unsigned* __restrict__ top, int H, int W,
    int C, int N, int log2n, int capacity) {
  extern __shared__ float4 smem[];
  __shared__ int partial[4][kMaxRows];
  const int lane = threadIdx.x, warp = threadIdx.y;
  const int nwarps = blockDim.y;
  const int S = kTileW * nwarps;
  const int t = warp * kTileW + lane;  // this thread's sample in the tile
  const int b = blockIdx.z;
  const int x = blockIdx.x * kTileW + lane;
  const long long n = (long long)(blockIdx.y * nwarps + warp) * W + x;
  const bool live = x < W && n < N;
  float4* weights = smem;                                   // [S] w00, w01, w10, w11
  double* scales = reinterpret_cast<double*>(weights + S);  // [C] 2^s of each channel
  int2* starts = reinterpret_cast<int2*>(scales + C);       // [S] (v0, u0), -1 if not live
  int* next = reinterpret_cast<int*>(starts + S);           // [S] next sample of a cell's list
  float* gs = reinterpret_cast<float*>(next + S);           // [S][C] the tile's cotangent
  int* head = reinterpret_cast<int*>(gs + S * C);           // [capacity] first sample of a cell
  const long long base = (long long)b * H * W * C;
  float* plane = d_op + base;
  int64_t* sums = acc + base;

  for (int c = t; c < C; c += S) scales[c] = pow2(fixed_shift(top[b * C + c], log2n));
  int vi = -1, ui = -1;
  int vlo = INT_MAX, vhi = INT_MIN, ulo = INT_MAX, uhi = INT_MIN;
  if (live) {
    const long long i = (long long)b * N + n;
    vi = min(max(v0[i], 0), H - 2);
    ui = min(max(u0[i], 0), W - 2);
    const float fv = dv[i];
    const float fu = du[i];
    const float omu = 1.0f - fu, omv = 1.0f - fv;
    weights[t] = make_float4(__fmul_rn(omu, omv), __fmul_rn(fu, omv), __fmul_rn(omu, fv),
                             __fmul_rn(fu, fv));
    const float* gt = g + (long long)b * C * N + n;
    for (int c = 0; c < C; ++c) gs[t * C + c] = gt[(long long)c * N];
    vlo = vhi = vi;
    ulo = uhi = ui;
  }
  starts[t] = make_int2(vi, ui);
  // the tile's corner box: a warp reduction, then one over the warps
  vlo = __reduce_min_sync(0xffffffffu, vlo);
  vhi = __reduce_max_sync(0xffffffffu, vhi);
  ulo = __reduce_min_sync(0xffffffffu, ulo);
  uhi = __reduce_max_sync(0xffffffffu, uhi);
  if (lane == 0) {
    partial[0][warp] = vlo;
    partial[1][warp] = vhi;
    partial[2][warp] = ulo;
    partial[3][warp] = uhi;
  }
  __syncthreads();
  for (int w = 0; w < nwarps; ++w) {
    vlo = min(vlo, partial[0][w]);
    vhi = max(vhi, partial[1][w]);
    ulo = min(ulo, partial[2][w]);
    uhi = max(uhi, partial[3][w]);
  }
  if (vlo == INT_MAX) return;  // a ragged tile past the last sample
  const int rows = vhi - vlo + 2, cols = uhi - ulo + 2;
  // k walks (item, channels j*VEC ..) with consecutive lanes; the item and
  // j advance by S / CV and S % CV a step, without a division
  const int CV = C / VEC;
  const int ds = S / CV, dj = S - ds * CV;

  if ((long long)rows * cols <= capacity) {  // the same for the whole CTA
    for (int k = t; k < rows * cols; k += S) head[k] = -1;
    __syncthreads();
    if (live) next[t] = atomicExch(&head[(vi - vlo) * cols + (ui - ulo)], t);
    __syncthreads();
    const int items = rows * cols * CV;
    int cell = t / CV, j = t - cell * CV;
    for (int k = t; k < items; k += S) {
      const int y = cell / cols, cx = cell - y * cols;
      const double s0 = scales[j * VEC];
      const double s1 = VEC == 2 ? scales[j * VEC + 1] : 0.0;
      long long a0 = 0, a1 = 0;
      float f0 = 0.0f, f1 = 0.0f;
#pragma unroll
      for (int q = 0; q < 4; ++q) {  // corner q = 00, 01, 10, 11 of the contributor
        const int sy = y - (q >> 1), sx = cx - (q & 1);
        if (sy < 0 || sx < 0) continue;
        for (int p = head[sy * cols + sx]; p >= 0; p = next[p]) {
          const float4 wp = weights[p];
          const float w = q == 0 ? wp.x : q == 1 ? wp.y : q == 2 ? wp.z : wp.w;
          if (VEC == 2) {
            const float2 gv = *reinterpret_cast<const float2*>(gs + p * C + j * 2);
            take(__fmul_rn(gv.x, w), s0, a0, f0);
            take(__fmul_rn(gv.y, w), s1, a1, f1);
          } else {
            take(__fmul_rn(gs[p * C + j], w), s0, a0, f0);
          }
        }
      }
      const long long o = ((long long)(vlo + y) * W + ulo + cx) * C + j * VEC;
      add_sums(sums + o, plane + o, a0, f0);
      if (VEC == 2) add_sums(sums + o + 1, plane + o + 1, a1, f1);
      cell += ds;
      j += dj;
      if (j >= CV) {
        j -= CV;
        ++cell;
      }
    }
    return;
  }

  const int WC = W * C;
  const int corner[4] = {0, C, WC, WC + C};
  int p = t / CV, j = t - p * CV;
  for (int k = t; k < S * CV; k += S) {
    const int2 st = starts[p];
    if (st.x >= 0) {
      const float4 w4 = weights[p];
      const float w[4] = {w4.x, w4.y, w4.z, w4.w};
      const long long o = ((long long)st.x * W + st.y) * C + j * VEC;
#pragma unroll
      for (int v = 0; v < VEC; ++v) {
        const float gv = gs[p * C + j * VEC + v];
        const double sc = scales[j * VEC + v];
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          long long a = 0;
          float f = 0.0f;
          take(__fmul_rn(gv, w[q]), sc, a, f);
          add_sums(sums + o + corner[q] + v, plane + o + corner[q] + v, a, f);
        }
      }
    }
    p += ds;
    j += dj;
    if (j >= CV) {
      j -= CV;
      ++p;
    }
  }
}

// d_op = acc * 2^-s rounded to float32, where d_op holds no non-finite sum
__global__ void __launch_bounds__(kThreads) convert_kernel(
    const int64_t* __restrict__ acc, float* __restrict__ d_op,
    const unsigned* __restrict__ top, int C, int per_image, int log2n) {
  const int b = blockIdx.y;
  const long long base = (long long)b * per_image;
  for (int i = blockIdx.x * kThreads + threadIdx.x; i < per_image; i += gridDim.x * kThreads) {
    if (d_op[base + i] != 0.0f) continue;  // NaN or Inf: it stays
    const int c = i % C;
    const double unscale = pow2(-fixed_shift(top[b * C + c], log2n));
    d_op[base + i] = __double2float_rn(__dmul_rn(__ll2double_rn(acc[base + i]), unscale));
  }
}

template <int VEC>
int launch(const SplatArgs& a, int tile_h, size_t shared, int log2n) {
  static size_t opted_in = 48 * 1024;  // dynamic shared memory allowed so far
  if (shared > opted_in) {
    const cudaError_t e = cudaFuncSetAttribute(
        splat_twohot_kernel<VEC>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)shared);
    if (e != cudaSuccess) return (int)e;
    opted_in = shared;
  }
  const int sample_rows = (int)((a.N + (long long)a.W - 1) / a.W);
  const dim3 block(kTileW, tile_h);
  const dim3 grid((a.W + kTileW - 1) / kTileW, (sample_rows + tile_h - 1) / tile_h, a.B);
  splat_twohot_kernel<VEC><<<grid, block, shared, (cudaStream_t)a.stream>>>(
      a.g, a.v0, a.dv, a.u0, a.du, a.d_op, a.acc, a.top, a.H, a.W, a.C, a.N, log2n,
      a.capacity);
  return (int)cudaGetLastError();
}

}  // namespace

// Zeroes d_op, acc and top, then takes the maxima, splats and converts.
// Returns the first cudaError_t: cudaErrorInvalidValue for a negative
// capacity, or a tile and box that do not fit shared memory (C > ~1600).
extern "C" int splat_twohot_launch(const SplatArgs* a) {
  const cudaStream_t st = (cudaStream_t)a->stream;
  const size_t cells = (size_t)a->B * a->H * a->W * a->C;
  cudaError_t err = cudaMemsetAsync(a->d_op, 0, cells * sizeof(float), st);
  if (err != cudaSuccess || a->B == 0 || a->N == 0 || a->C == 0) return (int)err;
  if (a->capacity < 0) return (int)cudaErrorInvalidValue;
  const int tile_h = a->C <= 32 ? kMaxRows : 1;
  const size_t shared = shared_bytes(tile_h, a->C, a->capacity);
  if (shared > kMaxShared) return (int)cudaErrorInvalidValue;
  err = cudaMemsetAsync(a->acc, 0, cells * sizeof(int64_t), st);
  if (err == cudaSuccess)
    err = cudaMemsetAsync(a->top, 0, (size_t)a->B * a->C * sizeof(unsigned), st);
  if (err != cudaSuccess) return (int)err;
  const int log2n = a->N > 1 ? 32 - __builtin_clz((unsigned)(a->N - 1)) : 0;

  finite_max_kernel<<<dim3(a->B * a->C, (a->N + kMaxChunk - 1) / kMaxChunk), kThreads, 0, st>>>(
      a->g, a->top, a->N);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const int status = a->C % 2 == 0 ? launch<2>(*a, tile_h, shared, log2n)
                                   : launch<1>(*a, tile_h, shared, log2n);
  if (status != 0) return status;
  const int per_image = a->H * a->W * a->C;
  const int blocks = (int)((per_image + kThreads - 1) / kThreads);
  convert_kernel<<<dim3(blocks < 8192 ? blocks : 8192, a->B), kThreads, 0, st>>>(
      a->acc, a->d_op, a->top, a->C, per_image, log2n);
  return (int)cudaGetLastError();
}

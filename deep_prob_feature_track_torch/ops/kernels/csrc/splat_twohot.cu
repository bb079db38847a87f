// Adjoint of the bilinear sample: splat an output cotangent back onto the
// channels-last plane it was sampled from.
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
// in VMEM across a sequential grid.  Hopper has no sequential grid, and what
// a splat costs here is the float adds that reach L2: one thread per
// (sample, channel) sends 4*C adds a sample, and each warp-wide atomic
// scatters over 32 cells.  Shared-memory float atomics do not help: sm_90
// has none, and compiles atomicAdd on shared memory into a compare-and-swap
// loop.  So this kernel merges the adds of neighbouring samples before they
// leave the CTA, with integer shared atomics only:
//
// 1. The samples are read as rows of W (the tracker's warps sample the plane
//    at its own size, so sample (r, x) lands near cell (r, x); for any other
//    N the view is only a grouping).  A CTA of tile_h x 32 threads takes a
//    tile_h x 32 tile of them (tile_h = 8 for C <= 32, else 1, so the staged
//    cotangent stays small), one warp per row, loads its coordinates
//    coalesced, clamps the corner starts to [0, size-2], puts each sample's
//    four corner weights in shared memory, stages g[b, :, tile] there
//    (loaded coalesced over n, the [B,C,N] layout the autograd backward hands
//    over) and reduces the tile's corner box [vmin, vmax+1] x [umin, umax+1].
// 2. Staged, when the box has at most `capacity` cells: each sample pushes
//    itself onto the list of its 00 cell (atomicExch on an int, native in
//    shared memory).  Then each (cell, channel) of the box sums its
//    contributors -- the lists of cells (y, x), (y, x-1), (y-1, x) and
//    (y-1, x-1), with their 00, 01, 10 and 11 weights -- and adds the sum to
//    the plane with one global atomic (neighbouring tiles' boxes overlap);
//    consecutive lanes take consecutive channels and cells.  Under a smooth
//    warp an 8 x 32 tile's 256 samples reach ~300 cells: ~3.4x fewer adds,
//    in whole sectors.
// 3. Global, otherwise: the CTA walks the flattened k = s*C + c of its
//    samples with consecutive lanes and adds straight into the plane, so a
//    warp-wide atomic covers ~32/C samples' contiguous channel runs.
//
// The choice is made per CTA, inside the launch, with no host sync.  Where C
// is even a lane takes two channels (VEC = 2) and the global atomics are
// sm_90's float2 vector atomics.
//
// Bound: bytes (the cotangent, four coordinate arrays, and the plane written
// once), which the launch function's memset and the atomics' read-modify-
// write in L2 exceed; the arithmetic is 12 flops per (sample, channel).
//
// Atomic adds take the tiles in an order that changes from run to run, so
// the result agrees with the plain version within a tolerance, not bit for
// bit.  Each added value is g times the corner weight, the product the plain
// version adds, or a sum of such products.

#include <climits>
#include <cstdint>
#include <cuda_runtime.h>

// The launch function's one argument; ops/kernels/splat.py packs it with
// the struct format "6P6iP" (native layout).
struct SplatArgs {
  const float* g;  // [B,C,N]
  const int* v0;   // [B,N]
  const float* dv;
  const int* u0;
  const float* du;
  float* d_op;  // [B,H,W,C], zeroed by the launch function
  int B, H, W, C, N;
  int capacity;  // corner-box cells a CTA may stage
  void* stream;
};

namespace {

constexpr int kTileW = 32;   // one warp per tile row
constexpr int kMaxRows = 8;  // tile rows for C <= 32: 256 threads per CTA
constexpr size_t kMaxShared = 227 * 1024;

size_t shared_bytes(int tile_h, int C, int capacity) {
  const size_t S = (size_t)tile_h * kTileW;
  return S * (sizeof(float4) + sizeof(int2) + sizeof(int) + sizeof(float) * C) +
         (size_t)capacity * sizeof(int);
}

template <int VEC>
__device__ __forceinline__ void add(float* dst, float a0, float a1) {
  if (VEC == 2)
    atomicAdd(reinterpret_cast<float2*>(dst), make_float2(a0, a1));
  else
    atomicAdd(dst, a0);
}

template <int VEC>
__global__ void __launch_bounds__(kTileW * kMaxRows) splat_twohot_kernel(
    const float* __restrict__ g, const int* __restrict__ v0,
    const float* __restrict__ dv, const int* __restrict__ u0,
    const float* __restrict__ du, float* __restrict__ d_op, int H, int W,
    int C, int N, int capacity) {
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
  float4* weights = smem;                               // [S] w00, w01, w10, w11
  int2* starts = reinterpret_cast<int2*>(weights + S);  // [S] (v0, u0), -1 if not live
  int* next = reinterpret_cast<int*>(starts + S);       // [S] next sample of a cell's list
  float* gs = reinterpret_cast<float*>(next + S);       // [S][C] the tile's cotangent
  int* head = reinterpret_cast<int*>(gs + S * C);       // [capacity] first sample of a cell
  float* plane = d_op + (long long)b * H * W * C;

  int vi = -1, ui = -1;
  int vlo = INT_MAX, vhi = INT_MIN, ulo = INT_MAX, uhi = INT_MIN;
  if (live) {
    const long long i = (long long)b * N + n;
    vi = min(max(v0[i], 0), H - 2);
    ui = min(max(u0[i], 0), W - 2);
    const float fv = dv[i];
    const float fu = du[i];
    const float omu = 1.0f - fu, omv = 1.0f - fv;
    weights[t] = make_float4(omu * omv, fu * omv, omu * fv, fu * fv);
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
      float a0 = 0.0f, a1 = 0.0f;
      bool any = false;
#pragma unroll
      for (int q = 0; q < 4; ++q) {  // corner q = 00, 01, 10, 11 of the contributor
        const int sy = y - (q >> 1), sx = cx - (q & 1);
        if (sy < 0 || sx < 0) continue;
        for (int p = head[sy * cols + sx]; p >= 0; p = next[p]) {
          const float4 wp = weights[p];
          const float w = q == 0 ? wp.x : q == 1 ? wp.y : q == 2 ? wp.z : wp.w;
          if (VEC == 2) {
            const float2 gv = *reinterpret_cast<const float2*>(gs + p * C + j * 2);
            a0 += gv.x * w;
            a1 += gv.y * w;
          } else {
            a0 += gs[p * C + j] * w;
          }
          any = true;
        }
      }
      if (any) add<VEC>(plane + ((long long)(vlo + y) * W + ulo + cx) * C + j * VEC, a0, a1);
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
  int p = t / CV, j = t - p * CV;
  for (int k = t; k < S * CV; k += S) {
    const int2 st = starts[p];
    if (st.x >= 0) {
      const float4 w = weights[p];
      float* q = plane + ((long long)st.x * W + st.y) * C + j * VEC;
      const float g0 = gs[p * C + j * VEC];
      const float g1 = VEC == 2 ? gs[p * C + j * VEC + 1] : 0.0f;
      add<VEC>(q, g0 * w.x, g1 * w.x);
      add<VEC>(q + C, g0 * w.y, g1 * w.y);
      add<VEC>(q + WC, g0 * w.z, g1 * w.z);
      add<VEC>(q + WC + C, g0 * w.w, g1 * w.w);
    }
    p += ds;
    j += dj;
    if (j >= CV) {
      j -= CV;
      ++p;
    }
  }
}

template <int VEC>
int launch(const SplatArgs& a, int tile_h, size_t shared) {
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
      a.g, a.v0, a.dv, a.u0, a.du, a.d_op, a.H, a.W, a.C, a.N, a.capacity);
  return (int)cudaGetLastError();
}

}  // namespace

// Zeroes d_op, then splats.  Returns the first cudaError_t:
// cudaErrorInvalidValue for a negative capacity, or a tile and box that do
// not fit shared memory (C > ~1700).
extern "C" int splat_twohot_launch(const SplatArgs* a) {
  const cudaStream_t st = (cudaStream_t)a->stream;
  const size_t plane = (size_t)a->B * a->H * a->W * a->C * sizeof(float);
  cudaError_t err = cudaMemsetAsync(a->d_op, 0, plane, st);
  if (err != cudaSuccess || a->B == 0 || a->N == 0 || a->C == 0) return (int)err;
  if (a->capacity < 0) return (int)cudaErrorInvalidValue;
  const int tile_h = a->C <= 32 ? kMaxRows : 1;
  const size_t shared = shared_bytes(tile_h, a->C, a->capacity);
  if (shared > kMaxShared) return (int)cudaErrorInvalidValue;
  if (a->C % 2 == 0 && reinterpret_cast<uintptr_t>(a->d_op) % 8 == 0)
    return launch<2>(*a, tile_h, shared);
  return launch<1>(*a, tile_h, shared);
}

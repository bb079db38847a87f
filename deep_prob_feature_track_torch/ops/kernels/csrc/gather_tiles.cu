// Bilinear sample of a channels-last plane on a 2-D sample grid, staged per
// output tile: K4 (gather_tiles, GRADS = false) and K5 (gather_tiles_grads,
// GRADS = true).
//
// Replaces the Pallas TPU kernels gather_tiles and gather_tiles_grads
// (deep_prob_feature_track_tpu/ops/pallas/gather_tiles.py:177 _kernel,
// entries :481 and :504).  The function is K1's and, with GRADS, K2's (both
// csrc/gather_twohot.cu):
//
//   out = c00 (1-du)(1-dv) + c01 du (1-dv) + c10 (1-du) dv + c11 du dv
//   gx  = (c01 - c00)(1-dv) + (c11 - c10) dv
//   gy  = (c10 - c00)(1-du) + (c11 - c01) du
//
// with cYX = F[b, v0+Y, u0+X, c], sampled on a [B, Hs, Ws] grid and written
// to [B, C, Hs*Ws] in raster order.
//
// The TPU kernel bets on spatial locality: the samples of a 16x16 output tile
// read a small band of the plane.  It reorders the samples into tiles, DMAs a
// 64x64 slab per tile into VMEM and contracts two-hot matrices on the MXU in
// bf16 hi/lo passes; one tile out of its band sends the whole call to XLA.
// This kernel keeps the bet and none of the mechanism.  One CTA of
// tile_h x 32 threads takes one tile of the raster sample grid in place (one
// warp per tile row, so coordinate loads and output stores are coalesced;
// the ragged edge is masked).  It clamps each start to [0, size-2], as K1
// does, so a start that came from a NaN never widens the box or reads
// outside the plane, and reduces the tile's corner box
// [vmin, vmax+1] x [umin, umax+1] with warp shuffles.  The decision is per
// tile, inside the kernel, with no host sync:
//
// - staged: when rows * cols * C floats fit the dynamic shared memory the
//   launch gives, the warps copy the box into shared memory, one contiguous
//   cols*C run per row, coalesced; after a barrier each thread blends its
//   sample from shared memory.  The wrapper gives 6656 floats (26 KB), so
//   an SM's 228 KB hold eight CTAs of 8x32 threads (ptxas gives the kernel
//   48 registers a thread, which hold five).  An 8x32 tile near identity
//   motion spans about 10 x 34 cells: 13.6 KB at C=10, 23 KB at C=17.
// - global: otherwise the CTA reads its corners straight from device memory,
//   as K1 does.  A tile that leaves its box costs speed, never accuracy.
//
// Bound: bytes.  Each input read once and each output written once, at
// 3.35 TB/s: K4 at 8x480x640, C=10 moves 235.9 MB (70.4 us); K5 at
// 4x480x640, C=10 moves 216.3 MB (64.6 us) and at 4x240x320 54.1 MB
// (16.1 us).  The arithmetic is 7 flops per output value (15 with GRADS).
// The design reads the plane about once from device memory (neighbouring
// tiles' boxes overlap by a row or two, which L2 serves), reads the
// coordinates and writes the outputs in 128-byte warp transactions, and
// replaces K1's 4*C scattered loads per sample with shared-memory loads.
//
// Every path evaluates exactly K1's and K2's order of operations with
// round-to-nearest intrinsics that the compiler never contracts into FMAs, so
// `out` is bit-identical to K1 and to the plain version whichever path a tile
// took: the tracker masks pixels whose warped sigma equals the batch-global
// min/max exactly.  gx and gy are K2's, in the same way.

#include <climits>
#include <cuda_runtime.h>

// The launch functions' one argument; ops/kernels/tiles.py packs it with the
// struct format "8P8iP" (native layout).
struct TilesArgs {
  const float* F;  // [B,H,W,C]
  const int* v0;   // [B,Hs,Ws]
  const float* dv;
  const int* u0;
  const float* du;
  float* out;  // [B,C,Hs*Ws], as gx and gy (GRADS only)
  float* gx;
  float* gy;
  int B, H, W, C, Hs, Ws;
  int tile_h;    // rows of 32 samples per CTA
  int capacity;  // floats of shared memory per CTA
  void* stream;
};

namespace {

constexpr int kTileW = 32;  // one warp per tile row
constexpr int kMaxWarps = 8;  // rows per tile: at most 256 threads per CTA

// Blend one sample's C channels from its corner rows p0 (v0) and p1 (v0+1),
// each pointing at the u0 corner, and store them at o, o + N, ...
template <bool GRADS>
__device__ __forceinline__ void blend(const float* p0, const float* p1, int C,
                                      float fu, float fv, long long o,
                                      long long N, float* __restrict__ out,
                                      float* __restrict__ gx,
                                      float* __restrict__ gy) {
  const float omu = __fsub_rn(1.0f, fu);
  const float omv = __fsub_rn(1.0f, fv);
  for (int c = 0; c < C; ++c) {
    const float c00 = p0[c], c01 = p0[C + c], c10 = p1[c], c11 = p1[C + c];
    float r = __fmul_rn(__fmul_rn(c00, omu), omv);
    r = __fadd_rn(r, __fmul_rn(__fmul_rn(c01, fu), omv));
    r = __fadd_rn(r, __fmul_rn(__fmul_rn(c10, omu), fv));
    r = __fadd_rn(r, __fmul_rn(__fmul_rn(c11, fu), fv));
    const long long i = o + (long long)c * N;
    out[i] = r;
    if (GRADS) {
      gx[i] = __fadd_rn(__fmul_rn(__fsub_rn(c01, c00), omv),
                        __fmul_rn(__fsub_rn(c11, c10), fv));
      gy[i] = __fadd_rn(__fmul_rn(__fsub_rn(c10, c00), omu),
                        __fmul_rn(__fsub_rn(c11, c01), fu));
    }
  }
}

template <bool GRADS>
__global__ void __launch_bounds__(kTileW * kMaxWarps) gather_tiles_kernel(
    const float* __restrict__ F, const int* __restrict__ v0,
    const float* __restrict__ dv, const int* __restrict__ u0,
    const float* __restrict__ du, float* __restrict__ out,
    float* __restrict__ gx, float* __restrict__ gy, int H, int W, int C, int Hs,
    int Ws, int capacity) {
  extern __shared__ float box[];
  __shared__ int partial[4][kMaxWarps];

  const int lane = threadIdx.x;  // blockDim.x == kTileW
  const int warp = threadIdx.y;
  const int nwarps = blockDim.y;
  const int x = blockIdx.x * kTileW + lane;
  const int y = blockIdx.y * blockDim.y + warp;
  const int b = blockIdx.z;
  const long long N = (long long)Hs * Ws;
  const bool live = x < Ws && y < Hs;

  int vi = 0, ui = 0;
  float fv = 0.0f, fu = 0.0f;
  int vlo = INT_MAX, vhi = INT_MIN, ulo = INT_MAX, uhi = INT_MIN;
  if (live) {
    const long long s = (long long)b * N + (long long)y * Ws + x;
    vi = min(max(v0[s], 0), H - 2);
    ui = min(max(u0[s], 0), W - 2);
    fv = dv[s];
    fu = du[s];
    vlo = vhi = vi;
    ulo = uhi = ui;
  }

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
  // thread (0, 0) is always live, so the box is never empty
  const int rows = vhi - vlo + 2;
  const int run = (uhi - ulo + 2) * C;  // floats of one box row

  const long long o = (long long)b * C * N + (long long)y * Ws + x;
  if ((long long)rows * run <= capacity) {  // the same for the whole CTA
    const float* src = F + (((long long)b * H + vlo) * W + ulo) * C;
    for (int r = warp; r < rows; r += nwarps) {
      const float* row = src + (long long)r * W * C;
      float* dst = box + r * run;
      for (int k = lane; k < run; k += kTileW) dst[k] = row[k];
    }
    __syncthreads();
    if (live) {
      const float* p0 = box + (vi - vlo) * run + (ui - ulo) * C;
      blend<GRADS>(p0, p0 + run, C, fu, fv, o, N, out, gx, gy);
    }
  } else if (live) {
    const float* p0 = F + (((long long)b * H + vi) * W + ui) * C;
    blend<GRADS>(p0, p0 + (long long)W * C, C, fu, fv, o, N, out, gx, gy);
  }
}

template <bool GRADS>
int launch(const TilesArgs& a) {
  if (a.B == 0 || a.Hs == 0 || a.Ws == 0) return 0;
  if (a.tile_h < 1 || a.tile_h > kMaxWarps || a.capacity < 0 ||
      a.capacity > 48 * 1024 / (int)sizeof(float))
    return (int)cudaErrorInvalidValue;
  static bool carveout_set = false;
  if (!carveout_set) {
    // ask for the largest shared-memory carveout: several 30 KB CTAs per SM
    const cudaError_t e = cudaFuncSetAttribute(
        gather_tiles_kernel<GRADS>,
        cudaFuncAttributePreferredSharedMemoryCarveout,
        (int)cudaSharedmemCarveoutMaxShared);
    if (e != cudaSuccess) return (int)e;
    carveout_set = true;
  }
  const dim3 block(kTileW, a.tile_h);
  const dim3 grid((a.Ws + kTileW - 1) / kTileW, (a.Hs + a.tile_h - 1) / a.tile_h, a.B);
  gather_tiles_kernel<GRADS><<<grid, block, (size_t)a.capacity * sizeof(float),
                               (cudaStream_t)a.stream>>>(
      a.F, a.v0, a.dv, a.u0, a.du, a.out, a.gx, a.gy, a.H, a.W, a.C, a.Hs, a.Ws,
      a.capacity);
  return (int)cudaGetLastError();
}

}  // namespace

// Returns the cudaError_t of the launch (gx, gy unused).
extern "C" int gather_tiles_launch(const TilesArgs* a) { return launch<false>(*a); }

// As gather_tiles_launch, with the derivative maps gx, gy.
extern "C" int gather_tiles_grads_launch(const TilesArgs* a) { return launch<true>(*a); }

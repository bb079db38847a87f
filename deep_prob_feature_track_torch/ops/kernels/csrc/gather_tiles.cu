// Bilinear sample of a channels-last plane on a 2-D sample grid, staged per
// output tile: K4 (gather_tiles) and K5 (gather_tiles_grads).
//
// Replaces the Pallas TPU kernels gather_tiles and gather_tiles_grads
// (deep_prob_feature_track_tpu/ops/pallas/gather_tiles.py:177 _kernel,
// entries :481 and :504).  The function is K1's and, for K5, K2's (both
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
// These kernels keep the bet and none of the mechanism.  Each takes the
// raster sample grid in tiles of tile_h x 32 samples in place, one warp per
// tile row, so coordinate loads and output stores are coalesced 128-byte
// transactions and the ragged edge is masked.  Each clamps every start to
// [0, size-2], as K1 does, so a start that came from a NaN never widens the
// box or reads outside the plane, and reduces the tile's corner box
// [vmin, vmax+1] x [umin, umax+1] with warp reductions.  The decision is per
// tile, inside the kernel, with no host sync:
//
// - staged: the box fits the shared memory the tile is given (K4: it lies
//   in the window that K4 copies); it is copied there and the samples blend
//   from shared memory.
// - global: otherwise the tile reads its corners straight from device
//   memory, as K1 does.  A tile that leaves its box costs speed, never
//   accuracy.
//
// K4 (ring::gather_tiles_ring_kernel) is designed for Hopper's asynchronous
// copies.  Measured on the H100, a tile-at-a-time CTA that copies and then
// blends is bound by latency: each cp.async.bulk request holds the SM's copy
// engine a fixed time whatever its size, a single warp that reduces the box
// and issues the copies serialises the tile, and barriers across the CTA
// expose every wait.  So:
// - Persistent CTAs.  One CTA of 17 warps per SM walks tiles blockIdx.x,
//   blockIdx.x + grid, ... of the raster order (a cursor steps through them
//   without a division), so neighbouring SMs take neighbouring tiles at the
//   same time and the rows their boxes share come from L2.
// - Warp roles.  Consumer warp w owns row w of every tile (tile_h <= 16
//   rows of 32 samples): it loads its samples' coordinates with 4-byte
//   cp.async into its own ring in shared memory kLoadAhead tiles ahead,
//   reduces its row's corner box kLead tiles ahead and publishes it on the
//   stage's `ready` mbarrier, then waits on `full`, blends, stores and
//   arrives on `empty`.  One producer warp combines the 16 row boxes,
//   decides the tile's path and issues its copy.  No __syncthreads in the
//   loop: every hand-over is an mbarrier.
// - A ring of kStages box buffers in dynamic shared memory (44 KB each;
//   with the coordinate rings a CTA takes 217 KB), filled asynchronously
//   kLead tiles ahead of the blend by one TMA tensor copy each
//   (cp.async.bulk.tensor over the plane viewed as [B*H][W*C/32][32]
//   floats, 128-byte inner units) of a fixed window: tile_h + 3 rows by the
//   128-byte chunks that 35 cells can span, from the chunk that holds the
//   box's first float.  A tile stages when its box lies inside that window;
//   the copy completes on the stage's `full` mbarrier with the window's
//   bytes.  A plane whose rows are not whole chunks has no window, and all
//   its tiles take the global path.
// - Taller tiles.  tile_h is 16 where the window of a 16-row tile fits a
//   buffer (C <= 15), else 8, 4, 2 or 1 (ops/kernels/tiles.py::tile_rows).
//   The window holds the box of a tile whose starts move by at most 2 cells
//   across it, down and across: smooth flow near identity motion, where a
//   16 x 32 tile's box spans ~19 x 35 cells, 1.3x its samples (an 8 x 32
//   tile's 11 x 35, 1.5x).  32 x 32 tiles would need 47 KB boxes at
//   C = 10, so fewer stages.  A larger motion gradient (a zoom, a fast
//   rotation) or a teleported sample sends the tile to the global path.
// - A conflict-free blend.  Where C is even (and the plane 8-byte aligned)
//   a lane reads channel pairs as float2: neighbouring lanes sit C/2 eight-
//   byte words apart, an odd stride at C = 6 and 10, so a half-warp hits 16
//   distinct bank pairs; where C is odd, single floats at an odd stride.
//   Coordinates are loaded and outputs stored one warp per tile row, in
//   128-byte transactions.
//
// K5 (gather_tiles_kernel<true>) keeps the first design: one CTA of
// tile_h x 32 threads per 8 x 32 tile, a synchronous copy of the box by the
// warps (one contiguous cols*C run per row, coalesced), a barrier, then the
// blend.  The wrapper gives it 6656 floats (26 KB) of shared memory, and
// ptxas gives the kernel 48 registers a thread, so an SM holds five CTAs.
//
// Bound: bytes.  Each input read once and each output written once, at
// 3.35 TB/s: K4 at 8x480x640 moves 235.9 MB at C = 10 (70.4 us) and
// 157.3 MB at C = 6 (47.0 us); K5 at 4x480x640, C=10 moves 216.3 MB
// (64.6 us) and at 4x240x320 54.1 MB (16.1 us).  The arithmetic is 7 flops
// per output value (15 for K5).  The plane is read about once from device
// memory (neighbouring boxes overlap by a row or two, which L2 serves).
//
// Every path evaluates exactly K1's and K2's order of operations with
// round-to-nearest intrinsics that the compiler never contracts into FMAs, so
// `out` is bit-identical to K1 and to the plain version whichever path a tile
// took: the tracker masks pixels whose warped sigma equals the batch-global
// min/max exactly.  gx and gy are K2's, in the same way.
//
// K5's bf16 mode (the training mode bf16_residuals): gx and gy are stored as
// bfloat16, rounded once at the store with __float2bfloat16_rn (to nearest
// even), the bits of the float32 maps cast after, as K2's bf16 mode; a
// sample then writes 4 + 2 + 2 bytes a channel instead of 12.  K4 ignores
// the flag.

#include <climits>
#include <cstdint>
#include <cuda.h>
#include <cudaTypedefs.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

// The launch functions' one argument; ops/kernels/tiles.py packs it with the
// struct format "8P9iP" (native layout).
struct TilesArgs {
  const float* F;  // [B,H,W,C]
  const int* v0;   // [B,Hs,Ws]
  const float* dv;
  const int* u0;
  const float* du;
  float* out;  // [B,C,Hs*Ws], as gx and gy (K5 only)
  void* gx;    // float, or __nv_bfloat16 where bf16
  void* gy;
  int B, H, W, C, Hs, Ws;
  int tile_h;    // rows of 32 samples per tile
  int capacity;  // floats of shared memory per box (K4: per ring buffer)
  int bf16;      // K5: store gx and gy as bfloat16
  void* stream;
};

// ------------------------------------------------------------------- K5

namespace {

constexpr int kTileW = 32;  // one warp per tile row
constexpr int kMaxWarps = 8;  // rows per tile: at most 256 threads per CTA

// a derivative map's store: float as it is, bfloat16 rounded to nearest even
__device__ __forceinline__ void put(float* p, float x) { *p = x; }
__device__ __forceinline__ void put(__nv_bfloat16* p, float x) { *p = __float2bfloat16_rn(x); }

// Blend one sample's C channels from its corner rows p0 (v0) and p1 (v0+1),
// each pointing at the u0 corner, and store them at o, o + N, ...
template <bool GRADS, typename G>
__device__ __forceinline__ void blend(const float* p0, const float* p1, int C,
                                      float fu, float fv, long long o,
                                      long long N, float* __restrict__ out,
                                      G* __restrict__ gx, G* __restrict__ gy) {
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
      put(gx + i, __fadd_rn(__fmul_rn(__fsub_rn(c01, c00), omv),
                            __fmul_rn(__fsub_rn(c11, c10), fv)));
      put(gy + i, __fadd_rn(__fmul_rn(__fsub_rn(c10, c00), omu),
                            __fmul_rn(__fsub_rn(c11, c01), fu)));
    }
  }
}

template <bool GRADS, typename G>
__global__ void __launch_bounds__(kTileW * kMaxWarps) gather_tiles_kernel(
    const float* __restrict__ F, const int* __restrict__ v0,
    const float* __restrict__ dv, const int* __restrict__ u0,
    const float* __restrict__ du, float* __restrict__ out,
    G* __restrict__ gx, G* __restrict__ gy, int H, int W, int C, int Hs,
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
      blend<GRADS, G>(p0, p0 + run, C, fu, fv, o, N, out, gx, gy);
    }
  } else if (live) {
    const float* p0 = F + (((long long)b * H + vi) * W + ui) * C;
    blend<GRADS, G>(p0, p0 + (long long)W * C, C, fu, fv, o, N, out, gx, gy);
  }
}

template <bool GRADS, typename G>
int launch(const TilesArgs& a) {
  if (a.B == 0 || a.Hs == 0 || a.Ws == 0) return 0;
  if (a.tile_h < 1 || a.tile_h > kMaxWarps || a.capacity < 0 ||
      a.capacity > 48 * 1024 / (int)sizeof(float))
    return (int)cudaErrorInvalidValue;
  static bool carveout_set = false;
  if (!carveout_set) {
    // ask for the largest shared-memory carveout: several 30 KB CTAs per SM
    const cudaError_t e = cudaFuncSetAttribute(
        gather_tiles_kernel<GRADS, G>,
        cudaFuncAttributePreferredSharedMemoryCarveout,
        (int)cudaSharedmemCarveoutMaxShared);
    if (e != cudaSuccess) return (int)e;
    carveout_set = true;
  }
  const dim3 block(kTileW, a.tile_h);
  const dim3 grid((a.Ws + kTileW - 1) / kTileW, (a.Hs + a.tile_h - 1) / a.tile_h, a.B);
  gather_tiles_kernel<GRADS, G><<<grid, block, (size_t)a.capacity * sizeof(float),
                                  (cudaStream_t)a.stream>>>(
      a.F, a.v0, a.dv, a.u0, a.du, a.out, static_cast<G*>(a.gx), static_cast<G*>(a.gy), a.H,
      a.W, a.C, a.Hs, a.Ws, a.capacity);
  return (int)cudaGetLastError();
}

}  // namespace

// ------------------------------------------------------------------- K4

namespace ring {

constexpr int kTileW = 32;                       // one warp per tile row
constexpr int kMaxRows = 16;                     // rows per tile at most
constexpr int kConsumers = kMaxRows;             // blending warps: one per tile row
constexpr int kThreads = (kConsumers + 1) * 32;  // and one producer warp
constexpr int kStages = 4;                       // box buffers
constexpr int kLead = kStages - 1;               // tiles between a box's reduction and its blend
constexpr int kLoadAhead = 1;                    // tiles between a coordinate load and its use
constexpr int kSlots = kLead + kLoadAhead + 1;   // a consumer warp's ring of coordinates
constexpr size_t kMaxShared = 227 * 1024;
constexpr unsigned kMaxPolls = 1u << 30;          // a barrier that never completes

// what the producer tells the consumers of a stage's tile: the window's
// first row and its first float in a plane row (-1: the tile takes the
// global path)
struct Header {
  int vlo, c0;
};

// dynamic shared memory: [kStages][capacity] box floats, [kStages] headers,
// the consumer warps' corner boxes of their rows [kStages][kConsumers], and
// their coordinates [kConsumers][kSlots][32] (v0, u0, dv, du)
size_t shared_bytes(int capacity) {
  return (size_t)kStages * capacity * sizeof(float) + kStages * sizeof(Header) +
         (size_t)kStages * kConsumers * sizeof(int4) +
         (size_t)kConsumers * kSlots * 32 * sizeof(int4);
}

__device__ __forceinline__ unsigned smem(const void* p) {
  return (unsigned)__cvta_generic_to_shared(p);
}

__device__ __forceinline__ void cp_async4(void* dst, const void* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(smem(dst)), "l"(src)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int PENDING>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(PENDING) : "memory");
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, unsigned count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem(bar)), "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(smem(bar)) : "memory");
}

// one arrival that also expects `bytes` of copies to complete on `bar`
__device__ __forceinline__ void mbar_expect(uint64_t* bar, unsigned bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(smem(bar)),
               "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void mbar_wait(uint64_t* bar, unsigned parity) {
  unsigned done, polls = 0;
  do {
    asm volatile(
        "{\n .reg .pred p;\n mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        " selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(smem(bar)), "r"(parity)
        : "memory");
    if (++polls == kMaxPolls) __trap();  // fail rather than hang
  } while (!done);
}

// one TMA copy of the window at (chunk q, row r) of the plane viewed as
// [B*H][W*C/32][32] floats
__device__ __forceinline__ void tensor_copy(void* dst, const CUtensorMap* map, int q, int r,
                                            uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.tile.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%3, %4, %5}], [%2];\n" ::"r"(smem(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem(bar)), "r"(0), "r"(q), "r"(r)
      : "memory");
}

__device__ __forceinline__ float mix(float c00, float c01, float c10, float c11, float fu,
                                     float fv, float omu, float omv) {
  float r = __fmul_rn(__fmul_rn(c00, omu), omv);
  r = __fadd_rn(r, __fmul_rn(__fmul_rn(c01, fu), omv));
  r = __fadd_rn(r, __fmul_rn(__fmul_rn(c10, omu), fv));
  return __fadd_rn(r, __fmul_rn(__fmul_rn(c11, fu), fv));
}

// Blend one sample's C channels from its corner rows p0 (v0) and p1 (v0+1),
// each pointing at the u0 corner, VEC channels a step; store them at o,
// o + N, ...
template <int VEC>
__device__ __forceinline__ void blend(const float* p0, const float* p1, int C, float fu,
                                      float fv, float* __restrict__ o, long long N) {
  const float omu = __fsub_rn(1.0f, fu);
  const float omv = __fsub_rn(1.0f, fv);
  if (VEC == 2) {
    for (int c = 0; c < C; c += 2) {
      const float2 a = *reinterpret_cast<const float2*>(p0 + c);
      const float2 e = *reinterpret_cast<const float2*>(p0 + C + c);
      const float2 f = *reinterpret_cast<const float2*>(p1 + c);
      const float2 h = *reinterpret_cast<const float2*>(p1 + C + c);
      o[c * N] = mix(a.x, e.x, f.x, h.x, fu, fv, omu, omv);
      o[(c + 1) * N] = mix(a.y, e.y, f.y, h.y, fu, fv, omu, omv);
    }
  } else {
    for (int c = 0; c < C; ++c)
      o[c * N] = mix(p0[c], p0[C + c], p1[c], p1[C + c], fu, fv, omu, omv);
  }
}

struct Grid {
  const float* F;
  const int* v0;
  const float* dv;
  const int* u0;
  const float* du;
  float* out;
  int B, H, W, C, Hs, Ws, tile_h, capacity;
  int tiles_x, tiles_y;  // tiles across and down an image
  int step_b, step_y, step_x;  // gridDim.x tiles as whole images, rows and columns of tiles
  long long N;
  int window_rows, window_chunks;  // the tensor map's box: 0 rows where there is none
};

// A tile of the CTA's walk: image b (past the last image after the last
// tile), first sample (y0, x0).  next() moves gridDim.x tiles on, with no
// division.
struct Cursor {
  int b, y0, x0;

  __device__ Cursor(const Grid& g, int j) {  // the CTA's j-th tile
    const int t = blockIdx.x + j * gridDim.x;
    const int per_image = g.tiles_x * g.tiles_y;
    b = t / per_image;
    const int ty = (t - b * per_image) / g.tiles_x;
    y0 = ty * g.tile_h;
    x0 = (t - b * per_image - ty * g.tiles_x) * kTileW;
  }
  __device__ bool live(const Grid& g) const { return b < g.B; }
  __device__ void next(const Grid& g) {
    x0 += g.step_x * kTileW;
    y0 += g.step_y * g.tile_h;
    if (x0 >= g.tiles_x * kTileW) {
      x0 -= g.tiles_x * kTileW;
      y0 += g.tile_h;
    }
    b += g.step_b;
    if (y0 >= g.tiles_y * g.tile_h) {
      y0 -= g.tiles_y * g.tile_h;
      ++b;
    }
  }
};

struct Ring {
  float* boxes;     // [kStages][capacity]
  Header* head;     // [kStages]
  int4* rows;       // [kStages][kConsumers] (vmin, vmax, umin, umax) of each warp's row
  int4* coords;     // [kConsumers][kSlots][32] each lane's (v0, u0, dv, du) bits
  uint64_t* ready;  // a stage's row boxes are published (kConsumers arrivals)
  uint64_t* full;   // its box has landed, or it takes the global path
  uint64_t* empty;  // its tile is blended (kConsumers arrivals)
};

// The producer warp: for each tile of this CTA, combine the consumer warps'
// row boxes into the tile's box and, when the box lies in the window that
// starts at its first row and at the 128-byte chunk of its first float,
// copy the window to a buffer with one TMA request.  The stage's header
// and its full barrier tell the consumers.
__device__ __forceinline__ void produce(const Grid& g, const CUtensorMap* map, const Ring& ring) {
  const int lane = threadIdx.x & 31;
  Cursor at(g, 0);
  for (int j = 0; at.live(g); ++j, at.next(g)) {
    const int b = at.b;
    const int s = j % kStages;
    const unsigned n = j / kStages;  // the stage's use
    mbar_wait(&ring.ready[s], n & 1);
    int4 r = lane < kConsumers ? ring.rows[s * kConsumers + lane]
                               : make_int4(INT_MAX, INT_MIN, INT_MAX, INT_MIN);
    const int vlo = __reduce_min_sync(0xffffffffu, r.x);  // row 0 of a tile always has samples
    const int vhi = __reduce_max_sync(0xffffffffu, r.y);
    const int ulo = __reduce_min_sync(0xffffffffu, r.z);
    const int uhi = __reduce_max_sync(0xffffffffu, r.w);
    const long long c0 = (long long)ulo * g.C & ~31LL;  // the window's first float in a row
    // the box's rows lie in the window's, its last float in its chunks (no
    // window: 0 rows)
    const bool staged = vhi - vlo + 2 <= g.window_rows &&
                        (long long)(uhi + 2) * g.C - c0 <= 32LL * g.window_chunks;

    if (n > 0) mbar_wait(&ring.empty[s], (n - 1) & 1);  // tile j - kStages is blended
    if (lane == 0) {
      ring.head[s] = Header{vlo, staged ? (int)c0 : -1};
      if (staged) {
        mbar_expect(&ring.full[s], 128u * g.window_rows * g.window_chunks);
        tensor_copy(ring.boxes + (size_t)s * g.capacity, map, (int)(c0 >> 5), b * g.H + vlo,
                    &ring.full[s]);
      } else {
        mbar_arrive(&ring.full[s]);
      }
    }
  }
}

// A consumer warp: row w of every tile of this CTA.  Its lanes bring their
// samples' coordinates into the warp's ring with 4-byte cp.async kLoadAhead
// tiles before the warp reduces their row's corner box, which it publishes
// kLead tiles before it blends them, so the producer's copy has kLead tiles
// to land.  For each tile the warp waits for its stage, blends from the
// staged box or from F, stores, and releases the stage.
template <int VEC>
__device__ __forceinline__ void consume(const Grid& g, const Ring& ring, int w) {
  const int lane = threadIdx.x & 31;
  const int C = g.C, H = g.H, W = g.W;
  int4* const mine = ring.coords + w * kSlots * 32 + lane;  // slot k at mine[32 * k]
  auto live = [&](const Cursor& at) {  // whether this lane has a sample in tile `at`
    return at.live(g) && w < g.tile_h && at.y0 + w < g.Hs && at.x0 + lane < g.Ws;
  };
  auto load = [&](const Cursor& at, int j) {  // its coordinates, one cp.async group
    if (live(at)) {
      const long long i = at.b * g.N + (long long)(at.y0 + w) * g.Ws + at.x0 + lane;
      int* c = reinterpret_cast<int*>(mine + 32 * (j % kSlots));
      cp_async4(c, g.v0 + i);
      cp_async4(c + 1, g.u0 + i);
      cp_async4(c + 2, g.dv + i);
      cp_async4(c + 3, g.du + i);
    }
    cp_async_commit();
  };
  auto publish = [&](const Cursor& at, int j) {  // the corner box of this row of the tile
    if (!at.live(g)) return;
    int vi = INT_MAX, vj = INT_MIN, ui = INT_MAX, uj = INT_MIN;
    if (live(at)) {
      const int4 c = mine[32 * (j % kSlots)];
      vi = vj = min(max(c.x, 0), H - 2);
      ui = uj = min(max(c.y, 0), W - 2);
    }
    const int4 r = make_int4(__reduce_min_sync(0xffffffffu, vi), __reduce_max_sync(0xffffffffu, vj),
                             __reduce_min_sync(0xffffffffu, ui), __reduce_max_sync(0xffffffffu, uj));
    const int s = j % kStages;
    if (lane == 0) {
      ring.rows[s * kConsumers + w] = r;
      mbar_arrive(&ring.ready[s]);
    }
  };
  // fill: the coordinates of the first kLead + kLoadAhead tiles, the row
  // boxes of the first kLead
  Cursor at(g, 0), ahead = at, fetch = at;
  for (int j = 0; j < kLead + kLoadAhead; ++j, fetch.next(g)) load(fetch, j);
  cp_async_wait<kLoadAhead>();
  for (int j = 0; j < kLead; ++j, ahead.next(g)) publish(ahead, j);
  for (int j = 0; at.live(g); ++j, at.next(g), ahead.next(g), fetch.next(g)) {
    load(fetch, j + kLead + kLoadAhead);  // into the slot of tile j-1
    cp_async_wait<kLoadAhead>();  // tile j + kLead's coordinates have landed
    publish(ahead, j + kLead);
    const int s = j % kStages;
    mbar_wait(&ring.full[s], (j / kStages) & 1);
    if (live(at)) {
      const int b = at.b;
      const int4 c = mine[32 * (j % kSlots)];
      const int vi = min(max(c.x, 0), H - 2);
      const int ui = min(max(c.y, 0), W - 2);
      const float fv = __int_as_float(c.z), fu = __int_as_float(c.w);
      float* const o = g.out + (long long)b * C * g.N + (long long)(at.y0 + w) * g.Ws + at.x0 + lane;
      const Header h = ring.head[s];
      if (h.c0 >= 0) {
        // window row r holds the floats c0, c0 + 1, ... of plane row vlo + r
        const int pitch = 32 * g.window_chunks;
        const float* p0 =
            ring.boxes + (size_t)s * g.capacity + (vi - h.vlo) * pitch + (ui * C - h.c0);
        blend<VEC>(p0, p0 + pitch, C, fu, fv, o, g.N);
      } else {
        const float* p0 = g.F + (((long long)b * H + vi) * W + ui) * C;
        blend<VEC>(p0, p0 + (long long)W * C, C, fu, fv, o, g.N);
      }
    }
    __syncwarp();
    if (lane == 0) mbar_arrive(&ring.empty[s]);
  }
}

template <int VEC>
__global__ void __launch_bounds__(kThreads, 1)
    gather_tiles_ring_kernel(const Grid g, const __grid_constant__ CUtensorMap map) {
  extern __shared__ __align__(128) float ring_smem[];
  __shared__ __align__(8) uint64_t bars[3][kStages];
  Ring ring;
  ring.boxes = ring_smem;
  ring.head = reinterpret_cast<Header*>(ring_smem + (size_t)kStages * g.capacity);
  ring.rows = reinterpret_cast<int4*>(ring.head + kStages);
  ring.coords = ring.rows + kStages * kConsumers;
  ring.ready = bars[0];
  ring.full = bars[1];
  ring.empty = bars[2];
  if (threadIdx.x < kStages) {
    mbar_init(&ring.ready[threadIdx.x], kConsumers);
    mbar_init(&ring.full[threadIdx.x], 1);
    mbar_init(&ring.empty[threadIdx.x], kConsumers);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  const int warp = threadIdx.x >> 5;
  if (warp == kConsumers)
    produce(g, &map, ring);
  else
    consume<VEC>(g, ring, warp);
}

// The tensor map of the plane F viewed as [B*H][W*C/32][32] floats whose
// box is a tile's window: tile_h + 3 rows of the 128-byte chunks that 35
// cells can span from any float of a chunk (the box of a tile near
// identity motion, which tiles.py::tile_rows makes fit a buffer).  Sets
// *rows to 0 where the view or the window does not exist: a row is not
// whole chunks, or the window does not fit a buffer (an unaligned plane
// gets a capacity of 0).  Returns the error of a driver call that fails
// for a plane that has the view (the driver's CUresult, whose common
// codes are cudaError's).
int encode_window(const TilesArgs& a, int capacity, CUtensorMap* map, int* rows, int* chunks) {
  static PFN_cuTensorMapEncodeTiled_v12000 encode = nullptr;
  *rows = 0;
  *chunks = ((kTileW + 3) * a.C + 31 + 31) / 32;
  const long long WC = (long long)a.W * a.C;
  if (WC % 32 || *chunks > 256 || (long long)(a.tile_h + 3) * 32 * *chunks > capacity) return 0;
  if (encode == nullptr) {
    cudaDriverEntryPointQueryResult found;
    const cudaError_t e = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", reinterpret_cast<void**>(&encode), 12000, cudaEnableDefault,
        &found);
    if (e != cudaSuccess || found != cudaDriverEntryPointSuccess) {
      encode = nullptr;
      return e != cudaSuccess ? (int)e : (int)cudaErrorSymbolNotFound;
    }
  }
  const cuuint64_t dims[3] = {32, (cuuint64_t)(WC / 32), (cuuint64_t)a.B * a.H};
  const cuuint64_t strides[2] = {128, (cuuint64_t)WC * 4};  // bytes, of dims 1 and 2
  const cuuint32_t box[3] = {32, (cuuint32_t)*chunks, (cuuint32_t)(a.tile_h + 3)};
  const cuuint32_t step[3] = {1, 1, 1};
  const CUresult r =
      encode(map, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 3, const_cast<float*>(a.F), dims, strides, box,
             step, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_NONE,
             CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  if (r != CUDA_SUCCESS) return (int)r;
  *rows = a.tile_h + 3;
  return 0;
}

template <int VEC>
int launch(const TilesArgs& a, int capacity) {
  static size_t opted_in = 48 * 1024;  // dynamic shared memory allowed so far
  static size_t counted = 0;           // the shared memory per_sm was counted for
  static int sms = 0, per_sm = 0;
  const size_t shared = shared_bytes(capacity);
  if (shared > kMaxShared) return (int)cudaErrorInvalidValue;
  if (shared > opted_in) {
    const cudaError_t e = cudaFuncSetAttribute(
        gather_tiles_ring_kernel<VEC>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)shared);
    if (e != cudaSuccess) return (int)e;
    opted_in = shared;
  }
  if (sms == 0) {
    int dev;
    cudaError_t e = cudaGetDevice(&dev);
    if (e == cudaSuccess) e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (e != cudaSuccess) return (int)e;
  }
  if (counted != shared) {
    const cudaError_t e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per_sm, gather_tiles_ring_kernel<VEC>, kThreads, shared);
    if (e != cudaSuccess) return (int)e;
    if (per_sm < 1) return (int)cudaErrorInvalidConfiguration;
    counted = shared;
  }
  Grid g{a.F, a.v0, a.dv, a.u0, a.du, a.out, a.B, a.H, a.W, a.C, a.Hs, a.Ws, a.tile_h,
         capacity};
  g.tiles_x = (a.Ws + kTileW - 1) / kTileW;
  g.tiles_y = (a.Hs + a.tile_h - 1) / a.tile_h;
  g.N = (long long)a.Hs * a.Ws;
  const long long per_image = (long long)g.tiles_x * g.tiles_y, tiles = a.B * per_image;
  if (tiles > INT_MAX / 2) return (int)cudaErrorInvalidValue;
  const int grid = (int)(tiles < (long long)sms * per_sm ? tiles : (long long)sms * per_sm);
  g.step_b = (int)(grid / per_image);
  g.step_y = (int)(grid % per_image) / g.tiles_x;
  g.step_x = (int)(grid % per_image) % g.tiles_x;
  CUtensorMap map{};
  const int e = encode_window(a, capacity, &map, &g.window_rows, &g.window_chunks);
  if (e != 0) return e;
  gather_tiles_ring_kernel<VEC><<<grid, kThreads, shared, (cudaStream_t)a.stream>>>(g, map);
  return (int)cudaGetLastError();
}

}  // namespace ring

// Returns the cudaError_t of the launch (gx, gy unused).  The box buffers
// (a multiple of 32 floats each, so that each starts on 128 bytes, as TMA
// copies need) stage only from a 16-byte aligned plane, as a tensor map
// needs; float2 loads need C even and an 8-byte aligned plane.
extern "C" int gather_tiles_launch(const TilesArgs* a) {
  if (a->B == 0 || a->Hs == 0 || a->Ws == 0) return 0;
  if (a->tile_h < 1 || a->tile_h > ring::kMaxRows || a->capacity < 0 || a->capacity % 32)
    return (int)cudaErrorInvalidValue;
  const uintptr_t f = reinterpret_cast<uintptr_t>(a->F);
  const int capacity = f % 16 ? 0 : a->capacity;
  return a->C % 2 == 0 && f % 8 == 0 ? ring::launch<2>(*a, capacity)
                                     : ring::launch<1>(*a, capacity);
}

// As gather_tiles_launch, with the derivative maps gx, gy (bfloat16 where
// a->bf16).
extern "C" int gather_tiles_grads_launch(const TilesArgs* a) {
  return a->bf16 ? launch<true, __nv_bfloat16>(*a) : launch<true, float>(*a);
}

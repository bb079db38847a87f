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
// has no sequential grid, and float addition is not associative.  So the
// sums here are integers:
//
// - Each product p = g * w is formed in float32 (the plain version's
//   product), scaled by 2^s (exact in float64) and rounded half to even to
//   an int64.  s is per (b, c): s = min(51, 62 - ceil(log2 N)) - e, where
//   2^e > the largest finite |g[b, c, :]| (frexp's exponent).  A sample's
//   four corners are distinct cells (the starts are clamped to
//   [0, size-2]) and its weights lie in [0, 1], so a cell takes at most N
//   products of at most 2^(62 - ceil(log2 N)) each: its sum stays within
//   2^62, and int64 addition is exact and associative.  Whatever order the
//   bins, the staged segments and the merges take, the integers, and so the
//   bits of the result, are the same.  The quantum 2^-s is 2^-46 of the
//   largest |g| at 120x160 (N = 19,200) and 2^-42 at 480x640, far below
//   float32's rounding of the result.  One fused multiply-add, p * 2^s +
//   1.5 * 2^52, rounds the product into the low bits of a double, as the
//   plain version rounds.
// - A non-finite product (NaN or Inf in g or a weight) sets its cell's
//   class bits instead: +Inf 1, -Inf 2, NaN 3, or-ed.  A cell with class 1
//   is +Inf, 2 -Inf, 3 NaN, as the plain version's float32 sum of those
//   products is, in any order.  A staged sample with a finite cotangent and
//   weights in [-1, 1] has finite products only, and takes a path without
//   the test (kSlow marks the others).
// - The result is the int64 sum converted to float64, times 2^-s (exact),
//   rounded to float32.  ops/kernels/splat.py's plain version computes the
//   same integers and roundings, bit for bit.
//
// Since the order of the adds cannot move a bit, no accumulator needs to
// live in device memory: each output cell is summed by one thread and
// written once.  The launch function runs, on the caller's stream with no
// host sync:
//
// 1. a memset of the per-tile counters and the per-(b, c) maxima (a few KB);
// 2. splat_bin_count: each thread takes kBinSamples samples of one image,
//    clamps their corner starts and counts the output tiles (kTileH x
//    kTileW cells) each 2x2 block touches, one to four, in a per-image
//    histogram in shared memory (warp-aggregated with __match_any_sync),
//    then one global add a tile; the CTA also takes its samples' largest
//    finite |g| per channel (atomicMax on the bits of a non-negative float
//    orders as the float);
// 3. splat_bin_scan, one CTA: exclusive scans of the counts (each tile's
//    bin offset) and of the bins over kSplit entries, the first `slots` of
//    which spread over several CTAs: their merge slots, parts and the work
//    items of their later parts (item t < tiles is tile t's bin, or its
//    first part);
// 4. splat_bin_scatter: the same walk as 2 reserves a run of each bin per
//    CTA and puts each sample's index there (the order inside a bin changes
//    from run to run; the sums do not), and zeroes the split tiles' merge
//    buffers;
// 5. splat_tile_sum<CG>, persistent CTAs taking the work items blockIdx.x,
//    + gridDim.x, ...: a CTA owns one tile and a group of at most CG
//    channels (kMaxGroup; wider C takes several groups).  Each of its 256
//    threads owns one cell of the 8 x 32 tile and keeps the cell's CG int64
//    sums and class bits in registers.  It stages its bin kChunk samples at
//    a time, two a thread with every load issued at once: their four corner
//    weights and CG cotangent values in shared memory, counting-sorted by
//    start cell over the tile and its one-cell halo above and left (9 x 33
//    start cells).  Each thread then walks the four segments of starts whose
//    corners land on its cell, as one run.  A segment longer than kHeavy
//    (samples clamped onto border cells, a 2x2 plane) is summed first,
//    kPiece entries a warp, each lane one (corner, channel) pair, into the
//    cells' shared heavy sums.  The CTA puts its cells' results in shared
//    memory and stores the tile row by row, float4 where the rows allow: no
//    memset of d_op, no accumulator plane, no convert pass.  The CTAs of a
//    split bin add their int64 sums to the tile's merge buffer (global
//    64-bit atomics, nonzero sums only), and the last to arrive converts
//    and stores.
//
// Bound: bytes: the cotangent and four coordinate arrays read once and the
// plane written once.  The kernel reads g twice (the maxima, then the
// sums), the starts three times and the bins twice; the arithmetic is ~12
// operations per (sample, corner, channel), under the card's rates.

#include <cstdint>
#include <cuda_runtime.h>

// The launch function's one argument; ops/kernels/splat.py packs it with
// the struct format "17P7iP" (native layout) and lays out the scratch
// regions (splat.py::scratch_layout).
struct SplatArgs {
  const float* g;  // [B,C,N]
  const int* v0;   // [B,N]
  const float* dv;
  const int* u0;
  const float* du;
  float* d_op;           // [B,H,W,C]
  int* counts;           // [tiles] bin sizes; top [B*C] and ctl [4] follow: zeroed here
  unsigned* top;         // [B*C] bits of each (b, c)'s largest finite |g|
  int* ctl;              // [4] work items ([1]) and split tiles ([2])
  int* parts;            // [slots] CTAs each split bin takes
  int* slot_of;          // [tiles] merge slot of a bin over kSplit entries, -1 if unsplit
  int* extra;            // [work_cap - tiles][2] tile, part: a split bin's parts after its first
  int* cursor;           // [tiles] first entry of each bin, then (after the scatter) its end
  int* bins;             // [4*B*N] sample indices, bin after bin
  int64_t* merge;        // [slots][kCells][C] the split tiles' int64 sums
  unsigned* merge_cls;   // [slots][kCells][groups] their class bits
  int* arrivals;         // [slots][groups] parts done
  int B, H, W, C, N;
  int slots;             // tiles whose bins may split across CTAs
  int work_cap;          // work items at most: tiles plus split bins' extra parts
  void* stream;
};

namespace {

constexpr int kTileH = 8, kTileW = 32;  // output cells a CTA owns
constexpr int kCells = kTileH * kTileW;
constexpr int kThreads = kCells;        // one thread a cell
constexpr int kWarps = kThreads / 32;
constexpr int kHaloW = kTileW + 1;      // start cells: the tile and one row above, one column left
constexpr int kHalo = (kTileH + 1) * kHaloW;
constexpr int kChunk = 512;   // bin entries staged at once, two a thread
constexpr int kSplit = 1024;  // bin entries a CTA takes before a bin splits
constexpr int kHeavy = 8;     // a start cell's segment longer than this is summed by warps
constexpr int kPiece = 64;    // entries of a heavy segment a warp sums at once
constexpr int kMaxHeavy = kChunk / (kHeavy + 1);
constexpr int kMaxGroup = 16;  // channels a CTA sums
constexpr int kBinSamples = 4;  // samples a thread bins
constexpr int kHistTiles = 4096;  // tiles of an image the bin passes count in shared memory
constexpr int kScanThreads = 1024;
constexpr int kScanTiles = 8;   // tiles a scan thread takes a round
constexpr int kSumBits = 62;      // a cell's sum stays below 2^62
constexpr int kProductBits = 51;  // each product's below 2^51 (the plain
                                  // version rounds by adding 1.5 * 2^52)
constexpr double kRounder = 6755399441055744.0;  // 1.5 * 2^52
constexpr long long kRounderBits = 0x4338000000000000LL;
constexpr unsigned kFull = 0xffffffffu;

static_assert(kChunk == 2 * kThreads, "a thread stages two entries");
static_assert(kChunk < (1 << 16) && kHalo < (1 << 15), "packed start cell and rank");

// frexp's exponent of the finite float >= 0 with these bits (0 for 0)
__device__ __forceinline__ int frexp_exponent(unsigned bits) {
  if (bits == 0) return 0;
  const int biased = (int)(bits >> 23);
  return biased ? biased - 126 : (32 - __clz((int)bits)) - 149;
}

// s of channel (b, c) whose largest finite |g| has the bits `top`
__device__ __forceinline__ int fixed_shift(unsigned top, int log2n) {
  return min(kProductBits, kSumBits - log2n) - frexp_exponent(top);
}

// 2^e, exactly, for e in [-1022, 1023]
__device__ __forceinline__ double pow2(int e) {
  return __longlong_as_double((long long)(e + 1023) << 52);
}

// The product p into the int64 sum a (finite) or the class bits at `at`
// (not).  p * 2^s is exact in float64 and below 2^51, so adding 1.5 * 2^52
// in the same fused operation rounds it half to even into the low bits,
// as the plain version rounds.
__device__ __forceinline__ void take(float p, double scale, unsigned long long& a, unsigned& cls,
                                     int at) {
  if (isfinite(p))
    a += __double_as_longlong(__fma_rn((double)p, scale, kRounder)) - kRounderBits;
  else
    cls |= (p != p ? 3u : p > 0.0f ? 1u : 2u) << at;
}

// take() for a product known to be finite, without the rounder's bits:
// the caller subtracts kRounderBits once a product taken (a wraps
// modulo 2^64, and so does the difference)
__device__ __forceinline__ void take_finite(float p, double scale, unsigned long long& a) {
  a += __double_as_longlong(__fma_rn((double)p, scale, kRounder));
}

// a cell's float32 result from its int64 sum, class bits and shift
__device__ __forceinline__ float result(unsigned long long a, unsigned cls, int shift) {
  if (cls == 3u) return __uint_as_float(0x7fc00000u);
  if (cls == 1u) return __uint_as_float(0x7f800000u);
  if (cls == 2u) return __uint_as_float(0xff800000u);
  return __double2float_rn(__dmul_rn(__ll2double_rn((long long)a), pow2(-shift)));
}

__device__ __forceinline__ float corner(const float4& w, int q) {
  return q == 0 ? w.x : q == 1 ? w.y : q == 2 ? w.z : w.w;
}

// Adds one to base[key] for every lane of the (whole) warp whose key >= 0,
// one atomic per distinct key; returns the value base[key] had before the
// warp's add plus the lane's rank among the lanes of its key.
__device__ __forceinline__ int warp_add(int* base, int key) {
  const int lane = threadIdx.x & 31;
  const unsigned peers = __match_any_sync(kFull, key);
  const int leader = __ffs(peers) - 1;
  int old = 0;
  if (key >= 0 && lane == leader) old = atomicAdd(base + key, __popc(peers));
  old = __shfl_sync(kFull, old, leader);
  return old + __popc(peers & ((1u << lane) - 1u));
}

// The tile of corner q = 00, 01, 10, 11 of the block at start (vi, ui), in
// its image, or -1 where that corner lies in a tile an earlier corner took.
__device__ __forceinline__ int corner_tile(int q, int vi, int ui, int TX) {
  const int ty = (vi + (q >> 1)) / kTileH, tx = (ui + (q & 1)) / kTileW;
  if (((q & 2) && ty == vi / kTileH) || ((q & 1) && tx == ui / kTileW)) return -1;
  return ty * TX + tx;
}

// Exclusive scan of x over the block (blockDim.x a multiple of 32, at most
// 1024); `total` gets the block's sum.  `sums` holds 33 ints.
__device__ __forceinline__ int block_scan(int x, int* sums, int& total) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  int inc = x;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const int y = __shfl_up_sync(kFull, inc, o);
    if (lane >= o) inc += y;
  }
  if (lane == 31) sums[warp] = inc;
  __syncthreads();
  if (warp == 0) {
    const int s = lane < (int)(blockDim.x >> 5) ? sums[lane] : 0;
    int si = s;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const int y = __shfl_up_sync(kFull, si, o);
      if (lane >= o) si += y;
    }
    sums[lane] = si - s;
    if (lane == 31) sums[32] = si;
  }
  __syncthreads();
  const int out = sums[warp] + inc - x;
  total = sums[32];
  __syncthreads();
  return out;
}

// The j-th of the kBinSamples samples a thread of the bin passes takes: a
// CTA takes kBinSamples * kThreads consecutive samples of one image,
// kThreads apart a thread, so that a warp's lanes take consecutive samples
// and a bin receives runs of them.
__device__ __forceinline__ int sample_of(int j) {
  return (blockIdx.x * kBinSamples + j) * kThreads + threadIdx.x;
}

// The clamped corner starts of the kBinSamples samples this thread bins.
struct Starts {
  int v[kBinSamples], u[kBinSamples];
  bool live[kBinSamples];
};

__device__ __forceinline__ Starts load_starts(const int* v0, const int* u0, int b, int H, int W,
                                              int N) {
  Starts st;
#pragma unroll
  for (int j = 0; j < kBinSamples; ++j) {
    const int n = sample_of(j);
    st.live[j] = n < N;
    const long long i = (long long)b * N + (st.live[j] ? n : 0);
    st.v[j] = min(max(v0[i], 0), H - 2);
    st.u[j] = min(max(u0[i], 0), W - 2);
  }
  return st;
}

// Counts each sample into the bins of the tiles its 2x2 block touches (in
// shared memory per image where its tiles fit, then one global add a tile)
// and takes the CTA's largest finite |g| per channel.
__global__ void __launch_bounds__(kThreads) splat_bin_count(
    const float* __restrict__ g, const int* __restrict__ v0, const int* __restrict__ u0,
    int* __restrict__ counts, unsigned* __restrict__ top, int H, int W, int C, int N, int TY,
    int TX) {
  extern __shared__ unsigned shared_count[];  // [tiles of an image] if they fit, then [C]
  const int tpi = TY * TX;
  const bool local = tpi <= kHistTiles;
  int* hist = reinterpret_cast<int*>(shared_count);
  unsigned* tops = shared_count + (local ? tpi : 0);
  const int b = blockIdx.y;
  for (int i = threadIdx.x; i < (local ? tpi : 0); i += kThreads) hist[i] = 0;
  for (int c = threadIdx.x; c < C; c += kThreads) tops[c] = 0;
  const Starts st = load_starts(v0, u0, b, H, W, N);
  __syncthreads();
  int* bins_of = local ? hist : counts + (long long)b * tpi;
#pragma unroll
  for (int j = 0; j < kBinSamples; ++j)
#pragma unroll
    for (int q = 0; q < 4; ++q)
      warp_add(bins_of, st.live[j] ? corner_tile(q, st.v[j], st.u[j], TX) : -1);
  // loads from valid addresses only, all issued before any is used
  const float* gb = g + (long long)b * C * N;
  for (int c0 = 0; c0 < C; c0 += 4) {
    unsigned bits[4][kBinSamples];
#pragma unroll
    for (int cc = 0; cc < 4; ++cc) {
      const float* gc = gb + (long long)min(c0 + cc, C - 1) * N;
#pragma unroll
      for (int j = 0; j < kBinSamples; ++j)
        bits[cc][j] = __float_as_uint(gc[min(sample_of(j), N - 1)]);
    }
#pragma unroll
    for (int cc = 0; cc < 4; ++cc) {
      unsigned m = 0;
#pragma unroll
      for (int j = 0; j < kBinSamples; ++j) {
        const unsigned a = bits[cc][j] & 0x7fffffffu;
        if (st.live[j] && a < 0x7f800000u) m = max(m, a);  // finite
      }
      m = __reduce_max_sync(kFull, m);
      if ((threadIdx.x & 31) == 0 && m != 0 && c0 + cc < C) atomicMax(tops + c0 + cc, m);
    }
  }
  __syncthreads();
  for (int i = threadIdx.x; i < (local ? tpi : 0); i += kThreads)
    if (hist[i] != 0) atomicAdd(counts + (long long)b * tpi + i, hist[i]);
  for (int c = threadIdx.x; c < C; c += kThreads)
    if (tops[c] != 0) atomicMax(top + b * C + c, tops[c]);
}

// One CTA: each tile's bin offset, the bins over kSplit entries that split
// (the first `slots` of them: their merge slot and number of parts), and
// the work items past the first `tiles` (item t is tile t's bin, or its
// first part): a split bin's later parts, kSplit entries each.
__global__ void __launch_bounds__(kScanThreads) splat_bin_scan(
    const int* __restrict__ counts, int* __restrict__ cursor, int* __restrict__ slot_of,
    int* __restrict__ parts_of, int2* __restrict__ extra, int* __restrict__ ctl, int tiles,
    int slots) {
  __shared__ int sums[33];
  int base_off = 0, base_split = 0, base_extra = 0;
  for (int t0 = 0; t0 < tiles; t0 += kScanThreads * kScanTiles) {
    const int tb = t0 + threadIdx.x * kScanTiles;
    int c[kScanTiles], sum = 0, over = 0;
#pragma unroll
    for (int i = 0; i < kScanTiles; ++i) {
      c[i] = tb + i < tiles ? counts[tb + i] : 0;
      sum += c[i];
      over += c[i] > kSplit;
    }
    int total;
    int off = base_off + block_scan(sum, sums, total);
    base_off += total;
    const int rank0 = base_split + block_scan(over, sums, total);
    base_split += total;
    int more = 0, rank = rank0;  // extra parts of this thread's split bins
#pragma unroll
    for (int i = 0; i < kScanTiles; ++i) {
      if (c[i] > kSplit) {
        if (rank < slots) more += (c[i] + kSplit - 1) / kSplit - 1;
        ++rank;
      }
    }
    int x = base_extra + block_scan(more, sums, total);
    base_extra += total;
    rank = rank0;
#pragma unroll
    for (int i = 0; i < kScanTiles; ++i) {
      if (tb + i < tiles) {
        cursor[tb + i] = off;
        off += c[i];
        if (c[i] > kSplit) {
          const bool split = rank < slots;
          slot_of[tb + i] = split ? rank : -1;
          if (split) {
            const int parts = (c[i] + kSplit - 1) / kSplit;
            parts_of[rank] = parts;
            for (int j = 1; j < parts; ++j) extra[x++] = make_int2(tb + i, j);
          }
          ++rank;
        }
      }
    }
  }
  if (threadIdx.x == 0) {
    ctl[1] = tiles + base_extra;
    ctl[2] = min(base_split, slots);
  }
}

// Puts each sample's index into the bins of the tiles its block touches
// (reserving a run of each bin a CTA, where the image's tiles fit shared
// memory), and zeroes the merge buffers of the split tiles.
__global__ void __launch_bounds__(kThreads) splat_bin_scatter(
    const int* __restrict__ v0, const int* __restrict__ u0, int* __restrict__ cursor,
    int* __restrict__ bins, const int* __restrict__ ctl, int64_t* __restrict__ merge,
    unsigned* __restrict__ merge_cls, int* __restrict__ arrivals, int H, int W, int C, int N,
    int TY, int TX, int groups) {
  extern __shared__ int shared_bins[];  // [tiles of an image] counts, then their first entries
  const int tpi = TY * TX;
  const bool local = tpi <= kHistTiles;
  int* hist = shared_bins;
  int* first = shared_bins + tpi;
  const int b = blockIdx.y;
  for (int i = threadIdx.x; i < (local ? tpi : 0); i += kThreads) hist[i] = 0;
  const Starts st = load_starts(v0, u0, b, H, W, N);
  __syncthreads();
  int* bins_of = local ? hist : cursor + (long long)b * tpi;
  int key[kBinSamples][4], at[kBinSamples][4];
#pragma unroll
  for (int j = 0; j < kBinSamples; ++j)
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      key[j][q] = st.live[j] ? corner_tile(q, st.v[j], st.u[j], TX) : -1;
      at[j][q] = warp_add(bins_of, key[j][q]);
    }
  if (local) {
    __syncthreads();
    for (int i = threadIdx.x; i < tpi; i += kThreads)
      if (hist[i] != 0) first[i] = atomicAdd(cursor + (long long)b * tpi + i, hist[i]);
    __syncthreads();
  }
#pragma unroll
  for (int j = 0; j < kBinSamples; ++j) {
    const int n = sample_of(j);
#pragma unroll
    for (int q = 0; q < 4; ++q)
      if (key[j][q] >= 0) bins[(local ? first[key[j][q]] : 0) + at[j][q]] = n;
  }
  // zero the merge buffers of the split tiles
  const long long stride = (long long)gridDim.x * gridDim.y * kThreads;
  const long long i0 = ((long long)blockIdx.y * gridDim.x + blockIdx.x) * kThreads + threadIdx.x;
  const int split = ctl[2];
  for (long long i = i0; i < (long long)split * kCells * C; i += stride) merge[i] = 0;
  for (long long i = i0; i < (long long)split * kCells * groups; i += stride) merge_cls[i] = 0;
  for (long long i = i0; i < (long long)split * groups; i += stride) arrivals[i] = 0;
}

template <int CG>
struct TileShared {
  float4 w[kChunk];                      // corner weights w00, w01, w10, w11
  float g[kChunk * (CG | 1)];            // the cotangent of the group, odd row stride;
                                         // then the cells' results
  unsigned long long heavy[kCells][CG];  // each cell's sums from heavy segments
  unsigned heavy_cls[kCells];
  double scale[CG];
  int count[kHalo];                      // samples per start cell
  int start[kHalo];                      // first of them in `sorted`
  int sorted[kChunk];                    // staged samples by start cell, kSlow marked
  int slot[kChunk];                      // start cell << 16 | rank in it, kSlow marked
  int heavy_cell[kMaxHeavy];
  int heavy_piece[kMaxHeavy + 1];        // first piece of each heavy segment
  signed char heavy_of[kHalo];           // heavy segment of a start cell, -1 if none
  int shift[CG];
  int sums[33];
  int n_heavy, last;
};

// marks a staged sample whose products may not be finite: a non-finite g
// of the group, or a weight that is not within [-1, 1]
constexpr int kSlow = 1 << 30;

// One staged sample: its clamped start, fractions and the group's cotangent.
template <int CG>
struct Staged {
  int vi, ui;
  float fv, fu;
  float g[CG];
};

// Loads sample n's staging (a valid sample: the caller clamps the entry).
template <int CG>
__device__ __forceinline__ Staged<CG> fetch(int n, const float* g, const int* v0, const float* dv,
                                            const int* u0, const float* du, long long bn,
                                            long long gbase, int H, int W, int N, int nch) {
  Staged<CG> x;
  x.vi = min(max(v0[bn + n], 0), H - 2);
  x.ui = min(max(u0[bn + n], 0), W - 2);
  x.fv = dv[bn + n];
  x.fu = du[bn + n];
#pragma unroll
  for (int c = 0; c < CG; ++c) x.g[c] = g[gbase + (long long)min(c, nch - 1) * N + n];
  return x;
}

// Puts staged sample x at entry k of the chunk (if k < m): its corner
// weights and cotangent; returns its start cell in the halo (kSlow marked),
// or -1 past the chunk's m entries.
template <int CG>
__device__ __forceinline__ int commit(TileShared<CG>& s, int k, int m, const Staged<CG>& x, int y0,
                                      int x0, int nch) {
  if (k >= m) return -1;
  const float omu = 1.0f - x.fu, omv = 1.0f - x.fv;
  const float4 w = make_float4(__fmul_rn(omu, omv), __fmul_rn(x.fu, omv), __fmul_rn(omu, x.fv),
                               __fmul_rn(x.fu, x.fv));
  s.w[k] = w;
  bool slow = !(fabsf(w.x) <= 1.0f && fabsf(w.y) <= 1.0f && fabsf(w.z) <= 1.0f &&
                fabsf(w.w) <= 1.0f);
#pragma unroll
  for (int c = 0; c < CG; ++c) {
    slow |= !isfinite(x.g[c]);
    s.g[k * (CG | 1) + c] = c < nch ? x.g[c] : 0.0f;
  }
  return ((x.vi - y0 + 1) * kHaloW + (x.ui - x0 + 1)) | (slow ? kSlow : 0);
}

// A work item's tile and its loads: the bin's size, end and merge slot.
struct Raw {
  int t, j, count, end, slot;
};

__device__ __forceinline__ Raw raw_item(int wi, int tiles, const int* counts, const int* cursor,
                                        const int* slot_of, const int2* extra) {
  Raw r;
  r.t = wi;
  r.j = 0;
  if (wi >= tiles) {
    const int2 x = extra[wi - tiles];
    r.t = x.x;
    r.j = x.y;
  }
  r.count = counts[r.t];
  r.end = cursor[r.t];
  r.slot = slot_of[r.t];  // read only for a bin over kSplit entries
  return r;
}

// (tile, first entry, end entry, merge slot or -1) of a work item
__device__ __forceinline__ int4 item_range(const Raw& r) {
  const int start = r.end - r.count;
  const int slot = r.count > kSplit ? r.slot : -1;
  if (slot < 0) return make_int4(r.t, start, r.end, -1);
  const int e0 = start + r.j * kSplit;
  return make_int4(r.t, e0, min(r.end, e0 + kSplit), slot);
}

// Persistent CTAs, each taking the work items blockIdx.x, + gridDim.x, ...:
// one tile's bin, or a part of it, for one channel group.  An item's range
// is loaded while the item before it is summed.
template <int CG>
__global__ void __launch_bounds__(kThreads, 3) splat_tile_sum(
    const float* __restrict__ g, const int* __restrict__ v0, const float* __restrict__ dv,
    const int* __restrict__ u0, const float* __restrict__ du, float* __restrict__ d_op,
    const unsigned* __restrict__ top, const int* __restrict__ ctl, const int* __restrict__ counts,
    const int* __restrict__ cursor, const int* __restrict__ slot_of,
    const int* __restrict__ parts, const int2* __restrict__ extra, const int* __restrict__ bins,
    int64_t* __restrict__ merge, unsigned* __restrict__ merge_cls, int* __restrict__ arrivals,
    int H, int W, int C, int N, int TY, int TX, int tiles, int groups, int width, int log2n) {
  constexpr int GS = CG | 1;
  extern __shared__ float4 smem[];
  TileShared<CG>& s = *reinterpret_cast<TileShared<CG>*>(smem);
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int ly = tid / kTileW, lx = tid - ly * kTileW;  // this thread's cell in the tile
  const int items = ctl[1] * groups;
  const int G = gridDim.x;
  int item = blockIdx.x;
  if (item >= items) return;

  Raw next = raw_item(item / groups, tiles, counts, cursor, slot_of, extra);

  for (; item < items; item += G) {
    const int4 wk = item_range(next);  // tile, first entry, end entry, merge slot
    if (item + G < items)
      next = raw_item((item + G) / groups, tiles, counts, cursor, slot_of, extra);
    const int grp = item - item / groups * groups;
    const int b = wk.x / (TY * TX), r = wk.x - b * (TY * TX);
    const int y0 = r / TX * kTileH, x0 = (r - r / TX * TX) * kTileW;
    const int c0 = grp * width, nch = min(width, C - c0);
    const long long bn = (long long)b * N, gbase = ((long long)b * C + c0) * N;
    const unsigned mytop = tid < nch ? top[b * C + c0 + tid] : 0u;
    unsigned long long acc[CG];
#pragma unroll
    for (int c = 0; c < CG; ++c) {
      acc[c] = 0;
      s.heavy[tid][c] = 0;
    }
    s.heavy_cls[tid] = 0;
    unsigned cls = 0;  // 2 bits a channel
    int taken = 0;     // products taken by take_finite, each channel

    for (int e = wk.y; e < wk.z; e += kChunk) {
      const int m = min(kChunk, wk.z - e);
      // two entries a thread: their loads are issued before the chunk's
      // shared state is reset
      const Staged<CG> x1 = fetch<CG>(bins[e + min(tid, m - 1)], g, v0, dv, u0, du, bn, gbase, H,
                                      W, N, nch);
      const Staged<CG> x2 = fetch<CG>(bins[e + min(tid + kThreads, m - 1)], g, v0, dv, u0, du, bn,
                                      gbase, H, W, N, nch);
      for (int i = tid; i < kHalo; i += kThreads) {
        s.count[i] = 0;
        s.heavy_of[i] = -1;
      }
      if (tid == 0) s.n_heavy = 0;
      if (e == wk.y && tid < CG) {
        s.shift[tid] = fixed_shift(mytop, log2n);
        s.scale[tid] = pow2(s.shift[tid]);
      }
      __syncthreads();
      // the staged samples into shared memory, counted by start cell
      {
        const int h1 = commit(s, tid, m, x1, y0, x0, nch);
        const int h2 = commit(s, tid + kThreads, m, x2, y0, x0, nch);
        const int r1 = warp_add(s.count, h1 < 0 ? -1 : h1 & ~kSlow);
        const int r2 = warp_add(s.count, h2 < 0 ? -1 : h2 & ~kSlow);
        if (h1 >= 0) s.slot[tid] = (h1 & ~kSlow) << 16 | r1 | (h1 & kSlow);
        if (h2 >= 0) s.slot[tid + kThreads] = (h2 & ~kSlow) << 16 | r2 | (h2 & kSlow);
      }
      __syncthreads();
      // exclusive scan of the start cells' counts; the long segments are heavy
      {
        const int i0 = 2 * tid;
        const int a0 = i0 < kHalo ? s.count[i0] : 0, a1 = i0 + 1 < kHalo ? s.count[i0 + 1] : 0;
        int total;
        const int st = block_scan(a0 + a1, s.sums, total);
        if (i0 < kHalo) s.start[i0] = st;
        if (i0 + 1 < kHalo) s.start[i0 + 1] = st + a0;
        for (int i = 0; i < 2; ++i) {
          if ((i ? a1 : a0) > kHeavy) {
            const int j = atomicAdd(&s.n_heavy, 1);
            s.heavy_cell[j] = i0 + i;
            s.heavy_of[i0 + i] = (signed char)j;
          }
        }
      }
      __syncthreads();
      for (int k = tid; k < m; k += kThreads) {
        const int sl = s.slot[k];
        s.sorted[s.start[(sl & ~kSlow) >> 16] + (sl & 0xffff)] = k | (sl & kSlow);
      }
      const int nh = s.n_heavy;
      if (nh > 0) {
        if (tid == 0) {
          int p = 0;
          for (int j = 0; j < nh; ++j) {
            s.heavy_piece[j] = p;
            p += (s.count[s.heavy_cell[j]] + kPiece - 1) / kPiece;
          }
          s.heavy_piece[nh] = p;
        }
        __syncthreads();
        // heavy segments, a piece of kPiece entries a warp: each lane sums
        // the piece for one or two (corner, channel) pairs, and adds the
        // sum to the cell of that corner where it lies in the tile
        for (int p = warp; p < s.heavy_piece[nh]; p += kWarps) {
          int j = 0;
          while (s.heavy_piece[j + 1] <= p) ++j;
          const int hc = s.heavy_cell[j];
          const int first = s.start[hc] + (p - s.heavy_piece[j]) * kPiece;
          const int last = min(s.start[hc] + s.count[hc], first + kPiece);
          const int hy = hc / kHaloW, hx = hc - hy * kHaloW;
          for (int pair = lane; pair < 4 * CG; pair += 32) {
            const int q = pair / CG, c = pair - q * CG;
            const int ty = hy - 1 + (q >> 1), tx = hx - 1 + (q & 1);
            if (c >= nch || ty < 0 || ty >= kTileH || tx < 0 || tx >= kTileW) continue;
            const double sc = s.scale[c];
            unsigned long long a = 0;
            unsigned f = 0;
            for (int i = first; i < last; ++i) {
              const int k = s.sorted[i] & 0xffff;
              take(__fmul_rn(s.g[k * GS + c], corner(s.w[k], q)), sc, a, f, 2 * c);
            }
            const int cell = ty * kTileW + tx;
            if (a != 0) atomicAdd(&s.heavy[cell][c], a);
            if (f != 0) atomicOr(&s.heavy_cls[cell], f);
          }
        }
      }
      __syncthreads();
      // each thread sums its cell: the segments of the four starts whose
      // corner 00, 01, 10 or 11 it is, walked as one run of `total` entries
      {
        double scale[CG];
#pragma unroll
        for (int c = 0; c < CG; ++c) scale[c] = s.scale[c];
        int st[4], end[4];
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          const int h = (ly + 1 - (q >> 1)) * kHaloW + (lx + 1 - (q & 1));
          st[q] = s.start[h];
          end[q] = s.heavy_of[h] < 0 ? st[q] + s.count[h] : st[q];
        }
        const int n0 = end[0] - st[0], n1 = n0 + end[1] - st[1], n2 = n1 + end[2] - st[2];
        const int total = n2 + end[3] - st[3];
        for (int t = 0; t < total; ++t) {
          const int q = (t >= n0) + (t >= n1) + (t >= n2);
          const int i = q == 0 ? st[0] + t : q == 1 ? st[1] + t - n0
                      : q == 2 ? st[2] + t - n1 : st[3] + t - n2;
          const int sk = s.sorted[i], k = sk & 0xffff;
          const float w = corner(s.w[k], q);
          const float* gk = s.g + k * GS;
          if (!(sk & kSlow)) {
            ++taken;
#pragma unroll
            for (int c = 0; c < CG; ++c)
              if (c < nch) take_finite(__fmul_rn(gk[c], w), scale[c], acc[c]);
          } else {
#pragma unroll
            for (int c = 0; c < CG; ++c)
              if (c < nch) take(__fmul_rn(gk[c], w), scale[c], acc[c], cls, 2 * c);
          }
        }
      }
      __syncthreads();  // before the next chunk restages
    }
#pragma unroll
    for (int c = 0; c < CG; ++c)
      acc[c] += s.heavy[tid][c] - (unsigned long long)taken * kRounderBits;
    cls |= s.heavy_cls[tid];

    // the cells' results into shared memory (over the staged cotangent),
    // then stored row by row, coalesced; a split bin's last part to arrive
    // stores the merged sums
    float* results = reinterpret_cast<float*>(s.g);  // [kTileH][kTileW][nch]
    bool store = true;
    if (wk.w < 0) {
#pragma unroll
      for (int c = 0; c < CG; ++c)
        if (c < nch)
          results[tid * nch + c] =
              wk.y == wk.z ? 0.0f : result(acc[c], (cls >> 2 * c) & 3u, s.shift[c]);
    } else {
      const long long cell = (long long)wk.w * kCells + tid;
      int64_t* sum = merge + cell * C + c0;
#pragma unroll
      for (int c = 0; c < CG; ++c)
        if (c < nch && acc[c] != 0)
          atomicAdd(reinterpret_cast<unsigned long long*>(sum + c), acc[c]);
      if (cls != 0) atomicOr(merge_cls + cell * groups + grp, cls);
      __threadfence();
      __syncthreads();
      if (tid == 0) s.last = atomicAdd(arrivals + wk.w * groups + grp, 1) == parts[wk.w] - 1;
      __syncthreads();
      store = s.last;
      if (store) {
        __threadfence();
        const unsigned all = __ldcg(merge_cls + cell * groups + grp);
#pragma unroll
        for (int c = 0; c < CG; ++c)
          if (c < nch)
            results[tid * nch + c] =
                result(__ldcg(reinterpret_cast<const unsigned long long*>(sum + c)),
                       (all >> 2 * c) & 3u, s.shift[c]);
      }
    }
    __syncthreads();
    if (store) {
      const int rows = min(kTileH, H - y0), row = min(kTileW, W - x0) * nch;
      float* out = d_op + (((long long)b * H + y0) * W + x0) * C + c0;
      const long long pitch = (long long)W * C;
      if (nch == C && (row & 3) == 0 && (pitch & 3) == 0 &&
          (reinterpret_cast<uintptr_t>(out) & 15) == 0) {  // whole rows of float4
        const int q4 = row >> 2;
        for (int f = tid; f < rows * q4; f += kThreads) {
          const int ry = f / q4, i = f - ry * q4;
          reinterpret_cast<float4*>(out + ry * pitch)[i] =
              reinterpret_cast<const float4*>(results + ry * kTileW * nch)[i];
        }
      } else {
        for (int f = tid; f < rows * row; f += kThreads) {
          const int ry = f / row, i = f - ry * row, cx = i / nch;
          out[ry * pitch + (long long)cx * C + (i - cx * nch)] = results[ry * kTileW * nch + i];
        }
      }
    }
    __syncthreads();  // s.last, the heavy sums and the results are read
  }
}

template <int CG>
int launch_tiles(const SplatArgs& a, int TY, int TX, int groups, int width, int log2n) {
  static int resident = 0;  // CTAs the card holds at once, found at the first launch
  const size_t shared = sizeof(TileShared<CG>);
  if (resident == 0) {
    cudaError_t e = cudaFuncSetAttribute(splat_tile_sum<CG>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)shared);
    int device = 0, sms = 0, per_sm = 0;
    if (e == cudaSuccess) e = cudaGetDevice(&device);
    if (e == cudaSuccess) e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
    if (e == cudaSuccess)
      e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, splat_tile_sum<CG>, kThreads,
                                                        shared);
    if (e != cudaSuccess) return (int)e;
    if (per_sm < 1) return (int)cudaErrorInvalidConfiguration;
    resident = sms * per_sm;
  }
  const long long most = (long long)a.work_cap * groups;
  const int blocks = (int)(most < resident ? most : resident);
  splat_tile_sum<CG><<<blocks, kThreads, shared, (cudaStream_t)a.stream>>>(
      a.g, a.v0, a.dv, a.u0, a.du, a.d_op, a.top, a.ctl, a.counts, a.cursor, a.slot_of, a.parts,
      reinterpret_cast<const int2*>(a.extra), a.bins, a.merge, a.merge_cls, a.arrivals, a.H, a.W,
      a.C, a.N, TY, TX, a.B * TY * TX, groups, width, log2n);
  return (int)cudaGetLastError();
}

}  // namespace

// Zeroes the counters, bins the samples by output tile and sums each tile.
// Returns the first cudaError_t.
extern "C" int splat_twohot_launch(const SplatArgs* a) {
  if (a->B == 0 || a->C == 0) return 0;
  const cudaStream_t st = (cudaStream_t)a->stream;
  const int TY = (a->H + kTileH - 1) / kTileH, TX = (a->W + kTileW - 1) / kTileW;
  const int tiles = a->B * TY * TX, tpi = TY * TX;
  const int groups = (a->C + kMaxGroup - 1) / kMaxGroup;
  const int width = (a->C + groups - 1) / groups;
  const size_t zeroed = ((size_t)tiles + (size_t)a->B * a->C + 4) * sizeof(int);
  cudaError_t err = cudaMemsetAsync(a->counts, 0, zeroed, st);
  if (err != cudaSuccess) return (int)err;
  const int log2n = a->N > 1 ? 32 - __builtin_clz((unsigned)(a->N - 1)) : 0;
  const dim3 sample_grid((a->N + kThreads * kBinSamples - 1) / (kThreads * kBinSamples), a->B);
  const size_t hist = tpi <= kHistTiles ? (size_t)tpi * sizeof(int) : 0;
  if (a->N > 0) {
    splat_bin_count<<<sample_grid, kThreads, hist + a->C * sizeof(unsigned), st>>>(
        a->g, a->v0, a->u0, a->counts, a->top, a->H, a->W, a->C, a->N, TY, TX);
    if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  }
  splat_bin_scan<<<1, kScanThreads, 0, st>>>(a->counts, a->cursor, a->slot_of, a->parts,
                                             reinterpret_cast<int2*>(a->extra), a->ctl, tiles,
                                             a->slots);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  if (a->N > 0) {
    splat_bin_scatter<<<sample_grid, kThreads, 2 * hist, st>>>(
        a->v0, a->u0, a->cursor, a->bins, a->ctl, a->merge, a->merge_cls, a->arrivals, a->H,
        a->W, a->C, a->N, TY, TX, groups);
    if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  }
  if (width <= 1) return launch_tiles<1>(*a, TY, TX, groups, width, log2n);
  if (width <= 2) return launch_tiles<2>(*a, TY, TX, groups, width, log2n);
  if (width <= 4) return launch_tiles<4>(*a, TY, TX, groups, width, log2n);
  if (width <= 8) return launch_tiles<8>(*a, TY, TX, groups, width, log2n);
  if (width <= 10) return launch_tiles<10>(*a, TY, TX, groups, width, log2n);
  if (width <= 12) return launch_tiles<12>(*a, TY, TX, groups, width, log2n);
  return launch_tiles<16>(*a, TY, TX, groups, width, log2n);
}

// Factored Gauss-Newton normal equations from rank-2 Jacobian factors.
//
// Replaces the Pallas TPU kernel fused_jtj_jtr
// (deep_prob_feature_track_tpu/ops/pallas/jtj.py:26 _kernel, entry :63).
// Per pixel p of image b the chained Jacobian is
// J[c,p,:] = alpha[c,p] u[p,:] + beta[c,p] v[p,:], so
//
//   A = sum_c alpha^2, Bx = sum_c alpha beta, Cc = sum_c beta^2,
//   ar = sum_c alpha r, br = sum_c beta r,
//   JtJ = sum_p u (A u + Bx v)^T + v (Bx u + Cc v)^T,
//   JtR = sign * sum_p (u ar + v br).
//
// The TPU version carries a VMEM accumulator across a sequential grid.
// Hopper blocks run in no order, so this is two passes with no float
// atomics, and the result is the same on every run:
//   1. jtj_partial: one block per (pixel tile, image).  Each thread walks
//      its pixels, collapses the C channels to the five scalars and adds
//      the 21 unique JtJ entries and 6 JtR entries in registers; the block
//      reduces them by warp shuffles and shared memory in a fixed order
//      and writes 27 partial sums for its tile.
//   2. jtj_final: one block per image sums its tiles' partials in tile order
//      and writes the symmetric 6x6 JtJ and sign * JtR.
// The work is bound by bytes (alpha, beta, r, u and v, each read once);
// about 260 flops a pixel is far below the card's compute rate.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kTile = 2048;  // pixels per block of the first pass
constexpr int kOut = 27;     // 21 upper-triangle JtJ entries + 6 JtR entries

__global__ void jtj_partial(const float* __restrict__ alpha,
                            const float* __restrict__ beta,
                            const float* __restrict__ res,
                            const float* __restrict__ u,
                            const float* __restrict__ v,
                            float* __restrict__ partial, int C, int HW,
                            int n_tiles) {
  const int tile = blockIdx.x;
  const int b = blockIdx.y;
  const int p_end = min(HW, (tile + 1) * kTile);
  float acc[kOut];
#pragma unroll
  for (int k = 0; k < kOut; ++k) acc[k] = 0.f;

  const long long chw = (long long)b * C * HW;
  for (int p = tile * kTile + threadIdx.x; p < p_end; p += kThreads) {
    float A = 0.f, Bx = 0.f, Cc = 0.f, ar = 0.f, br = 0.f;
    for (int c = 0; c < C; ++c) {
      const long long i = chw + (long long)c * HW + p;
      const float a = alpha[i], be = beta[i], r = res[i];
      A += a * a;
      Bx += a * be;
      Cc += be * be;
      ar += a * r;
      br += be * r;
    }
    const float* up = u + ((long long)b * HW + p) * 6;
    const float* vp = v + ((long long)b * HW + p) * 6;
    float uu[6], vv[6], l1[6], l2[6];
#pragma unroll
    for (int i = 0; i < 6; ++i) {
      uu[i] = up[i];
      vv[i] = vp[i];
      l1[i] = uu[i] * A + vv[i] * Bx;
      l2[i] = uu[i] * Bx + vv[i] * Cc;
    }
    int k = 0;
#pragma unroll
    for (int i = 0; i < 6; ++i) {
#pragma unroll
      for (int j = i; j < 6; ++j) acc[k++] += l1[i] * uu[j] + l2[i] * vv[j];
    }
#pragma unroll
    for (int i = 0; i < 6; ++i) acc[21 + i] += uu[i] * ar + vv[i] * br;
  }

  __shared__ float warp_sums[kThreads / 32][kOut];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
#pragma unroll
  for (int k = 0; k < kOut; ++k) {
    float x = acc[k];
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) x += __shfl_down_sync(0xffffffffu, x, off);
    if (lane == 0) warp_sums[warp][k] = x;
  }
  __syncthreads();
  if (threadIdx.x < kOut) {
    float s = 0.f;
    for (int w = 0; w < kThreads / 32; ++w) s += warp_sums[w][threadIdx.x];
    partial[((long long)b * n_tiles + tile) * kOut + threadIdx.x] = s;
  }
}

__global__ void jtj_final(const float* __restrict__ partial,
                          float* __restrict__ jtj, float* __restrict__ jtr,
                          int n_tiles, float sign) {
  const int b = blockIdx.x;
  const int k = threadIdx.x;
  if (k >= kOut) return;
  float s = 0.f;
  for (int t = 0; t < n_tiles; ++t) s += partial[((long long)b * n_tiles + t) * kOut + k];
  if (k >= 21) {
    jtr[b * 6 + (k - 21)] = sign * s;
    return;
  }
  // k -> (i, j) of the upper triangle, row-major
  int i = 0, row = 6;
  int kk = k;
  while (kk >= row) {
    kk -= row;
    --row;
    ++i;
  }
  const int j = i + kk;
  jtj[b * 36 + i * 6 + j] = s;
  jtj[b * 36 + j * 6 + i] = s;
}

}  // namespace

// The launch function's one argument; ops/kernels/jtj.py packs it with the
// struct format "8P4ifP" (native layout).
struct JtJArgs {
  const float* alpha;  // [B,C,HW], as beta and res
  const float* beta;
  const float* res;
  const float* u;  // [B,HW,6], as v
  const float* v;
  float* partial;  // scratch [B,n_tiles,27]
  float* jtj;      // [B,6,6]
  float* jtr;      // [B,6]
  int B, C, HW;
  int n_tiles;  // pixel tiles of the first pass as the caller allocated them
  float sign;
  void* stream;
};

// Returns the cudaError_t of the launches: cudaErrorInvalidValue when
// n_tiles is not ceil(HW / kTile).
extern "C" int fused_jtj_jtr_launch(const JtJArgs* a) {
  if (a->n_tiles != (a->HW + kTile - 1) / kTile) return (int)cudaErrorInvalidValue;
  if (a->B == 0) return 0;
  cudaStream_t s = (cudaStream_t)a->stream;
  jtj_partial<<<dim3(a->n_tiles, a->B), kThreads, 0, s>>>(
      a->alpha, a->beta, a->res, a->u, a->v, a->partial, a->C, a->HW, a->n_tiles);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  jtj_final<<<a->B, 32, 0, s>>>(a->partial, a->jtj, a->jtr, a->n_tiles, a->sign);
  return (int)cudaGetLastError();
}

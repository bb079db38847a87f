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
// Hopper blocks run in no order, and a sum across blocks needs either a
// second pass, float atomics (whose order, and so whose last bits, change
// from run to run: the Gauss-Newton loop amplifies them) or a cluster.  This
// is one launch with no atomics, and the result is the same on every run:
//
// - One thread-block cluster per image (grid = ranks x B, cluster = ranks x
//   1).  The launch picks the CTA's threads and the cluster's size from HW,
//   B and the card's SM count.  Measured on the H100, few large CTAs that
//   loop over many pixels beat many small ones, and a cluster costs more the
//   more CTAs it spans: so 512 threads once the work gives every SM a full
//   CTA (256 below), and ranks = the least power of two that gives every
//   thread a pixel group, but at most 8 (the portable limit) and no more
//   than B * ranks <= SMs.  At 120x160 B=8 that is 8 CTAs of 256 threads an
//   image, at B=64 two of 512, at 480x640 B=8 eight of 512.
// - A thread takes groups of 4 consecutive pixels, rank-interleaved over the
//   cluster: alpha/beta/res as float4 over p (3C loads of 16 bytes) and the
//   4 pixels' u and v rows as 6 + 6 float4 (96 contiguous bytes each).  This
//   needs HW % 4 == 0 and 16-byte-aligned bases; otherwise a thread takes
//   single pixels with scalar loads (G = 1).  It collapses the C channels to
//   the five scalars and adds the 21 unique JtJ entries and 6 JtR entries in
//   registers.
// - Each CTA reduces its 27 sums by warp shuffles and shared memory in a
//   fixed order.  After a cluster barrier, rank 0 reads its peers' sums
//   through distributed shared memory in rank order and writes the
//   symmetric JtJ and sign * JtR; a second barrier keeps the peers' shared
//   memory alive until it has.  Nothing outlives the launch: no scratch, no
//   counter, no memset.
//
// The work is bound by bytes (alpha, beta, r, u and v, each read once);
// about 10 C + 144 flops a pixel is far below the card's compute rate.

#include <cooperative_groups.h>
#include <cstdint>
#include <cuda_runtime.h>

namespace cg = cooperative_groups;

// The launch function's one argument; ops/kernels/jtj.py packs it with the
// struct format "7P3ifP" (native layout).
struct JtJArgs {
  const float* alpha;  // [B,C,HW], as beta and res
  const float* beta;
  const float* res;
  const float* u;  // [B,HW,6], as v
  const float* v;
  float* jtj;  // [B,6,6]
  float* jtr;  // [B,6]
  int B, C, HW;
  float sign;
  void* stream;
};

namespace {

constexpr int kOut = 27;       // 21 upper-triangle JtJ entries + 6 JtR entries
constexpr int kMaxCluster = 8;  // the portable limit

__device__ __forceinline__ void add_pixel(float (&acc)[kOut], const float* uu,
                                          const float* vv, float A, float Bx,
                                          float Cc, float ar, float br) {
  float l1[6], l2[6];
#pragma unroll
  for (int i = 0; i < 6; ++i) {
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

// G: pixels per thread and step, 4 (float4 loads) or 1 (scalar loads);
// T: threads per CTA
template <int G, int T>
__global__ void __launch_bounds__(T) fused_jtj_jtr_kernel(
    const float* __restrict__ alpha, const float* __restrict__ beta,
    const float* __restrict__ res, const float* __restrict__ u,
    const float* __restrict__ v, float* __restrict__ jtj,
    float* __restrict__ jtr, int C, int HW, float sign) {
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = (int)cluster.block_rank();
  const int ranks = (int)cluster.num_blocks();
  const int b = blockIdx.y;
  float acc[kOut];
#pragma unroll
  for (int k = 0; k < kOut; ++k) acc[k] = 0.f;

  const long long chw = (long long)b * C * HW;
  const int groups = HW / G;
#pragma unroll 2
  for (int q = rank * T + threadIdx.x; q < groups; q += ranks * T) {
    if constexpr (G == 4) {
      float A[4] = {}, Bx[4] = {}, Cc[4] = {}, ar[4] = {}, br[4] = {};
      const int hw4 = HW / 4;
      const float4* pa = reinterpret_cast<const float4*>(alpha + chw) + q;
      const float4* pb = reinterpret_cast<const float4*>(beta + chw) + q;
      const float4* pr = reinterpret_cast<const float4*>(res + chw) + q;
#pragma unroll 4
      for (int c = 0; c < C; ++c) {
        const float4 a4 = __ldg(pa + (long long)c * hw4);
        const float4 b4 = __ldg(pb + (long long)c * hw4);
        const float4 r4 = __ldg(pr + (long long)c * hw4);
        const float a[4] = {a4.x, a4.y, a4.z, a4.w};
        const float e[4] = {b4.x, b4.y, b4.z, b4.w};
        const float r[4] = {r4.x, r4.y, r4.z, r4.w};
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          A[i] += a[i] * a[i];
          Bx[i] += a[i] * e[i];
          Cc[i] += e[i] * e[i];
          ar[i] += a[i] * r[i];
          br[i] += e[i] * r[i];
        }
      }
      // the 4 pixels' u and v rows: 24 contiguous floats each
      const long long row = ((long long)b * HW + 4LL * q) * 6;
      const float4* pu = reinterpret_cast<const float4*>(u + row);
      const float4* pv = reinterpret_cast<const float4*>(v + row);
      float uu[24], vv[24];
#pragma unroll
      for (int m = 0; m < 6; ++m) {
        const float4 x = __ldg(pu + m);
        const float4 y = __ldg(pv + m);
        uu[4 * m] = x.x, uu[4 * m + 1] = x.y, uu[4 * m + 2] = x.z, uu[4 * m + 3] = x.w;
        vv[4 * m] = y.x, vv[4 * m + 1] = y.y, vv[4 * m + 2] = y.z, vv[4 * m + 3] = y.w;
      }
#pragma unroll
      for (int i = 0; i < 4; ++i)
        add_pixel(acc, uu + 6 * i, vv + 6 * i, A[i], Bx[i], Cc[i], ar[i], br[i]);
    } else {
      float A = 0.f, Bx = 0.f, Cc = 0.f, ar = 0.f, br = 0.f;
      for (int c = 0; c < C; ++c) {
        const long long i = chw + (long long)c * HW + q;
        const float a = __ldg(alpha + i), e = __ldg(beta + i), r = __ldg(res + i);
        A += a * a;
        Bx += a * e;
        Cc += e * e;
        ar += a * r;
        br += e * r;
      }
      const long long row = ((long long)b * HW + q) * 6;
      float uu[6], vv[6];
#pragma unroll
      for (int i = 0; i < 6; ++i) {
        uu[i] = __ldg(u + row + i);
        vv[i] = __ldg(v + row + i);
      }
      add_pixel(acc, uu, vv, A, Bx, Cc, ar, br);
    }
  }

  constexpr int kWarps = T / 32;
  __shared__ float warp_sums[kWarps][kOut];
  __shared__ float block_sums[kOut];
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
  const int k = threadIdx.x;
  if (k < kOut) {
    float s = 0.f;
    for (int w = 0; w < kWarps; ++w) s += warp_sums[w][k];
    block_sums[k] = s;
  }
  cluster.sync();  // every rank's block_sums written and visible

  if (rank == 0 && k < kOut) {
    float s = 0.f;
    for (int r = 0; r < ranks; ++r) s += *cluster.map_shared_rank(block_sums + k, r);
    if (k >= 21) {
      jtr[b * 6 + (k - 21)] = sign * s;
    } else {
      // k -> (i, j) of the upper triangle, row-major
      int i = 0, row = 6, kk = k;
      while (kk >= row) {
        kk -= row;
        --row;
        ++i;
      }
      const int j = i + kk;
      jtj[b * 36 + i * 6 + j] = s;
      jtj[b * 36 + j * 6 + i] = s;
    }
  }
  cluster.sync();  // the peers' shared memory lives until rank 0 has read it
}

template <int G, int T>
int launch(const JtJArgs& a, int sms) {
  const int groups = a.HW / G;
  const int need = (groups + T - 1) / T;  // CTAs that give every thread a group
  int ranks = 1;
  while (ranks < kMaxCluster && ranks < need && 2 * ranks * a.B <= sms) ranks *= 2;

  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = ranks;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(ranks, a.B);
  cfg.blockDim = dim3(T);
  cfg.dynamicSmemBytes = 0;
  cfg.stream = (cudaStream_t)a.stream;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  const cudaError_t e = cudaLaunchKernelEx(&cfg, fused_jtj_jtr_kernel<G, T>, a.alpha, a.beta,
                                           a.res, a.u, a.v, a.jtj, a.jtr, a.C, a.HW, a.sign);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}

template <int G>
int launch(const JtJArgs& a, int sms) {
  if ((long long)a.B * (a.HW / G) >= 512LL * sms) return launch<G, 512>(a, sms);
  return launch<G, 256>(a, sms);
}

bool aligned16(const void* p) { return reinterpret_cast<uintptr_t>(p) % 16 == 0; }

}  // namespace

// Returns the cudaError_t of the launch.
extern "C" int fused_jtj_jtr_launch(const JtJArgs* a) {
  if (a->B == 0) return 0;
  int device = 0, sms = 0;
  cudaError_t e = cudaGetDevice(&device);
  if (e == cudaSuccess) e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (e != cudaSuccess) return (int)e;
  if (a->HW % 4 == 0 && aligned16(a->alpha) && aligned16(a->beta) && aligned16(a->res) &&
      aligned16(a->u) && aligned16(a->v))
    return launch<4>(*a, sms);
  return launch<1>(*a, sms);
}

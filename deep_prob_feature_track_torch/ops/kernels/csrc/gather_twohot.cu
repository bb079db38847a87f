// Bilinear sample of a channels-last plane at (v0 + dv, u0 + du).
//
// Replaces the Pallas TPU kernel gather_twohot
// (deep_prob_feature_track_tpu/ops/pallas/gather.py:204 _kernel, entry :494):
//
//   out[b, c, n] = F[b, v0, u0, c] (1-du)(1-dv) + F[b, v0, u0+1, c] du (1-dv)
//                + F[b, v0+1, u0, c] (1-du) dv  + F[b, v0+1, u0+1, c] du dv
//
// The TPU version builds two-hot row/column matrices and contracts them on
// the MXU in bf16 hi/lo passes, because a TPU gather costs ~24 ns an index.
// On Hopper a gather is a plain load, but a warp-wide load whose 32 lanes
// hit 32 unrelated cache lines costs 32 L1 wavefronts.  One thread per
// sample looping over the channels issues exactly such loads (4*C of them a
// sample), so that design was bound by L1 wavefronts, not bytes.  Here the
// lanes cooperate over channels instead:
//
// 1. A CTA of S threads takes a run of S consecutive samples of one image.
//    The threads load the run's v0/u0/dv/du coalesced, clamp the starts to
//    [0, size-2] (an index that came from a NaN never reads outside the
//    plane) and put each sample's corner offset and weights in shared memory.
// 2. The CTA walks the flattened k = s*C + c with consecutive lanes: lane k
//    reads channel c of the four corners of sample s, so one warp-wide load
//    covers ~32/C samples' contiguous C-float corner runs, a few lines
//    instead of 32.  Where C is even and the plane 8-byte aligned, a lane
//    takes two channels with float2 loads (VEC = 2), half the instructions.
//    A run is 256 samples for C <= 32 and 32 above, so that the shared tile
//    of step 3 stays small.
// 3. The blend lands in a [S][C|1] shared tile (an odd row stride, so the
//    transposed reads of step 4 hit 32 banks); after a barrier each thread
//    stores its sample's C values to out[b, :, n], coalesced over n.
//
// The work is bound by bytes: the plane, the four coordinate arrays and the
// output, each moved once; the arithmetic is 7 flops per output value.
//
// The blend is evaluated in exactly the order of the plain version
// (gather.py:gather_twohot_ref and the JAX f32 path's _blend) with
// round-to-nearest intrinsics that the compiler never contracts into FMAs,
// so the kernel matches its plain version (and K2, K4) bit for bit: the
// tracker masks pixels by exact equality to the batch-global min/max of the
// warped sigma, and a last-bit difference would change which pixels are
// masked.

#include <cstdint>
#include <cuda_runtime.h>

// The launch function's one argument; ops/kernels/gather.py packs it with
// the struct format "6P5iP" (native layout).
struct GatherArgs {
  const float* F;  // [B,H,W,C]
  const int* v0;   // [B,N]
  const float* dv;
  const int* u0;
  const float* du;
  float* out;  // [B,C,N]
  int B, H, W, C, N;
  void* stream;
};

namespace {

constexpr int kRun = 256;      // threads (= samples) per CTA for C <= 32
constexpr int kWideRun = 32;   // for C > 32
constexpr size_t kMaxShared = 227 * 1024;

// w = (du, dv, 1-du, 1-dv)
__device__ __forceinline__ float blend(float c00, float c01, float c10,
                                       float c11, float4 w) {
  float r = __fmul_rn(__fmul_rn(c00, w.z), w.w);
  r = __fadd_rn(r, __fmul_rn(__fmul_rn(c01, w.x), w.w));
  r = __fadd_rn(r, __fmul_rn(__fmul_rn(c10, w.z), w.y));
  return __fadd_rn(r, __fmul_rn(__fmul_rn(c11, w.x), w.y));
}

size_t shared_bytes(int run, int C) {
  return (size_t)run * (sizeof(float4) + sizeof(int) + sizeof(float) * (C | 1));
}

template <int VEC>
__global__ void __launch_bounds__(kRun) gather_twohot_kernel(
    const float* __restrict__ F, const int* __restrict__ v0,
    const float* __restrict__ dv, const int* __restrict__ u0,
    const float* __restrict__ du, float* __restrict__ out, int H, int W, int C,
    int N) {
  extern __shared__ float4 smem[];
  const int S = blockDim.x;
  const int t = threadIdx.x;
  const int b = blockIdx.y;
  const int n0 = blockIdx.x * S;
  const int live = min(S, N - n0);
  const int Cp = C | 1;
  float4* weights = smem;                                     // [S]
  int* corner = reinterpret_cast<int*>(weights + S);          // [S]
  float* tile = reinterpret_cast<float*>(corner + S);         // [S][Cp]
  const float* Fb = F + (long long)b * H * W * C;

  if (t < live) {
    const long long i = (long long)b * N + n0 + t;
    const int vi = min(max(v0[i], 0), H - 2);
    const int ui = min(max(u0[i], 0), W - 2);
    const float fv = dv[i];
    const float fu = du[i];
    weights[t] = make_float4(fu, fv, __fsub_rn(1.0f, fu), __fsub_rn(1.0f, fv));
    corner[t] = (vi * W + ui) * C;
  }
  __syncthreads();

  // k = s*CV + j walks (sample s, channels j*VEC ..) with consecutive lanes;
  // s and j advance by S items a step without a division
  const int CV = C / VEC;
  const int items = live * CV;
  const int WC = W * C;
  const int ds = S / CV, dj = S - ds * CV;
  int s = t / CV, j = t - s * CV;
  for (int k = t; k < items; k += S) {
    const float4 w = weights[s];
    const float* p = Fb + corner[s] + j * VEC;
    float* o = tile + s * Cp + j * VEC;
    if (VEC == 2) {
      const float2 a = __ldg(reinterpret_cast<const float2*>(p));
      const float2 e = __ldg(reinterpret_cast<const float2*>(p + C));
      const float2 f = __ldg(reinterpret_cast<const float2*>(p + WC));
      const float2 h = __ldg(reinterpret_cast<const float2*>(p + WC + C));
      o[0] = blend(a.x, e.x, f.x, h.x, w);
      o[1] = blend(a.y, e.y, f.y, h.y, w);
    } else {
      o[0] = blend(__ldg(p), __ldg(p + C), __ldg(p + WC), __ldg(p + WC + C), w);
    }
    s += ds;
    j += dj;
    if (j >= CV) {
      j -= CV;
      ++s;
    }
  }
  __syncthreads();

  if (t < live) {
    float* o = out + (long long)b * C * N + n0 + t;
    const float* r = tile + t * Cp;
    for (int c = 0; c < C; ++c) o[(long long)c * N] = r[c];
  }
}

template <int VEC>
int launch(const GatherArgs& a, int run, size_t shared) {
  static size_t opted_in = 48 * 1024;  // dynamic shared memory allowed so far
  if (shared > opted_in) {
    const cudaError_t e = cudaFuncSetAttribute(
        gather_twohot_kernel<VEC>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)shared);
    if (e != cudaSuccess) return (int)e;
    opted_in = shared;
  }
  const dim3 grid((a.N + run - 1) / run, a.B);
  gather_twohot_kernel<VEC><<<grid, run, shared, (cudaStream_t)a.stream>>>(
      a.F, a.v0, a.dv, a.u0, a.du, a.out, a.H, a.W, a.C, a.N);
  return (int)cudaGetLastError();
}

}  // namespace

// Returns the cudaError_t of the launch: cudaErrorInvalidValue for a C
// whose tile does not fit shared memory (C > ~1800).
extern "C" int gather_twohot_launch(const GatherArgs* a) {
  if (a->B == 0 || a->N == 0 || a->C == 0) return 0;
  const int run = a->C <= 32 ? kRun : kWideRun;
  const size_t shared = shared_bytes(run, a->C);
  if (shared > kMaxShared) return (int)cudaErrorInvalidValue;
  if (a->C % 2 == 0 && reinterpret_cast<uintptr_t>(a->F) % 8 == 0)
    return launch<2>(*a, run, shared);
  return launch<1>(*a, run, shared);
}

// Bilinear sample of a channels-last plane at (v0 + dv, u0 + du): K1
// (gather_twohot) and, with the two within-cell derivative maps that the
// training backward contracts with the output cotangent, K2
// (gather_twohot_grads).
//
// Replaces the Pallas TPU kernels gather_twohot and gather_twohot_grads
// (deep_prob_feature_track_tpu/ops/pallas/gather.py:204 _kernel, entry :494;
// :234 _grads_kernel, entry :514):
//
//   out = c00 (1-du)(1-dv) + c01 du (1-dv) + c10 (1-du) dv + c11 du dv
//   gx  = (c01 - c00)(1-dv) + (c11 - c10) dv
//   gy  = (c10 - c00)(1-du) + (c11 - c01) du
//
// with cYX = F[b, v0+Y, u0+X, c], written to [B, C, N].
//
// The TPU versions build two-hot row/column matrices and contract them on
// the MXU in bf16 hi/lo passes, because a TPU gather costs ~24 ns an index.
// On Hopper a gather is a plain load, but a warp-wide load whose 32 lanes
// hit 32 unrelated cache lines costs 32 L1 wavefronts.  One thread per
// sample looping over the channels issues exactly such loads (4*C of them a
// sample) on scattered coordinates, so that design is bound by L1
// wavefronts, not bytes, there.  On the tracker's common coordinates, a
// smooth warp of the raster grid, the same loop reads neighbouring samples'
// contiguous corner runs and stores coalesced over n, with nothing staged.
//
// K1: the lanes cooperate over channels.
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
// K2 writes three outputs, and K1's design alone loses to the thread per
// sample on smooth coordinates, measured on the H100 (three tiles of 256
// samples cap an SM at five CTAs, and the transpose costs more than the
// loads it saves).  So a K2 CTA of 256 samples stages as K1 does, counts
// the run's jumps (samples whose clamped start lies more than kNear cells
// from the previous sample's) with one barrier, and picks its path, the
// same for the whole CTA:
// - compact, at most one jump in kJumpShare samples (a smooth warp, a few
//   samples moved far away, a zoom clamped to the border), or a plane of at
//   most kSmallPlane cells (every corner run a few lines from the others,
//   where the scattered path's chunks only add latency): each thread
//   blends its own sample, float2 over channel pairs where VEC = 2, and
//   stores out, gx, gy coalesced over n.  Neighbouring lanes read
//   neighbouring corner runs, so a warp load touches a few lines.
// - scattered: K1's cooperative walk, in chunks of kGradsChunk samples whose
//   three outputs turn through three [chunk][C|1] tiles, stored by 3 x chunk
//   threads coalesced over n.  Small chunks keep a CTA's shared memory at
//   13 KB (C = 10), so that registers, not shared memory, bound how many
//   CTAs (compact ones too) an SM holds.
//
// The work is bound by bytes: the plane, the four coordinate arrays and the
// outputs, each moved once; the arithmetic is 7 flops per output value (15
// per channel for K2).
//
// The blend is evaluated in exactly the order of the plain versions
// (gather.py:gather_twohot_ref, gather_grads.py:gather_twohot_grads_ref and
// the JAX f32 path's _blend) with round-to-nearest intrinsics that the
// compiler never contracts into FMAs, and K1 and K2 share it, so `out` is
// the same bits from K1, K2 (and K4, K5) and the plain versions on every
// path: the tracker masks pixels by exact equality to the batch-global
// min/max of the warped sigma, and a last-bit difference would change which
// pixels are masked.  gx and gy follow the plain version's order in the
// same way.
//
// K2's bf16 mode (the training mode bf16_residuals, the JAX package's
// DPFT_BF16_RESIDUALS=1): gx and gy are stored as bfloat16, each computed in
// float32 as above and rounded once, at the store, with __float2bfloat16_rn
// (to nearest even, as torch's .to(torch.bfloat16) and JAX's
// astype(bfloat16) round), so they are the bits of the float32 maps cast
// after.  The scattered path's tiles stay float32.  A (b, c, n) then writes
// 4 + 2 + 2 bytes instead of 12; nothing else changes.

#include <cstdint>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

// The launch functions' one argument each; ops/kernels/gather.py packs
// GatherArgs with the struct format "6P5iP", ops/kernels/gather_grads.py
// GatherGradsArgs with "8P6iP" (native layout).
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

struct GatherGradsArgs {
  const float* F;  // [B,H,W,C]
  const int* v0;   // [B,N]
  const float* dv;
  const int* u0;
  const float* du;
  float* out;  // [B,C,N], as gx and gy
  void* gx;    // float, or __nv_bfloat16 where bf16
  void* gy;
  int B, H, W, C, N;
  int bf16;  // store gx and gy as bfloat16
  void* stream;
};

namespace {

constexpr int kRun = 256;      // threads (= samples) per CTA for C <= 32
constexpr int kWideRun = 32;   // for C > 32
constexpr size_t kMaxShared = 227 * 1024;
constexpr int kGradsRun = 256;   // K2: threads (= samples) per CTA
constexpr int kGradsChunk = 64;  // K2: samples per tile turn, C <= 32
constexpr int kNear = 4;         // K2: cells between neighbouring starts that are no jump
constexpr int kJumpShare = 4;    // K2: a run with at most 1 jump in 4 samples is compact
constexpr int kSmallPlane = 2 * kGradsRun;  // K2: cells of a plane that is always compact

// w = (du, dv, 1-du, 1-dv)
__device__ __forceinline__ float blend(float c00, float c01, float c10,
                                       float c11, float4 w) {
  float r = __fmul_rn(__fmul_rn(c00, w.z), w.w);
  r = __fadd_rn(r, __fmul_rn(__fmul_rn(c01, w.x), w.w));
  r = __fadd_rn(r, __fmul_rn(__fmul_rn(c10, w.z), w.y));
  return __fadd_rn(r, __fmul_rn(__fmul_rn(c11, w.x), w.y));
}

__device__ __forceinline__ float grad_u(float c00, float c01, float c10,
                                        float c11, float4 w) {
  return __fadd_rn(__fmul_rn(__fsub_rn(c01, c00), w.w),
                   __fmul_rn(__fsub_rn(c11, c10), w.y));
}

__device__ __forceinline__ float grad_v(float c00, float c01, float c10,
                                        float c11, float4 w) {
  return __fadd_rn(__fmul_rn(__fsub_rn(c10, c00), w.z),
                   __fmul_rn(__fsub_rn(c11, c01), w.x));
}

// a derivative map's store: float as it is, bfloat16 rounded to nearest even
__device__ __forceinline__ void put(float* p, float x) { *p = x; }
__device__ __forceinline__ void put(__nv_bfloat16* p, float x) { *p = __float2bfloat16_rn(x); }

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

// K2's chunk: kGradsChunk samples, 32 above C = 32 (3 x chunk <= kGradsRun)
int grads_chunk(int C) { return C <= 32 ? kGradsChunk : 32; }

size_t grads_shared_bytes(int C) {
  return (size_t)kGradsRun * (sizeof(float4) + sizeof(int)) +
         (size_t)3 * grads_chunk(C) * sizeof(float) * (C | 1);
}

template <int VEC, typename G>
__global__ void __launch_bounds__(kGradsRun) gather_twohot_grads_kernel(
    const float* __restrict__ F, const int* __restrict__ v0,
    const float* __restrict__ dv, const int* __restrict__ u0,
    const float* __restrict__ du, float* __restrict__ out,
    G* __restrict__ gx, G* __restrict__ gy, int H, int W, int C, int N,
    int chunk) {
  extern __shared__ float4 smem[];
  const int S = kGradsRun;
  const int t = threadIdx.x;
  const int b = blockIdx.y;
  const int n0 = blockIdx.x * S;
  const int live = min(S, N - n0);
  const int Cp = C | 1;
  float4* weights = smem;                                     // [S]
  int* corner = reinterpret_cast<int*>(weights + S);          // [S]
  float* tiles = reinterpret_cast<float*>(corner + S);        // [3][chunk][Cp]
  const float* Fb = F + (long long)b * H * W * C;
  const long long ob = (long long)b * C * N + n0;
  const int WC = W * C;

  float4 w = make_float4(0.f, 0.f, 0.f, 0.f);
  int my = 0;
  if (t < live) {
    const long long i = (long long)b * N + n0 + t;
    const int vi = min(max(v0[i], 0), H - 2);
    const int ui = min(max(u0[i], 0), W - 2);
    const float fv = dv[i];
    const float fu = du[i];
    w = make_float4(fu, fv, __fsub_rn(1.0f, fu), __fsub_rn(1.0f, fv));
    my = (vi * W + ui) * C;
    weights[t] = w;
    corner[t] = my;
  }
  __syncthreads();
  // a jump: a sample whose start is more than kNear cells from the previous one's
  const int jumps = __syncthreads_count(t > 0 && t < live && abs(my - corner[t - 1]) > kNear * C);

  if (jumps * kJumpShare <= live || H * W <= kSmallPlane) {  // compact: a thread per sample
    if (t < live) {
      const float* p = Fb + my;
      for (int c = 0; c < C; c += VEC) {
        const long long i = ob + t + (long long)c * N;
        if (VEC == 2) {
          const float2 a = __ldg(reinterpret_cast<const float2*>(p + c));
          const float2 e = __ldg(reinterpret_cast<const float2*>(p + c + C));
          const float2 f = __ldg(reinterpret_cast<const float2*>(p + c + WC));
          const float2 h = __ldg(reinterpret_cast<const float2*>(p + c + WC + C));
          out[i] = blend(a.x, e.x, f.x, h.x, w);
          put(gx + i, grad_u(a.x, e.x, f.x, h.x, w));
          put(gy + i, grad_v(a.x, e.x, f.x, h.x, w));
          out[i + N] = blend(a.y, e.y, f.y, h.y, w);
          put(gx + i + N, grad_u(a.y, e.y, f.y, h.y, w));
          put(gy + i + N, grad_v(a.y, e.y, f.y, h.y, w));
        } else {
          const float a = __ldg(p + c), e = __ldg(p + c + C), f = __ldg(p + c + WC),
                      h = __ldg(p + c + WC + C);
          out[i] = blend(a, e, f, h, w);
          put(gx + i, grad_u(a, e, f, h, w));
          put(gy + i, grad_v(a, e, f, h, w));
        }
      }
    }
    return;
  }

  // scattered: K1's cooperative walk, one chunk of samples at a time
  const int CV = C / VEC;
  const int ds = S / CV, dj = S - ds * CV;
  const int s0 = t / CV, j0 = t - s0 * CV;
  const int plane = chunk * Cp;
  for (int c0 = 0; c0 < live; c0 += chunk) {
    const int n = min(chunk, live - c0);
    int s = s0, j = j0;
    for (int k = t; k < n * CV; k += S) {
      const float4 ws = weights[c0 + s];
      const float* p = Fb + corner[c0 + s] + j * VEC;
      const int o = s * Cp + j * VEC;
      if (VEC == 2) {
        const float2 a = __ldg(reinterpret_cast<const float2*>(p));
        const float2 e = __ldg(reinterpret_cast<const float2*>(p + C));
        const float2 f = __ldg(reinterpret_cast<const float2*>(p + WC));
        const float2 h = __ldg(reinterpret_cast<const float2*>(p + WC + C));
        tiles[o] = blend(a.x, e.x, f.x, h.x, ws);
        tiles[o + 1] = blend(a.y, e.y, f.y, h.y, ws);
        tiles[plane + o] = grad_u(a.x, e.x, f.x, h.x, ws);
        tiles[plane + o + 1] = grad_u(a.y, e.y, f.y, h.y, ws);
        tiles[2 * plane + o] = grad_v(a.x, e.x, f.x, h.x, ws);
        tiles[2 * plane + o + 1] = grad_v(a.y, e.y, f.y, h.y, ws);
      } else {
        const float a = __ldg(p), e = __ldg(p + C), f = __ldg(p + WC), h = __ldg(p + WC + C);
        tiles[o] = blend(a, e, f, h, ws);
        tiles[plane + o] = grad_u(a, e, f, h, ws);
        tiles[2 * plane + o] = grad_v(a, e, f, h, ws);
      }
      s += ds;
      j += dj;
      if (j >= CV) {
        j -= CV;
        ++s;
      }
    }
    __syncthreads();
    // thread x = which * n + sm stores output `which` of sample sm
    for (int x = t; x < 3 * n; x += S) {
      const int which = x / n, sm = x - which * n;
      const float* r = tiles + which * plane + sm * Cp;
      const long long o = ob + c0 + sm;
      if (which == 0) {
        for (int c = 0; c < C; ++c) out[o + (long long)c * N] = r[c];
      } else {
        G* dst = which == 1 ? gx : gy;
        for (int c = 0; c < C; ++c) put(dst + o + (long long)c * N, r[c]);
      }
    }
    __syncthreads();
  }
}

template <int VEC, typename G>
int launch_grads(const GatherGradsArgs& a, size_t shared) {
  static size_t opted_in = 48 * 1024;  // dynamic shared memory allowed so far
  if (shared > opted_in) {
    const cudaError_t e = cudaFuncSetAttribute(
        gather_twohot_grads_kernel<VEC, G>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)shared);
    if (e != cudaSuccess) return (int)e;
    opted_in = shared;
  }
  const dim3 grid((a.N + kGradsRun - 1) / kGradsRun, a.B);
  gather_twohot_grads_kernel<VEC, G><<<grid, kGradsRun, shared, (cudaStream_t)a.stream>>>(
      a.F, a.v0, a.dv, a.u0, a.du, a.out, static_cast<G*>(a.gx), static_cast<G*>(a.gy), a.H,
      a.W, a.C, a.N, grads_chunk(a.C));
  return (int)cudaGetLastError();
}

template <int VEC>
int launch_grads(const GatherGradsArgs& a, size_t shared) {
  return a.bf16 ? launch_grads<VEC, __nv_bfloat16>(a, shared) : launch_grads<VEC, float>(a, shared);
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

// As gather_twohot_launch, with the derivative maps gx and gy (bfloat16
// where a->bf16): a C whose tiles do not fit shared memory (C > ~590) is
// refused.
extern "C" int gather_twohot_grads_launch(const GatherGradsArgs* a) {
  if (a->B == 0 || a->N == 0 || a->C == 0) return 0;
  const size_t shared = grads_shared_bytes(a->C);
  if (shared > kMaxShared) return (int)cudaErrorInvalidValue;
  if (a->C % 2 == 0 && reinterpret_cast<uintptr_t>(a->F) % 8 == 0)
    return launch_grads<2>(*a, shared);
  return launch_grads<1>(*a, shared);
}

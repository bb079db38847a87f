// Training-forward bilinear sample: the blend of K1 plus the two within-cell
// derivative maps that the backward contracts with the output cotangent.
//
// Replaces the Pallas TPU kernel gather_twohot_grads
// (deep_prob_feature_track_tpu/ops/pallas/gather.py:234 _grads_kernel,
// entry :514), whose function is the XLA path's _corner_grads_oneshot
// (geometry/warp.py:304-314):
//
//   out = c00 (1-du)(1-dv) + c01 du (1-dv) + c10 (1-du) dv + c11 du dv
//   gx  = (c01 - c00)(1-dv) + (c11 - c10) dv
//   gy  = (c10 - c00)(1-du) + (c11 - c01) du
//
// with cYX = F[b, v0+Y, u0+X, c].  The TPU version contracts two-hot row and
// column matrices on the MXU in bf16 hi/lo passes (five per block); here one
// thread per (b, n) sample reads the four corner C-vectors once and writes
// out/gx/gy[b, :, n], so stores are coalesced over n.  The work is bound by
// bytes (the plane, four coordinate arrays and three outputs, each moved
// once); the arithmetic is 15 flops per output channel.
//
// `out` is evaluated in exactly K1's order with round-to-nearest intrinsics
// that the compiler never contracts into FMAs, so it is bit-identical to K1
// and to the plain version: the tracker masks pixels whose warped sigma equals
// the batch-global min/max exactly.  gx and gy follow the plain version's
// order in the same way.
//
// Corner starts are clamped to [0, size-2] here as well, so an index that
// came from a NaN coordinate can never read outside the plane.

#include <cuda_runtime.h>

namespace {

__global__ void gather_twohot_grads_kernel(const float* __restrict__ F,
                                           const int* __restrict__ v0,
                                           const float* __restrict__ dv,
                                           const int* __restrict__ u0,
                                           const float* __restrict__ du,
                                           float* __restrict__ out,
                                           float* __restrict__ gx,
                                           float* __restrict__ gy, int H,
                                           int W, int C, int N) {
  const int n = blockIdx.x * blockDim.x + threadIdx.x;
  const int b = blockIdx.y;
  if (n >= N) return;
  const long long s = (long long)b * N + n;
  const int vi = min(max(v0[s], 0), H - 2);
  const int ui = min(max(u0[s], 0), W - 2);
  const float fv = dv[s];
  const float fu = du[s];
  const float omu = __fsub_rn(1.0f, fu);
  const float omv = __fsub_rn(1.0f, fv);

  const float* p00 = F + (((long long)b * H + vi) * W + ui) * C;
  const float* p01 = p00 + C;
  const float* p10 = p00 + (long long)W * C;
  const float* p11 = p10 + C;
  const long long o = (long long)b * C * N + n;
  for (int c = 0; c < C; ++c) {
    const float c00 = p00[c], c01 = p01[c], c10 = p10[c], c11 = p11[c];
    float r = __fmul_rn(__fmul_rn(c00, omu), omv);
    r = __fadd_rn(r, __fmul_rn(__fmul_rn(c01, fu), omv));
    r = __fadd_rn(r, __fmul_rn(__fmul_rn(c10, omu), fv));
    r = __fadd_rn(r, __fmul_rn(__fmul_rn(c11, fu), fv));
    const float x = __fadd_rn(__fmul_rn(__fsub_rn(c01, c00), omv),
                              __fmul_rn(__fsub_rn(c11, c10), fv));
    const float y = __fadd_rn(__fmul_rn(__fsub_rn(c10, c00), omu),
                              __fmul_rn(__fsub_rn(c11, c01), fu));
    const long long i = o + (long long)c * N;
    out[i] = r;
    gx[i] = x;
    gy[i] = y;
  }
}

}  // namespace

// The launch function's one argument; ops/kernels/gather_grads.py packs it
// with the struct format "8P5iP" (native layout).
struct GatherGradsArgs {
  const float* F;  // [B,H,W,C]
  const int* v0;   // [B,N]
  const float* dv;
  const int* u0;
  const float* du;
  float* out;  // [B,C,N], as gx and gy
  float* gx;
  float* gy;
  int B, H, W, C, N;
  void* stream;
};

// Returns the cudaError_t of the launch.
extern "C" int gather_twohot_grads_launch(const GatherGradsArgs* a) {
  if (a->B == 0 || a->N == 0) return 0;
  const int threads = 256;
  dim3 grid((a->N + threads - 1) / threads, a->B);
  gather_twohot_grads_kernel<<<grid, threads, 0, (cudaStream_t)a->stream>>>(
      a->F, a->v0, a->dv, a->u0, a->du, a->out, a->gx, a->gy, a->H, a->W, a->C,
      a->N);
  return (int)cudaGetLastError();
}

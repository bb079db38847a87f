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
// in VMEM across a sequential grid.  Hopper has no sequential grid but has
// fast float atomics in L2, so this kernel is one thread per (b, c, n): it
// reads g[b, c, n] (the [B,C,N] layout the autograd backward hands over,
// coalesced over n) and adds its four weighted values into a plane that the
// launch function zeroes first.  The work is bound by bytes (the cotangent,
// four coordinate arrays, and the plane written once); the atomics land in
// L2, where the plane (B*H*W*C*4 bytes, 49 MB at 120x160 B=64 C=10) mostly
// stays.
//
// Atomic adds take the samples in an order that changes from run to run, so
// the result agrees with the plain version within a tolerance, not bit for
// bit.  Corner starts are clamped to [0, size-2] as in the gather.

#include <cuda_runtime.h>

namespace {

__global__ void splat_twohot_kernel(const float* __restrict__ g,
                                    const int* __restrict__ v0,
                                    const float* __restrict__ dv,
                                    const int* __restrict__ u0,
                                    const float* __restrict__ du,
                                    float* __restrict__ d_op, int H, int W,
                                    int C, int N) {
  const int n = blockIdx.x * blockDim.x + threadIdx.x;
  const int c = blockIdx.y;
  const int b = blockIdx.z;
  if (n >= N) return;
  const long long s = (long long)b * N + n;
  const int vi = min(max(v0[s], 0), H - 2);
  const int ui = min(max(u0[s], 0), W - 2);
  const float fv = dv[s];
  const float fu = du[s];
  const float omu = 1.0f - fu;
  const float omv = 1.0f - fv;
  const float gv = g[((long long)b * C + c) * N + n];

  float* p00 = d_op + (((long long)b * H + vi) * W + ui) * C + c;
  float* p10 = p00 + (long long)W * C;
  atomicAdd(p00, gv * omu * omv);
  atomicAdd(p00 + C, gv * fu * omv);
  atomicAdd(p10, gv * omu * fv);
  atomicAdd(p10 + C, gv * fu * fv);
}

}  // namespace

// g [B,C,N] f32; v0,u0 [B,N] int32; dv,du [B,N] f32; d_op [B,H,W,C] f32,
// zeroed here before the splat.  Returns the first cudaError_t.
extern "C" int splat_twohot_launch(const float* g, const int* v0,
                                   const float* dv, const int* u0,
                                   const float* du, float* d_op, int B, int H,
                                   int W, int C, int N, void* stream) {
  const cudaStream_t st = (cudaStream_t)stream;
  const size_t plane = (size_t)B * H * W * C * sizeof(float);
  cudaError_t err = cudaMemsetAsync(d_op, 0, plane, st);
  if (err != cudaSuccess || B == 0 || N == 0 || C == 0) return (int)err;
  const int threads = 256;
  dim3 grid((N + threads - 1) / threads, C, B);
  splat_twohot_kernel<<<grid, threads, 0, st>>>(g, v0, dv, u0, du, d_op, H, W,
                                                C, N);
  return (int)cudaGetLastError();
}

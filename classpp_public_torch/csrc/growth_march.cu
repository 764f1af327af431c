// The growth-factor march D(a), f(a) in ONE launch of one block.
//
// Replaces classpp_public_tpu/ops/ode.py `rk4_fixed` (:305-326, a lax.scan of
// RK4 sub-steps) as called for the growth factor at
// classpp_public_tpu/models/background.py:818-835; its plain version is
// `growth_march_plain` in classpp_public_torch/models/background.py. The code
// is growth_march.cuh.
//
// Design: the block's threads first evaluate the background spline at every
// time the RK4 sub-steps read (4096 nodes x 2 sub-steps x 3 times: ~25 000
// independent evaluations) into a coefficient table in global memory; then
// thread 0 runs the 8190 dependent sub-steps (four right-hand sides of a few
// multiply-adds each, one division-free chain); then the block normalises D
// and writes f. What bounds it: the serial chain of the second phase.

#include <cuda_runtime.h>

#include "growth_march.cuh"

namespace {

constexpr int kThreads = 256;

__global__ void __launch_bounds__(kThreads)
growth_march_kernel(gm::Spline S, const double* __restrict__ ts, const double* __restrict__ aH,
                    int n, int substeps, double y00, double y01, double* __restrict__ coef,
                    double* __restrict__ Y, double* __restrict__ out) {
  gm::coef_table(S, ts, n, substeps, (int)threadIdx.x, kThreads, coef);
  __syncthreads();
  if (threadIdx.x == 0) gm::march(ts, n, substeps, coef, y00, y01, Y);
  __syncthreads();
  gm::normalise(Y, aH, n, (int)threadIdx.x, kThreads, out);
}

}  // namespace

// y, y2: the (n_spl, 3) spline of (rho_m, a, H) over ln a = x0 + i dx; ts
// (n): the march's nodes; aH (n): a H at the nodes; y00, y01: D and D' at
// ts[0]; coef: scratch of gm::coef_doubles(n, substeps) doubles; Y: scratch
// (n, 2); out (2, n): D, f. Every pointer is a device pointer.
extern "C" int growth_march_launch(const double* y, const double* y2, double x0, double dx,
                                   int n_spl, const double* ts, const double* aH, int n,
                                   int substeps, double y00, double y01, double* coef,
                                   double* Y, double* out, void* stream) {
  if (n < 2 || n_spl < 2 || substeps < 1) return (int)cudaErrorInvalidValue;
  const gm::Spline S{y, y2, x0, dx, n_spl};
  growth_march_kernel<<<1, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      S, ts, aH, n, substeps, y00, y01, coef, Y, out);
  return (int)cudaGetLastError();
}

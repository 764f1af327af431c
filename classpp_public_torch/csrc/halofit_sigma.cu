// Halofit Gaussian-window sums: for every redshift z and every radius R,
//   s1 = int D2(k) e^{-k^2 R^2} dln k,  D2 = k^3 P(k) / (2 pi^2)
//   s2 = int D2(k) 2 k^2 R^2 e^{-k^2 R^2} dln k
//   s3 = int D2(k) 4 k^2 R^2 (1 - k^2 R^2) e^{-k^2 R^2} dln k
// by the trapezoid rule in ln k on the halofit k grid.
//
// Replaces the sigma(R) sums of the jitted halofit program of
// classpp_public_tpu/models/nonlinear.py (`_halofit_core` :433-491, the sums
// of `_halofit_one_z` :119-133), whose plain PyTorch version is
// `halofit_sums_plain` in classpp_public_torch/models/nonlinear.py.
//
// Design: one block per (z, R). Its 128 threads stride over the k grid, each
// keeping three partial sums in registers; the partials are then added in
// shared memory by a binary tree whose order is fixed by the thread index
// (no atomics), so the result is the same from run to run. What bounds it on
// an H100: operations in principle (one exp and two log per (z, R, k), about
// 450 k points for 24 x 160 blocks, against 1.7 MB of input), in practice the
// launch itself: the whole grid is a few microseconds of work.

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kThreads = 128;

__global__ void halofit_sigma_kernel(const double* __restrict__ base,  // (nz, nk) P k^2 / (2 pi^2)
                                     const double* __restrict__ k,     // (nk,)
                                     const double* __restrict__ R,     // (nz, nR)
                                     int nk, int nR,
                                     double* __restrict__ out) {       // (nz, nR, 3)
  __shared__ double sh[3][kThreads];
  const int iz = blockIdx.y, ir = blockIdx.x, t = threadIdx.x;
  const double r = R[(long)iz * nR + ir];
  const double* b = base + (long)iz * nk;
  double s1 = 0.0, s2 = 0.0, s3 = 0.0;
  for (int i = t; i < nk; i += kThreads) {
    // trapezoid weight of node i in ln k
    const double lo = log(k[i > 0 ? i - 1 : 0]), hi = log(k[i < nk - 1 ? i + 1 : nk - 1]);
    const double ki = k[i], kr = ki * r, x2 = kr * kr;
    const double f = b[i] * exp(-x2) * ki * (0.5 * (hi - lo));
    s1 += f;
    s2 += f * 2.0 * x2;
    s3 += f * 4.0 * x2 * (1.0 - x2);
  }
  sh[0][t] = s1; sh[1][t] = s2; sh[2][t] = s3;
  __syncthreads();
  for (int half = kThreads / 2; half > 0; half >>= 1) {
    if (t < half) {
      sh[0][t] += sh[0][t + half];
      sh[1][t] += sh[1][t + half];
      sh[2][t] += sh[2][t + half];
    }
    __syncthreads();
  }
  if (t < 3) out[((long)iz * nR + ir) * 3 + t] = sh[t][0];
}

}  // namespace

// All pointers are device pointers to contiguous float64.
extern "C" int halofit_sigma_launch(const double* base, const double* k, const double* R,
                                    int nz, int nk, int nR, double* out, void* stream) {
  if (nz < 1 || nR < 1 || nk < 2 || nz > 65535) return (int)cudaErrorInvalidValue;
  halofit_sigma_kernel<<<dim3(nR, nz), kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      base, k, R, nk, nR, out);
  return (int)cudaGetLastError();
}

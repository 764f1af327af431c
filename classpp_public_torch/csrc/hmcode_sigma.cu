// HMcode top-hat sigma integrals: for every spectrum s and every radius R,
//   sig2    = int D2(k) W(kR)^2 dln k,              D2 = k^3 P(k) / (2 pi^2)
//   dsig2dR = int D2(k) 2 k W(kR) W'(kR) dln k
//   sigd2   = int D2(k) / k^2 / 3 W(kR)^2 dln k     (the 1D displacement)
// by the trapezoid rule in ln k on one log-k grid, each node weighted by half
// the ln k span of its two neighbours (numpy.trapezoid's sum, reordered).
// W(x) = 3 (sin x - x cos x) / x^3 and W'(x) = 3 sin x / x^2 - 9 (sin x -
// x cos x) / x^4, with W = 1 - x^2/10, W' = -x/5 below x = 0.01.
//
// Replaces the eager sigma integrals of the JAX HMcode
// (classpp_public_tpu/models/nonlinear.py `_sigma_integrals` :211 and
// `_sigma_disp` :234, called from `_hmcode_one_z` :273); the plain PyTorch
// version is `hmcode_sigma_plain` in classpp_public_torch/models/nonlinear.py.
//
// Design: one block per (spectrum, R). Its 128 threads stride over the k
// grid, each keeping three partial sums in registers; the partials are added
// in shared memory by a binary tree whose order is fixed by the thread index
// (no atomics), so the result is the same from run to run. The per-node
// arithmetic is `hmcode::sigma_node` (hmcode.cuh).

#include <cuda_runtime.h>

#include "hmcode.cuh"

namespace {

constexpr int kThreads = hmcode::kSigmaThreads;

__global__ void hmcode_sigma_kernel(const double* __restrict__ base,  // (nspec, nk)
                                    const double* __restrict__ k,     // (nk,)
                                    const double* __restrict__ lnk,   // (nk,)
                                    const double* __restrict__ R,     // (nspec, nR)
                                    int nk, int nR,
                                    double* __restrict__ out) {       // (nspec, nR, 3)
  __shared__ double sh[3][kThreads];
  const int is = blockIdx.y, ir = blockIdx.x, t = threadIdx.x;
  const double r = R[(long)is * nR + ir];
  const double* b = base + (long)is * nk;
  double s1 = 0.0, s2 = 0.0, s3 = 0.0;
  for (int i = t; i < nk; i += kThreads) hmcode::sigma_node(b, k, lnk, nk, i, r, &s1, &s2, &s3);
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
  if (t < 3) out[((long)is * nR + ir) * 3 + t] = sh[t][0];
}

}  // namespace

// All pointers are device pointers to contiguous float64.
extern "C" int hmcode_sigma_launch(const double* base, const double* k, const double* lnk,
                                   const double* R, int nspec, int nk, int nR, double* out,
                                   void* stream) {
  if (nspec < 1 || nR < 1 || nk < 2 || nspec > 65535) return (int)cudaErrorInvalidValue;
  hmcode_sigma_kernel<<<dim3(nR, nspec), kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      base, k, lnk, R, nk, nR, out);
  return (int)cudaGetLastError();
}

// HMcode one-halo integral: for every row (a redshift of the total or the
// cdm + baryon spectrum) and every k,
//   p1h = int m g_ST(nu) W_NFW(nu^eta k, r_v, c)^2 [nu <= 10] dnu
// over the row's 256 masses, by the trapezoid rule in nu (each node weighted
// by half the nu span of its two neighbours; the nu grid differs per row and
// is not uniform). g_ST = 0.21616 (1 + (0.707 nu^2)^-0.3) exp(-0.707 nu^2 / 2)
// is the Sheth-Tormen mass function; W_NFW the Fourier transform of the NFW
// profile through Si and Ci (special.cuh). Nodes with nu > 10 add nothing but
// keep their place in the weights, as in the JAX code.
//
// Replaces the eager one-halo term of the JAX HMcode
// (classpp_public_tpu/models/nonlinear.py:349-358, `_window_nfw` :246 and
// classpp_public_tpu/ops/special.py:25 `si_ci`); the plain PyTorch version is
// `hmcode_onehalo_plain` in classpp_public_torch/models/nonlinear.py. The
// window keeps the JAX expression cos(ks) (Ci2 - Ci1) + sin(ks) (Si2 - Si1) -
// sin(c ks) / (ks (1 + c)), whose terms cancel at small ks: the kernel is held
// to the plain version, and through it to JAX, not to a better formula.
//
// Design: one block per (row, k). Its 256 threads take one mass each (a
// stride beyond 256 masses), each evaluating two Si/Ci pairs (one branch per
// element: 30 series terms below x = 4, else 60 Lentz steps); the weighted
// values are added in shared memory by a binary tree whose order is fixed by
// the thread index (no atomics). The per-node arithmetic is
// `hmcode::onehalo_node` (hmcode.cuh).

#include <cuda_runtime.h>

#include "hmcode.cuh"

namespace {

constexpr int kThreads = hmcode::kOnehaloThreads;

__global__ void hmcode_onehalo_kernel(const double* __restrict__ nu,   // (nrow, nm)
                                      const double* __restrict__ m,    // (nm,)
                                      const double* __restrict__ rv,   // (nrow, nm)
                                      const double* __restrict__ conc, // (nrow, nm)
                                      const double* __restrict__ eta,  // (nrow,)
                                      const double* __restrict__ k,    // (nk,)
                                      int nm, int nk,
                                      double* __restrict__ out) {      // (nrow, nk)
  __shared__ double sh[kThreads];
  const int ir = blockIdx.y, ik = blockIdx.x, t = threadIdx.x;
  const long row = (long)ir * nm;
  double acc = 0.0;
  for (int i = t; i < nm; i += kThreads)
    acc += hmcode::onehalo_node(nu + row, m, rv + row, conc + row, nm, i, eta[ir], k[ik]);
  sh[t] = acc;
  __syncthreads();
  for (int half = kThreads / 2; half > 0; half >>= 1) {
    if (t < half) sh[t] += sh[t + half];
    __syncthreads();
  }
  if (t == 0) out[(long)ir * nk + ik] = sh[0];
}

}  // namespace

// All pointers are device pointers to contiguous float64.
extern "C" int hmcode_onehalo_launch(const double* nu, const double* m, const double* rv,
                                     const double* conc, const double* eta, const double* k,
                                     int nrow, int nm, int nk, double* out, void* stream) {
  if (nrow < 1 || nk < 1 || nm < 2 || nrow > 65535) return (int)cudaErrorInvalidValue;
  hmcode_onehalo_kernel<<<dim3(nk, nrow), kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      nu, m, rv, conc, eta, k, nm, nk, out);
  return (int)cudaGetLastError();
}

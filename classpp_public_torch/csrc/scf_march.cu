// The Klein-Gordon march of scalar-field dark energy for a batch of 1 to 32
// tune values in ONE launch of one block.
//
// Replaces classpp_public_tpu/models/background.py `_integrate_scf`
// (:302-363, a jitted lax.scan of RK4 sub-steps, called once per shot of the
// Omega_scf shooting :600-691); its plain version is `scf_march_plain` in
// classpp_public_torch/models/background.py. The code is scf_march.cuh.
//
// Design: the block's threads first evaluate the background at every time
// the RK4 sub-steps read (4096 nodes x 2 sub-steps x 3 times: ~25 000
// independent evaluations of two exp and a linear interpolation) into a
// coefficient table in global memory; then thread c of the first warp runs
// chain c (its own lambda, alpha, A or B): 8190 dependent sub-steps of four
// right-hand sides, each an exp, a sqrt, two float64 divisions (and two pow
// when alpha != 0), reading the shared table (the same address in every
// thread: one broadcast); the threads write (n_c, n, 2). What bounds it: the
// latency of one chain's serial sub-steps. The shooting evaluates the 31
// midpoints of the next five levels of its bisection tree in one launch.

#include <cuda_runtime.h>

#include "scf_march.cuh"

namespace {

constexpr int kThreads = 256;

__global__ void __launch_bounds__(kThreads)
scf_march_kernel(sm::Grid G, const double* __restrict__ p4, int nchain, double rho_rad_ini,
                 double phi_ini, double phi_prime_ini, int attractor,
                 double* __restrict__ coef, double* __restrict__ Y) {
  sm::coef_table(G, (int)threadIdx.x, kThreads, coef);
  __syncthreads();
  const int c = (int)threadIdx.x;
  if (c < nchain) {
    const sm::Chain ch{p4[4 * c], p4[4 * c + 1], p4[4 * c + 2], p4[4 * c + 3]};
    double phi0, phip0;
    sm::start(ch, G.a[0], rho_rad_ini, phi_ini, phi_prime_ini, attractor != 0, &phi0, &phip0);
    const double h = (G.loga[1] - G.loga[0]) / 2.0;
    sm::march(ch, G.n, coef, phi0, phip0, h, Y + (long)c * G.n * 2);
  }
}

}  // namespace

// loga, a, lnrho: (n,) the uniform ln a grid, a and ln rho_base at its nodes;
// p4: (nchain, 4) each chain's (lambda, alpha, A, B); rhoK0 = Omega_k H0^2;
// attractor != 0: phi_ini and phi_prime_ini scale the attractor values;
// coef: scratch of sm::coef_doubles(n) doubles; Y: (nchain, n, 2) phi and
// phi' at every node. Every pointer is a device pointer.
extern "C" int scf_march_launch(const double* loga, const double* a, const double* lnrho, int n,
                                double rhoK0, const double* p4, int nchain, double rho_rad_ini,
                                double phi_ini, double phi_prime_ini, int attractor,
                                double* coef, double* Y, void* stream) {
  if (n < 2 || nchain < 1 || nchain > sm::kMaxChains) return (int)cudaErrorInvalidValue;
  const sm::Grid G{loga, a, lnrho, n, rhoK0};
  scf_march_kernel<<<1, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      G, p4, nchain, rho_rad_ini, phi_ini, phi_prime_ini, attractor, coef, Y);
  return (int)cudaGetLastError();
}

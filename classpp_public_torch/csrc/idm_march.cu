// The interacting dark matter's temperature march in ONE launch of one block.
//
// Replaces the lax.scan of the T_idm march at
// classpp_public_tpu/models/thermodynamics.py:1017-1024 (and the sound speed
// :1025-1027); its plain version is `idm_march_plain` in
// classpp_public_torch/models/thermodynamics.py. The code is idm_march.cuh.
//
// Design: thread 0 runs the dependent implicit-Euler chain over the runtime
// grid's nodes (32 767 steps of a float64 division and a reciprocal each);
// then the block's threads compute dT/dz and the sound speed c^2 at every
// node, independent of one another. Every product and sum is rounded alone
// (no FMA contraction): in the tight-coupling era T_idr - T_idm is below
// T's last bit and the sound speed multiplies it by Gamma/H, so only the
// plain loop's exact rounding reproduces its values there. What bounds it:
// the serial chain. The
// recurrence is affine, T_i = A_i T_{i-1} + B_i, so a block-wide scan of the
// (A, B) pairs could replace the chain, at the price of reassociating the sum
// and so of the plain loop's bits.

#include <cuda_runtime.h>

#include "idm_march.cuh"

namespace {

constexpr int kThreads = 256;

__global__ void __launch_bounds__(kThreads)
idm_march_kernel(const double* __restrict__ z, const double* __restrict__ H,
                 const double* __restrict__ Tidr, const double* __restrict__ gam, int n,
                 double k_B, double eV, double m_idm, double* __restrict__ T,
                 double* __restrict__ c2) {
  if (threadIdx.x == 0) im::march(z, H, Tidr, gam, n, T);
  __syncthreads();
  im::sound_speed(z, H, Tidr, gam, T, n, k_B, eV, m_idm, (int)threadIdx.x, kThreads, c2);
}

}  // namespace

// z, H, Tidr, gam (n): the grid in decreasing z, the Hubble rate, the idr
// temperature and the heating rate; k_B, eV, m_idm: the sound speed's
// constants; T, c2 (n): the idm temperature and sound speed. Every pointer is
// a device pointer.
extern "C" int idm_march_launch(const double* z, const double* H, const double* Tidr,
                                const double* gam, int n, double k_B, double eV, double m_idm,
                                double* T, double* c2, void* stream) {
  if (n < 2) return (int)cudaErrorInvalidValue;
  idm_march_kernel<<<1, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      z, H, Tidr, gam, n, k_B, eV, m_idm, T, c2);
  return (int)cudaGetLastError();
}

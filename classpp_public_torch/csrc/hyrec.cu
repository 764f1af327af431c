// HyRec-2011 recombination history on the card.
//
// Replaces classpp_public_tpu/models/hyrec.py `_history_core` ->
// `build_history` (:574-783, the jitted "hyrec_hist" scan, statics `model`
// and `with_inj`), whose plain version is `hyrec_history_plain` in
// classpp_public_torch/models/hyrec.py. The arithmetic is hyrec.cuh, shared
// with the host build hyrec_host.cpp.
//
// What bounds it on an H100: neither bytes nor operations but the serial
// chain of 108 487 dependent steps of d ln a = 8.49e-5. Design: one block of
// ten warps runs the whole history. First every thread fills rows of a table
// of the redshift-only quantities of each step (H, n_H, T_r^4, the radiation
// terms of the rates, the Saha states, most of the HeII rate: ~25 float64
// pow/exp/sqrt calls a step, in parallel), so that the serial chain keeps only
// the calls that depend on the state (x_e, T_m): two pow a step in most of the
// march. Then every thread runs the same phase machine in registers (the same
// bits in every thread), thread 0 writing x_e and T_m; the effective 3-level
// model ("recfast") keeps one warp for it. The two-photon model ("full") uses
// all ten warps in its ~10 100 two-photon steps: one thread per virtual bin for the photon
// history reads, the virtual-real rows, optical depths and the new f^- row;
// the two wing recurrences and the three Thomas solves of the 80-bin
// diffusion window on one to three threads, their exponentials precomputed
// per bin; the eight per-bin sums by warp butterflies and a fixed tree over
// the warp sums (the same bits every run). The photon history (512 x 314
// float64, 1.29 MB) lives in device memory, where it stays in L2.

#include <cuda_runtime.h>

#include "hyrec.cuh"

namespace {

constexpr int kWarp = 32;
constexpr int kFullThreads = hy::NWARP * kWarp;
static_assert(kFullThreads >= hy::NSPEC, "a thread per photon-history read");

__global__ void __launch_bounds__(kFullThreads)
hyrec_history_kernel(const __grid_constant__ hy::Params P, hy::Tables T,
                     const double* __restrict__ z, int nz, const double* __restrict__ inj,
                     int full, double* __restrict__ ring, double* __restrict__ zt,
                     double* __restrict__ xe, double* __restrict__ Tm) {
  __shared__ hy::Scratch S;
  hy::history(P, T, hy::Team{(int)threadIdx.x, (int)blockDim.x}, z, nz, inj, full != 0, ring,
              &S, zt, xe, Tm);
}

}  // namespace

// params: hy::kNParams host doubles (a kernel parameter); the tables, z (nz),
// inj (nz, or null), ring ((RING, NROW) float64 filled with -1 when full, else
// unused), zt ((nz, hy::NZCOL) float64 scratch) and the outputs xe, Tm (nz) on
// the card.
extern "C" int hyrec_history_launch(const double* params, const double* log_alpha,
                                    const double* log_r2p2s, const double* twog,
                                    const int* read_src, const int* read_off,
                                    const double* read_w, const double* z, int nz,
                                    const double* inj, int full, double* ring, double* zt,
                                    double* xe, double* Tm, void* stream) {
  if (nz < 2) return (int)cudaErrorInvalidValue;
  hy::Params P;
  double* pp = reinterpret_cast<double*>(&P);
  for (int i = 0; i < hy::kNParams; ++i) pp[i] = params[i];
  const hy::Tables T{log_alpha, log_r2p2s, twog, read_src, read_off, read_w};
  hyrec_history_kernel<<<1, kFullThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      P, T, z, nz, inj, full, ring, zt, xe, Tm);
  return (int)cudaGetLastError();
}

// RECFAST recombination history and the baryon-temperature march through
// reionization on the card.
//
// Replaces classpp_public_tpu/models/thermodynamics.py `_reco_core` ->
// `_compute_recombination_impl` (:443-590, the jitted "recfast" scan, both
// values of its static `inj_on`) and
// `_tb_march` -> `_tb_march_impl` (:742-789, "tb_march"), whose plain
// versions are `recfast_history_plain` and `tb_march_plain` in
// classpp_public_torch/models/thermodynamics.py. The arithmetic is
// recfast.cuh, shared with the host build recfast_host.cpp.
//
// What bounds them on an H100: neither bytes nor operations but the serial
// chain. RECFAST is 20 000 intervals, each depending on the last; in the
// integrated phases an interval is four RK4 sub-steps of four derivative
// evaluations, each with some thirty float64 pow/exp calls (a dozen more in a
// row with energy injection), and the march is
// 4096 dependent backward-Euler steps. Design: one warp runs the history,
// every thread the same recurrence, with the independent pow and exp calls of
// each derivative spread over the threads (one each) and gathered by shuffles;
// the scalars are a kernel parameter (constant bank) and the H(z) spline is
// read through the cache. One thread runs the march; dT/dz at every node is
// independent and spread over the block once the march is done.

#include <cuda_runtime.h>

#include "recfast.cuh"

namespace {

constexpr int kMarchThreads = 256;

constexpr int kWarp = 32;

template <bool Inj>
__global__ void __launch_bounds__(kWarp)
recfast_history_kernel(const __grid_constant__ rf::Params P, const double* __restrict__ Hy,
                       const double* __restrict__ Hy2, double Hx0, double Hdx, int Hn,
                       const double* __restrict__ Ey, const double* __restrict__ Ey2, double Ex0,
                       double Edx, int En, int Nz, double* __restrict__ out) {
  const rf::Hubble S{Hy, Hy2, Hx0, Hdx, Hn, Ey, Ey2, Ex0, Edx, En};
  rf::history<Inj>(P, S, rf::Team{(int)threadIdx.x, kWarp}, Nz, out);
}

__global__ void __launch_bounds__(kMarchThreads)
tb_march_kernel(rf::March M, double Tb_start, int idx_start, double* __restrict__ Tb,
                double* __restrict__ dTdz) {
  if (threadIdx.x == 0) rf::tb_march(M, Tb_start, idx_start, Tb);
  __syncthreads();
  for (int i = threadIdx.x; i < M.n; i += blockDim.x) dTdz[i] = rf::tb_dTdz(M, i, Tb[i]);
}

}  // namespace

// params: rf::kNParams host doubles (passed by value: the kernel reads them
// from its constant bank); Hy, Hy2: the (Hn, 2) spline of (H, H') over ln a
// on the card; Ey, Ey2: the (En, 1) ln E spline of the injection beyond the
// spot on the card when params' inj_bos is set (else null); out: (6, Nz) on
// the card.
extern "C" int recfast_history_launch(const double* params, const double* Hy, const double* Hy2,
                                      double Hx0, double Hdx, int Hn, const double* Ey,
                                      const double* Ey2, double Ex0, double Edx, int En, int Nz,
                                      double* out, void* stream) {
  if (Nz < 1 || Hn < 2) return (int)cudaErrorInvalidValue;
  rf::Params P;
  double* pp = reinterpret_cast<double*>(&P);
  for (int i = 0; i < rf::kNParams; ++i) pp[i] = params[i];
  if (P.inj_bos != 0.0 && (Ey == nullptr || Ey2 == nullptr || En < 2))
    return (int)cudaErrorInvalidValue;
  // without injection the kernel of the injection-free history, unchanged
  auto* kernel = P.inj_on != 0.0 ? recfast_history_kernel<true> : recfast_history_kernel<false>;
  kernel<<<1, kWarp, 0, static_cast<cudaStream_t>(stream)>>>(P, Hy, Hy2, Hx0, Hdx, Hn, Ey, Ey2,
                                                              Ex0, Edx, En, Nz, out);
  return (int)cudaGetLastError();
}

// consts: kappa_fac, YHe, T_cmb, m_H, m_e, not4 (host doubles); every other
// pointer is a (n,) array on the card.
extern "C" int tb_march_launch(const double* z, const double* xe, const double* H,
                               const double* rho_g, const double* rho_b, const double* consts,
                               int n, double Tb_start, int idx_start, double* Tb, double* dTdz,
                               void* stream) {
  if (n < 2) return (int)cudaErrorInvalidValue;
  const rf::March M{z, xe, H, rho_g, rho_b, consts[0], consts[1], consts[2], consts[3],
                    consts[4], consts[5], n};
  tb_march_kernel<<<1, kMarchThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      M, Tb_start, idx_start, Tb, dTdz);
  return (int)cudaGetLastError();
}

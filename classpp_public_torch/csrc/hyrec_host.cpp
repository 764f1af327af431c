// Host build of the HyRec history (hyrec.cuh): the function hyrec.cu runs on
// the card, here on the CPU with a team of one thread, so that its arithmetic
// can be held against the plain Python loop on a machine with no card and no
// nvcc:
//
//   g++ -O2 -std=c++17 -shared -fPIC -o libhyrec_host.so hyrec_host.cpp
//
// The arguments are those of hyrec_history_launch (hyrec.cu) with host
// pointers and without the stream. The package never loads this library;
// tests/test_torch_thermo_variants.py does.

#include <memory>
#include <vector>

#include "hyrec.cuh"

extern "C" int hyrec_n_params() { return hy::kNParams; }

extern "C" int hyrec_n_zcol() { return hy::NZCOL; }

extern "C" int hyrec_history_host(const double* params, const double* log_alpha,
                                  const double* log_r2p2s, const double* twog,
                                  const int* read_src, const int* read_off, const double* read_w,
                                  const double* z, int nz, const double* inj, int full,
                                  double* ring, double* xe, double* Tm) {
  hy::Params P;
  double* pp = reinterpret_cast<double*>(&P);
  for (int i = 0; i < hy::kNParams; ++i) pp[i] = params[i];
  const hy::Tables T{log_alpha, log_r2p2s, twog, read_src, read_off, read_w};
  std::unique_ptr<hy::Scratch> S(new hy::Scratch());
  std::vector<double> zt((size_t)nz * hy::NZCOL);
  hy::history(P, T, hy::Team{0, 1}, z, nz, inj, full != 0, ring, S.get(), zt.data(), xe, Tm);
  return 0;
}

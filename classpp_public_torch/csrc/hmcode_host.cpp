// Host build of the two HMcode kernels' code (hmcode.cuh, special.cuh): the
// node functions that hmcode_sigma.cu and hmcode_onehalo.cu run, summed in the
// kernels' order (thread t takes nodes t, t + T, ...; the T partials are then
// added by the same binary tree). It exists so that the kernels' arithmetic
// can be held against the plain PyTorch versions on a machine with no card
// and no nvcc:
//
//   g++ -O2 -std=c++17 -shared -fPIC -o libhmcode_host.so hmcode_host.cpp
//
// The arguments are those of the launchers with host pointers, without the
// stream. The package never loads this library; tests/test_torch_hmcode.py does.

#include <vector>

#include "hmcode.cuh"

namespace {

// the kernels' fixed-order tree over T partials
double tree(std::vector<double>& sh) {
  for (size_t half = sh.size() / 2; half > 0; half >>= 1)
    for (size_t t = 0; t < half; ++t) sh[t] += sh[t + half];
  return sh[0];
}

}  // namespace

extern "C" void si_ci_host(const double* x, int n, double* si, double* ci) {
  for (int i = 0; i < n; ++i) special::si_ci(x[i], si + i, ci + i);
}

extern "C" int hmcode_sigma_host(const double* base, const double* k, const double* lnk,
                                 const double* R, int nspec, int nk, int nR, double* out) {
  if (nspec < 1 || nR < 1 || nk < 2) return 1;
  const int T = hmcode::kSigmaThreads;
  std::vector<double> sh[3] = {std::vector<double>(T), std::vector<double>(T),
                               std::vector<double>(T)};
  for (int is = 0; is < nspec; ++is)
    for (int ir = 0; ir < nR; ++ir) {
      const double r = R[(long)is * nR + ir];
      for (int t = 0; t < T; ++t) {
        double s1 = 0.0, s2 = 0.0, s3 = 0.0;
        for (int i = t; i < nk; i += T)
          hmcode::sigma_node(base + (long)is * nk, k, lnk, nk, i, r, &s1, &s2, &s3);
        sh[0][t] = s1; sh[1][t] = s2; sh[2][t] = s3;
      }
      for (int j = 0; j < 3; ++j) out[((long)is * nR + ir) * 3 + j] = tree(sh[j]);
    }
  return 0;
}

extern "C" int hmcode_onehalo_host(const double* nu, const double* m, const double* rv,
                                   const double* conc, const double* eta, const double* k,
                                   int nrow, int nm, int nk, double* out) {
  if (nrow < 1 || nk < 1 || nm < 2) return 1;
  const int T = hmcode::kOnehaloThreads;
  std::vector<double> sh(T);
  for (int ir = 0; ir < nrow; ++ir) {
    const long row = (long)ir * nm;
    for (int ik = 0; ik < nk; ++ik) {
      for (int t = 0; t < T; ++t) {
        double acc = 0.0;
        for (int i = t; i < nm; i += T)
          acc += hmcode::onehalo_node(nu + row, m, rv + row, conc + row, nm, i, eta[ir], k[ik]);
        sh[t] = acc;
      }
      out[(long)ir * nk + ik] = tree(sh);
    }
  }
  return 0;
}

// Host build of the Klein-Gordon march (scf_march.cuh): the same functions
// that scf_march.cu runs in one block on the card, here with a team of one
// thread and the chains one after another. It exists so that the kernel's
// arithmetic can be held against the plain loop on a machine with no card and
// no nvcc:
//
//   g++ -O2 -std=c++17 -shared -fPIC -o libscf_march_host.so scf_march_host.cpp
//
// The arguments are those of scf_march_launch (scf_march.cu) with host
// pointers, without the stream. The package never loads this library;
// tests/test_torch_scf.py does.

#include "scf_march.cuh"

extern "C" long scf_march_coef_doubles(int n) { return sm::coef_doubles(n); }

extern "C" int scf_march_host(const double* loga, const double* a, const double* lnrho, int n,
                              double rhoK0, const double* p4, int nchain, double rho_rad_ini,
                              double phi_ini, double phi_prime_ini, int attractor, double* coef,
                              double* Y) {
  if (n < 2 || nchain < 1 || nchain > sm::kMaxChains) return 1;
  const sm::Grid G{loga, a, lnrho, n, rhoK0};
  sm::coef_table(G, 0, 1, coef);
  const double h = (loga[1] - loga[0]) / 2.0;
  for (int c = 0; c < nchain; ++c) {
    const sm::Chain ch{p4[4 * c], p4[4 * c + 1], p4[4 * c + 2], p4[4 * c + 3]};
    double phi0, phip0;
    sm::start(ch, a[0], rho_rad_ini, phi_ini, phi_prime_ini, attractor != 0, &phi0, &phip0);
    sm::march(ch, n, coef, phi0, phip0, h, Y + (long)c * n * 2);
  }
  return 0;
}

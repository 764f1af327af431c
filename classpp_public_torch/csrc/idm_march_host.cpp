// Host build of the interacting dark matter's temperature march
// (idm_march.cuh): the same functions that idm_march.cu runs in one block on
// the card, here with a team of one thread. It exists so that the kernel's
// arithmetic can be held against the plain loop on a machine with no card and
// no nvcc:
//
//   g++ -O2 -std=c++17 -shared -fPIC -o libidm_march_host.so idm_march_host.cpp
//
// The arguments are those of idm_march_launch (idm_march.cu) with host
// pointers, without the stream. The package never loads this library;
// tests/test_torch_idm_dr.py does.

#include "idm_march.cuh"

extern "C" int idm_march_host(const double* z, const double* H, const double* Tidr,
                              const double* gam, int n, double k_B, double eV, double m_idm,
                              double* T, double* c2) {
  if (n < 2) return 1;
  im::march(z, H, Tidr, gam, n, T);
  im::sound_speed(z, H, Tidr, gam, T, n, k_B, eV, m_idm, 0, 1, c2);
  return 0;
}

// The dark-matter temperature march of interacting dark matter (ETHOS idm_dr):
// T_idm on the thermodynamics runtime grid by implicit Euler in descending z,
// then its derivative and the idm sound speed, written as plain C++ functions
// for a team of threads so that the same code builds for the card
// (idm_march.cu: one block) and for the host with a team of one
// (idm_march_host.cpp), which is how the CPU tests hold it against the plain
// loop without a card.
//
// Counterpart, line by line: classpp_public_torch/models/thermodynamics.py
// `idm_march_plain` (JAX classpp_public_tpu/models/thermodynamics.py:1007-1027,
// thermodynamics_module.cpp:845-985). On nodes i = 0..n-1 of decreasing z,
// with a = 1/(1 + z) and Gamma/H the heating rate over the Hubble rate,
//   T_0 = T_idr,0,
//   T_i = (T_{i-1} - dz (Gamma/H) T_idr,i) / (1 - 2 a dz - (Gamma/H) dz),
//         dz = z_i - z_{i-1} < 0,
// the discretisation of dT/dz = 2 a T - (Gamma/H)(T_idr - T), stable through
// the tight, intermediate and adiabatic regimes; then per node
//   dT/dz = 2 a T - (Gamma/H)(T_idr - T),
//   c^2 = k_B T / eV / m_idm (1 + dT/dz / (3 T)).
// Every expression keeps the plain loop's order of operations, and on the
// card each product and sum is rounded alone (IM_MUL, IM_ADD, IM_SUB), so the
// kernel's bits are the plain loop's.

#pragma once

#include <math.h>

#ifdef __CUDACC__
#define IM_FN __device__ inline
// products, sums and differences rounded one by one, never contracted into
// an FMA: the sound speed multiplies T's last bits by Gamma/H (up to ~1e17
// in the tight-coupling era), so the card must round as the plain loop does
#define IM_MUL(x, y) __dmul_rn(x, y)
#define IM_ADD(x, y) __dadd_rn(x, y)
#define IM_SUB(x, y) __dsub_rn(x, y)
#else
#define IM_FN inline
#define IM_MUL(x, y) ((x) * (y))
#define IM_ADD(x, y) ((x) + (y))
#define IM_SUB(x, y) ((x) - (y))
#endif

namespace im {

// The march on one thread: T (n) from the grid columns z, H, T_idr, Gamma.
IM_FN void march(const double* z, const double* H, const double* Tidr, const double* gam, int n,
                 double* T) {
  double t = Tidr[0];
  T[0] = t;
  for (int i = 1; i < n; ++i) {
    const double dz = IM_SUB(z[i], z[i - 1]);
    const double gh = gam[i] / H[i];
    const double a = 1.0 / IM_ADD(1.0, z[i]);
    t = IM_SUB(t, IM_MUL(IM_MUL(dz, gh), Tidr[i]))
        / IM_ADD(IM_SUB(1.0, IM_MUL(IM_MUL(2.0, a), dz)), IM_MUL(IM_MUL(gh, dz), -1.0));
    T[i] = t;
  }
}

// c^2 of the idm at every node, spread over the team (thread tid of nt).
// k_B, eV, m_idm: the constants, in the order the plain loop divides by them.
IM_FN void sound_speed(const double* z, const double* H, const double* Tidr, const double* gam,
                       const double* T, int n, double k_B, double eV, double m_idm, int tid,
                       int nt, double* c2) {
  for (int i = tid; i < n; i += nt) {
    const double a = 1.0 / IM_ADD(1.0, z[i]);
    const double t = T[i];
    const double dTdz = IM_SUB(IM_MUL(IM_MUL(2.0, a), t),
                               IM_MUL(gam[i] / H[i], IM_SUB(Tidr[i], t)));
    c2[i] = IM_MUL(k_B, t) / eV / m_idm * IM_ADD(1.0, dTdz / IM_MUL(3.0, t));
  }
}

}  // namespace im

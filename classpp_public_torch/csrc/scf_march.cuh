// The Klein-Gordon march of scalar-field dark energy (quintessence): y =
// (phi, phi') with phi' = dphi/dtau, by classic RK4 with two sub-steps per
// interval of the background's uniform ln a grid, for a batch of chains that
// differ in one potential parameter (the shooting's tune values). Written as
// plain C++ functions for a team of threads so that the same code builds for
// the card (scf_march.cu: one block) and for the host with a team of one
// (scf_march_host.cpp), which is how the CPU tests hold it against the plain
// loop without a card.
//
// Counterpart, line by line: classpp_public_torch/models/background.py
// `scf_march_plain` (the potential `_scf_potential_scalar`), itself the JAX
// `_integrate_scf` (classpp_public_tpu/models/background.py:302-363):
//   dphi/dln a = phi' / (a H),  dphi'/dln a = (-2 a H phi' - a^2 dV) / (a H),
//   H^2 = rho_base(a) + rho_scf + rho_K0 / a^2,  rho_scf = (phi'^2/(2 a^2) + V)/3,
// with rho_base linear in ln rho_base on the grid, V = exp(-lambda phi)
// ((phi - B)^alpha + A) and the reference's dV_e = -lambda V
// (background_module.cpp:2065-2150). Attractor initial conditions scale the
// attractor values of phi and phi' (background_initial_conditions
// :1618-1636).
//
// Two phases, as growth_march.cuh. The right-hand side's background values
// depend on the time alone, so `coef_table` evaluates them at every time the
// RK4 sub-steps read (t, t + h/2, t + h of each sub-step, computed as the
// plain loop computes them) spread over the team: a, 2 a^2, a^2, rho_base and
// rho_K0 / a^2, each with the plain loop's order of operations. `march` then
// runs one chain per thread, the dependent sub-steps in the plain loop's order.

#pragma once

#include <math.h>

#ifdef __CUDACC__
#define SM_FN __device__ inline
#define SM_HOST_FN __host__ __device__ inline
#else
#define SM_FN inline
#define SM_HOST_FN inline
#endif

namespace sm {

constexpr int kCols = 5;   // a, 2 a^2, a^2, rho_base, rho_K0 / a^2
constexpr int kPts = 3;    // times per sub-step: t, t + h/2, t + h
constexpr int kSub = 2;    // RK4 sub-steps per interval (background.py:344)
constexpr int kMaxChains = 32;

// Coefficient doubles of the march for a grid of n nodes.
SM_HOST_FN long coef_doubles(int n) { return (long)(n - 1) * kSub * kPts * kCols; }

// The grid and the background the field sees.
struct Grid {
  const double* loga;     // (n,) uniform ln a
  const double* a;        // (n,) a at the nodes
  const double* lnrho;    // (n,) ln rho_base at the nodes
  int n;
  double rhoK0;           // Omega_k H0^2
};

// One chain's potential parameters (lambda, alpha, A, B) and its start.
struct Chain {
  double lam, alpha, A, B;
};

// V and dV/dphi at phi (JAX `_scf_potential`: V = V_e V_p, dV_e = -lambda V).
SM_FN void potential(const Chain& c, double phi, double* V, double* dV) {
  const double V_e = exp(-c.lam * phi);
  const double x = phi - c.B;
  const double ax = fabs(x);
  const double V_p = (c.alpha == 0.0 ? 1.0 : pow(ax, c.alpha)) + c.A;
  const double v = V_e * V_p;
  const double sgn = x > 0.0 ? 1.0 : (x < 0.0 ? -1.0 : 0.0);
  const double dV_p = c.alpha == 0.0 ? 0.0 : c.alpha * pow(ax, c.alpha - 1.0) * sgn;
  const double dV_e = -c.lam * v;
  *V = v;
  *dV = dV_e * V_p + V_e * dV_p;
}

// The background coefficients of every time the march reads, into coef
// (coef_doubles), spread over the team (thread tid of nt).
SM_FN void coef_table(const Grid& G, int tid, int nt, double* coef) {
  const long npts = (long)(G.n - 1) * kSub * kPts;
  const double x_first = G.loga[0];
  const double dx = G.loga[1] - G.loga[0];
  const double h = dx / 2.0;
  for (long p = tid; p < npts; p += nt) {
    const int m = (int)(p % kPts);
    const long js = p / kPts;
    const int s = (int)(js % kSub), i = (int)(js / kSub);
    const double lga = x_first + (double)i * dx;
    const double x0 = lga + (double)s * h;
    const double x = m == 0 ? x0 : (m == 1 ? x0 + h / 2.0 : x0 + h);
    // rho_base: linear interpolation of ln rho_base on the grid
    const double f = (x - x_first) / dx;
    int j = (int)floor(f);
    j = j < 0 ? 0 : (j > G.n - 2 ? G.n - 2 : j);
    const double w = f - (double)j;
    const double aa = exp(x);
    double* o = coef + p * kCols;
    o[0] = aa;
    o[1] = 2.0 * aa * aa;
    o[2] = aa * aa;
    o[3] = exp((1.0 - w) * G.lnrho[j] + w * G.lnrho[j + 1]);
    o[4] = G.rhoK0 / (aa * aa);
  }
}

// dy/dln a at the time whose coefficients are t.
SM_FN void rhs(const Chain& c, const double* t, double phi, double phip, double out[2]) {
  double V, dV;
  potential(c, phi, &V, &dV);
  const double rho_s = (phip * phip / t[1] + V) / 3.0;
  const double H = sqrt(fmax(t[3] + rho_s + t[4], 1e-300));
  const double aH = t[0] * H;
  out[0] = phip / aH;
  out[1] = (-2.0 * aH * phip - t[2] * dV) / aH;
}

// The starting point of a chain (JAX _integrate_scf :324-333): with
// attractor initial conditions phi_ini and phi_prime_ini scale the attractor
// values; rho_rad_ini is the radiation density at a[0].
SM_HOST_FN void start(const Chain& c, double a0, double rho_rad_ini, double phi_ini,
                      double phi_prime_ini, bool attractor, double* phi0, double* phip0) {
  if (!attractor) {
    *phi0 = phi_ini;
    *phip0 = phi_prime_ini;
    return;
  }
  const double lam = c.lam;
  const double arg = rho_rad_ini * 4.0 / (3.0 * lam * lam - 12.0);
  const double p0 = 3.0 * lam * lam - 12.0 > 0.0 ? -1.0 / lam * log(fabs(arg)) * phi_ini
                                                 : 1.0 / lam;
  // V at p0, as `potential` computes it
  const double x = p0 - c.B;
  const double V_p = (c.alpha == 0.0 ? 1.0 : pow(fabs(x), c.alpha)) + c.A;
  const double V0 = exp(-lam * p0) * V_p;
  *phi0 = p0;
  *phip0 = 2.0 * a0 * sqrt(fabs(V0)) * phi_prime_ini;
}

// One chain from (phi0, phip0) through every node: Y (n, 2) gets (phi, phi')
// at each node. One thread.
SM_FN void march(const Chain& c, int n, const double* coef, double phi0, double phip0,
                 double h, double* Y) {
  double y0 = phi0, y1 = phip0;
  Y[0] = y0;
  Y[1] = y1;
  const double h2 = h / 2.0, h6 = h / 6.0;
  for (int i = 0; i < n - 1; ++i) {
    for (int s = 0; s < kSub; ++s) {
      const double* t = coef + ((long)i * kSub + s) * kPts * kCols;
      double k1[2], k2[2], k3[2], k4[2];
      rhs(c, t, y0, y1, k1);
      rhs(c, t + kCols, y0 + h2 * k1[0], y1 + h2 * k1[1], k2);
      rhs(c, t + kCols, y0 + h2 * k2[0], y1 + h2 * k2[1], k3);
      rhs(c, t + 2 * kCols, y0 + h * k3[0], y1 + h * k3[1], k4);
      y0 = y0 + h6 * (k1[0] + 2.0 * k2[0] + 2.0 * k3[0] + k4[0]);
      y1 = y1 + h6 * (k1[1] + 2.0 * k2[1] + 2.0 * k3[1] + k4[1]);
    }
    Y[2L * (i + 1)] = y0;
    Y[2L * (i + 1) + 1] = y1;
  }
}

}  // namespace sm

// The growth-factor march: D(a) and f(a) = dln D/dln a by classic RK4 on the
// background's uniform ln a grid (background_module.cpp:1975-1983), written as
// plain C++ functions for a team of threads so that the same code builds for
// the card (growth_march.cu: one block) and for the host with a team of one
// (growth_march_host.cpp), which is how the CPU tests hold it against the
// plain loop without a card.
//
// Counterpart, line by line: classpp_public_torch/models/background.py
// `growth_march_plain` (the right-hand side `growth_rhs` on `_scalar_spline`)
// and ops/ode.py `rk4_fixed`. y = (D, D') with D' = dD/dtau, marched in ln a:
//   dD/dln a = D' / (a H),  dD'/dln a = (-a H D' + 1.5 a^2 rho_m D) / (a H),
// with rho_m, a and H read from the cubic uniform spline of (rho_b + rho_cdm,
// a, H) over ln a.
//
// Two phases. The right-hand side's table values depend on the time alone, so
// `coef_table` evaluates the spline at every time the RK4 sub-steps read (t,
// t + h/2, t + h of each sub-step, computed as the plain loop computes them)
// spread over the team, and stores the three coefficients of the linear
// right-hand side there: inv = 1/(a H), c1 = -a H, c2 = 1.5 a^2 rho_m, each
// with the plain loop's order of operations. `march` then runs the dependent
// sub-steps on one thread; `normalise` writes D / D(today) and f.

#pragma once

#include <math.h>

#ifdef __CUDACC__
#define GM_FN __device__ inline
#define GM_HOST_FN __host__ __device__ inline
#else
#define GM_FN inline
#define GM_HOST_FN inline
#endif

namespace gm {

constexpr int kCols = 3;   // spline columns: rho_m, a, H
constexpr int kPts = 3;    // times per sub-step: t, t + h/2, t + h

// The spline (y, y2: (n, kCols), row-major) over ln a = x0 + i dx.
struct Spline {
  const double* y;
  const double* y2;
  double x0, dx;
  int n;
};

// Coefficient doubles of the march: kCols per time, kPts times per sub-step.
GM_HOST_FN long coef_doubles(int n, int substeps) {
  return (long)(n - 1) * substeps * kPts * kCols;
}

// Column c of the spline at x (background.py `_scalar_spline`).
GM_FN double spline_at(const Spline& S, double x, int c) {
  const double t = (x - S.x0) / S.dx;
  int i = (int)floor(t);
  i = i < 0 ? 0 : (i > S.n - 2 ? S.n - 2 : i);
  const double b = t - (double)i, a = 1.0 - b;
  const double h2 = S.dx * S.dx / 6.0;
  const double* yl = S.y + (long)i * kCols;
  const double* y2l = S.y2 + (long)i * kCols;
  return a * yl[c] + b * yl[kCols + c]
         + ((pow(a, 3.0) - a) * y2l[c] + (pow(b, 3.0) - b) * y2l[kCols + c]) * h2;
}

// The coefficients (inv, c1, c2) of every time the march reads, into coef
// (coef_doubles), spread over the team (thread tid of nt).
GM_FN void coef_table(const Spline& S, const double* ts, int n, int substeps, int tid, int nt,
                      double* coef) {
  const long npts = (long)(n - 1) * substeps * kPts;
  for (long p = tid; p < npts; p += nt) {
    const int m = (int)(p % kPts);
    const long js = p / kPts;
    const int i = (int)(js % substeps), j = (int)(js / substeps);
    const double ta = ts[j], tb = ts[j + 1];
    const double h = (tb - ta) / (double)substeps;
    const double t = ta + (double)i * h;
    const double x = m == 0 ? t : (m == 1 ? t + h / 2.0 : t + h);
    const double rm = spline_at(S, x, 0), aa = spline_at(S, x, 1), hh = spline_at(S, x, 2);
    double* o = coef + p * kCols;
    o[0] = 1.0 / (aa * hh);
    o[1] = -aa * hh;
    o[2] = 1.5 * aa * aa * rm;
  }
}

// dy/dln a at the time whose coefficients are c.
GM_FN void rhs(const double* c, double D, double Dp, double out[2]) {
  out[0] = Dp * c[0];
  out[1] = (c[1] * Dp + c[2] * D) * c[0];
}

// The dependent RK4 sub-steps from y0 (rk4_fixed): Y (n, 2) gets y at every
// node. One thread.
GM_FN void march(const double* ts, int n, int substeps, const double* coef, double y00,
                 double y01, double* Y) {
  double y0 = y00, y1 = y01;
  Y[0] = y0;
  Y[1] = y1;
  for (int j = 0; j < n - 1; ++j) {
    const double h = (ts[j + 1] - ts[j]) / (double)substeps;
    for (int i = 0; i < substeps; ++i) {
      const double* c = coef + ((long)j * substeps + i) * kPts * kCols;
      double k1[2], k2[2], k3[2], k4[2];
      rhs(c, y0, y1, k1);
      rhs(c + kCols, y0 + h / 2.0 * k1[0], y1 + h / 2.0 * k1[1], k2);
      rhs(c + kCols, y0 + h / 2.0 * k2[0], y1 + h / 2.0 * k2[1], k3);
      rhs(c + 2 * kCols, y0 + h * k3[0], y1 + h * k3[1], k4);
      y0 = y0 + h / 6.0 * (k1[0] + 2.0 * k2[0] + 2.0 * k3[0] + k4[0]);
      y1 = y1 + h / 6.0 * (k1[1] + 2.0 * k2[1] + 2.0 * k3[1] + k4[1]);
    }
    Y[2L * (j + 1)] = y0;
    Y[2L * (j + 1) + 1] = y1;
  }
}

// out (2, n): D = Y0 / Y0(today) and f = Y1 / (Y0 a H), spread over the team.
GM_FN void normalise(const double* Y, const double* aH, int n, int tid, int nt, double* out) {
  const double D_today = Y[2L * (n - 1)];
  for (int j = tid; j < n; j += nt) {
    out[j] = Y[2L * j] / D_today;
    out[n + j] = Y[2L * j + 1] / (Y[2L * j] * aH[j]);
  }
}

}  // namespace gm

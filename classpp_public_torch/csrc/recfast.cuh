// RECFAST 1.5 recombination history and the baryon-temperature march through
// reionization, written once as plain C++ for a team of threads (see Team):
// recfast.cu runs the history on one warp and the march on one thread of a
// block, recfast_host.cpp builds the same functions for the host with a team
// of one, so that the CPU tests can hold this arithmetic against the plain
// Python loops of classpp_public_torch/models/thermodynamics.py
// (`recfast_history_plain`, `tb_march_plain`) without a card.
//
// Counterparts, line by line: thermodynamics.py `_hubble_evaluator`,
// `make_recfast_derivs` (RECFAST derivatives, Heswitch = 6, Hswitch on),
// `recfast_history_plain` (the staged Saha phases A-F, four RK4 sub-steps per
// interval in phases E and F, the six output columns), `_injection_rate`
// and the chi fits (DM energy injection on the spot or beyond it, compiled in
// only for inj_on) and
// `tb_march_plain`.
// Every `x ** y` of the Python is pow(x, y) here and every sum keeps the
// Python's left-to-right order, so the host build reproduces the plain loop
// up to the last bit or two; on the card the last bits of exp/pow and FMA
// contraction differ.

#pragma once

#include <math.h>

#include "team.cuh"

#ifdef __CUDACC__
#define RF_FN __host__ __device__ inline
#else
#define RF_FN inline
#endif

namespace rf {

// Scalars of the RECFAST system for one cosmology, in the order of
// thermodynamics.py RF_PARAMS (the wrapper packs them into a float64 vector).
struct Params {
  // RecfastCtx
  double fHe, Nnow, Tnow, fu, H0_s, CDB, CDB_He, CB1, CB1_He1, CB1_He2;
  double CR, CK, CK_He, CL, CL_He, CT, Bfact, YHe;
  // precision parameters
  double trigH, trigH2, trigHe2, AG1, AG2, zG1, zG2, wG1, wG2, H_frac, fudge_He;
  double z_init, zHe1, dzHe1, zHe2, dzHe2, zHe3, dzHe3, trigHe, dtrigHe, dtrigH;
  // derived constants
  double c, not4, conv, dop_fac, CL_PSt, E_trip_ion, E_2St, wb_fac, dk_fac;
  double T_0, T_1, a_VF, a_trip;
  // DM energy injection: inj_on, inj_bos (the rate is the ln E spline of
  // Hubble), the eight RecfastCtx.inj scalars, rho_cdm today and constants
  double inj_on, inj_bos, ann, dec, ann_var, ann_z, ann_zmax, ann_zmin, f_halo, z_halo;
  double rho_cdm_J, hPc, kB, L_H_ion, L_H_alpha;
};
constexpr int kNParams = sizeof(Params) / sizeof(double);

// RECFAST atomic data (reference source/thermodynamics.h:360-420)
constexpr double kLambda_H = 8.2245809, kLambda_He = 51.3;
constexpr double kL_He_2p = 1.71134891e7, kA2P_s = 1.798287e9, kA2P_t = 177.58;
constexpr double kL_He_2Pt = 1.690871466e7;
constexpr double kSigma_He_2Ps = 1.436289e-22, kSigma_He_2Pt = 1.484872e-22;
constexpr double ka_PPB = 4.309, kb_PPB = -0.6166, kc_PPB = 0.6703, kd_PPB = 0.5300;
constexpr double kb_VF = 0.711, kb_trip = 0.761;
constexpr double kPi = 3.141592653589793;

// The (H, H') cubic spline over ln a on a uniform grid: y, y2 are (n, 2);
// beyond the spot, the ln E spline of the injection rate over -ln(1 + z):
// Ey, Ey2 are (En, 1) (unset otherwise).
struct Hubble {
  const double* y;
  const double* y2;
  double x0, dx;
  int n;
  const double* Ey;
  const double* Ey2;
  double Ex0, Edx;
  int En;
};

// Python max/min/clip semantics (the first argument wins ties and NaN).
RF_FN double pmax(double a, double b) { return b > a ? b : a; }
RF_FN double pmin(double a, double b) { return b < a ? b : a; }
RF_FN double clip(double x, double lo, double hi) { return x < lo ? lo : (x > hi ? hi : x); }
RF_FN double f1(double x) { return -0.75 * x * (x * x / 3.0 - 1.0) + 0.5; }
RF_FN double f2(double x) { return x * x * (0.5 - x / 3.0) * 6.0; }

// The threads that share the history (team.cuh): a warp on the card, one
// thread on the host. Every thread runs the same recurrence. The
// independent pow and exp calls of one derivative evaluation are spread over
// the threads, one call per thread, all threads running the same instruction
// stream on their own arguments, and gathered back with shuffles: a
// derivative costs three transcendental latencies instead of some thirty in
// a row. Each call keeps the arguments of make_recfast_derivs, so it gives
// the same bits whichever thread makes it.
using team::Team;

// out[i] = pow(base[i], ex[i]) and exp(arg[i]), i < n, in every thread
RF_FN void gather_pow(const Team& tm, int n, const double* base, const double* ex, double* out) {
#ifdef __CUDA_ARCH__
  double mine = 0.0;
  if (tm.tid < n) mine = pow(base[tm.tid], ex[tm.tid]);
  for (int i = 0; i < n; ++i) out[i] = __shfl_sync(0xffffffffu, mine, i);
#else
  for (int i = 0; i < n; ++i) out[i] = pow(base[i], ex[i]);
#endif
}

RF_FN void gather_exp(const Team& tm, int n, const double* arg, double* out) {
#ifdef __CUDA_ARCH__
  double mine = 0.0;
  if (tm.tid < n) mine = exp(arg[tm.tid]);
  for (int i = 0; i < n; ++i) out[i] = __shfl_sync(0xffffffffu, mine, i);
#else
  for (int i = 0; i < n; ++i) out[i] = exp(arg[i]);
#endif
}

RF_FN void gather_log(const Team& tm, int n, const double* arg, double* out) {
#ifdef __CUDA_ARCH__
  double mine = 0.0;
  if (tm.tid < n) mine = log(arg[tm.tid]);
  for (int i = 0; i < n; ++i) out[i] = __shfl_sync(0xffffffffu, mine, i);
#else
  for (int i = 0; i < n; ++i) out[i] = log(arg[i]);
#endif
}

// The energy-injection factors of a derivative evaluation (_injection_rate
// and the chi fits of make_recfast_derivs) at z, for xc = clip(x, 0, 1):
// the rate [J/m^3/s] (exp of the ln E spline beyond the spot, the
// on-the-spot form otherwise), 0.369202 (1 - xc^0.463929)^1.70237 (chi_ion
// where x < 1) and 0.996857 (1 - (1 - xc^0.300134)^1.51035) (the chi_heat fit
// where x < 1). Their independent log/pow/exp calls are spread over the team
// in gathers, each call with the Python's arguments.
RF_FN void injection_terms(const Params& P, const Hubble& S, const Team& tm, double z, double xc,
                           double* rate, double* chi_ion_fit, double* chi_heat_fit) {
  double Q[3];
  if (P.inj_bos != 0.0) {        // the ln E spline at -ln(1 + z)
    const double t = (-log1p(z) - S.Ex0) / S.Edx;
    int i = (int)floor(t);
    i = i < 0 ? 0 : (i > S.En - 2 ? S.En - 2 : i);
    const double b = t - (double)i, a = 1.0 - b, h2 = S.Edx * S.Edx / 6.0;
    const double pb[4] = {a, b, xc, xc}, pe[4] = {3.0, 3.0, 0.463929, 0.300134};
    double W[4];
    gather_pow(tm, 4, pb, pe, W);
    const double earg = a * S.Ey[i] + b * S.Ey[i + 1] + (W[0] - a) * h2 * S.Ey2[i]
                        + (W[1] - b) * h2 * S.Ey2[i + 1];
    gather_exp(tm, 1, &earg, rate);
    const double qb[2] = {1.0 - W[2], 1.0 - W[3]}, qe[2] = {1.70237, 1.51035};
    gather_pow(tm, 2, qb, qe, Q + 1);
  } else {                       // on the spot
    const double u = (1.0 + z) / (1.0 + P.z_halo);
    const double lg[2] = {(P.ann_z + 1.0) / (P.ann_zmax + 1.0),
                          z > P.ann_zmin ? (z + 1.0) / (P.ann_zmax + 1.0)
                                         : (P.ann_zmin + 1.0) / (P.ann_zmax + 1.0)};
    double L[2];
    gather_log(tm, 2, lg, L);
    const double pb[10] = {L[0], L[1], u, u, u, 1.0 + z, P.rho_cdm_J, P.c, xc, xc};
    const double pe[10] = {2.0, 2.0, 2.0, 3.0, 4.0, 3.0, 2.0, 2.0, 0.463929, 0.300134};
    double W[10];
    gather_pow(tm, 10, pb, pe, W);
    const double earg = z > P.ann_zmax ? -P.ann_var * W[0] : P.ann_var * (-W[0] + W[1]);
    double E;
    gather_exp(tm, 1, &earg, &E);
    const double qb[3] = {1.0 + 0.278393 * u + 0.230389 * W[2] + 0.000972 * W[3] + 0.078108 * W[4],
                          1.0 - W[8], 1.0 - W[9]};
    const double qe[3] = {-4.0, 1.70237, 1.51035};
    gather_pow(tm, 3, qb, qe, Q);
    const double ann_z = P.ann * E;
    const double zp3 = W[5];
    *rate = W[6] / W[7] * zp3 * (zp3 * ann_z + P.f_halo * Q[0]) + P.rho_cdm_J * zp3 * P.dec;
  }
  *chi_ion_fit = 0.369202 * Q[1];
  *chi_heat_fit = 0.996857 * (1.0 - Q[2]);
}

// d(x_H, x_He, Tmat)/dz (make_recfast_derivs, with its hubble evaluator); the
// same in every thread. Inj compiles the energy-injection terms in (P.inj_on
// set): without them the code is the injection-free derivative, instruction
// for instruction.
template <bool Inj>
RF_FN void derivs(const Params& P, const Hubble& S, const Team& tm, double z, double y0,
                  double y1, double y2, double d[3]) {
  const double x_H = clip(y0, 0.0, 1.0);
  const double x_He = clip(y1, 0.0, 1.0);
  const double Tmat = pmax(y2, 1e-3);
  const double x = x_H + P.fHe * x_He;
  const double zp1 = 1.0 + z;
  const double Trad = P.Tnow * zp1;
  const double c = P.c;
  const double lz = log1p(z);
  const double sq_0 = sqrt(Tmat / P.T_0);
  const double sq_1 = sqrt(Tmat / P.T_1);
  // the (H, H') spline at ln a = -ln(1 + z); not team::spline_col, because its
  // cubes are pow calls below, as the Python's `** 3`
  const double h2 = S.dx * S.dx / 6.0;
  const double t = (-lz - S.x0) / S.dx;
  int ih = (int)floor(t);
  ih = ih < 0 ? 0 : (ih > S.n - 2 ? S.n - 2 : ih);
  const double hb = t - (double)ih;
  const double ha = 1.0 - hb;

  // the pow calls
  const double base[19] = {zp1, Tmat / 1e4, Tmat / 1e4, P.CR * Tmat, 1.0 + sq_0, 1.0 + sq_1,
                           (lz - P.zG1) / P.wG1, (lz - P.zG2) / P.wG2, 1.0 + sq_0, 1.0 + sq_1,
                           c, c * kL_He_2p, kL_He_2Pt, c * kL_He_2Pt, Trad, zp1, Trad, ha, hb};
  const double ex[19] = {3.0, kb_PPB, kd_PPB, 1.5, 1.0 - kb_VF, 1.0 + kb_VF, 2.0, 2.0,
                         1.0 - kb_trip, 1.0 + kb_trip, 2.0, 2.0, 3.0, 2.0, 4.0, 1.5, 3.0, 3.0,
                         3.0};
  double W[19];
  gather_pow(tm, 19, base, ex, W);
  // the exp calls
  const double arg[10] = {-P.CDB / Tmat, -P.CDB_He / Tmat, -W[6], -W[7], -P.E_trip_ion / Tmat,
                          -P.CL_PSt / Tmat, -P.CL / Tmat, pmin(P.Bfact / Tmat, 680.0),
                          -P.CL_He / Tmat, -P.E_2St / Tmat};
  double X[10];
  gather_exp(tm, 10, arg, X);

  const double ca = (W[17] - ha) * h2, cb = (W[18] - hb) * h2;
  const double Hs = ha * S.y[2 * ih] + hb * S.y[2 * ih + 2] + ca * S.y2[2 * ih]
                    + cb * S.y2[2 * ih + 2];
  const double Hps = ha * S.y[2 * ih + 1] + hb * S.y[2 * ih + 3] + ca * S.y2[2 * ih + 1]
                     + cb * S.y2[2 * ih + 3];
  const double Hz = Hs * P.conv;
  const double dHdz = -Hps / Hs * P.conv;

  const double n = P.Nnow * W[0];
  const double n_He = P.fHe * n;
  const double Rdown = 1e-19 * ka_PPB * W[1] / (1.0 + kc_PPB * W[2]);
  const double CRT15 = W[3];
  const double Rup = Rdown * CRT15 * X[0];
  const double Rdown_He = P.a_VF / (sq_0 * W[4] * W[5]);
  const double Rup_He = 4.0 * Rdown_He * CRT15 * X[1];
  const double K = P.CK / Hz * (1.0 + P.AG1 * X[2] + P.AG2 * X[3]);
  const double Rdown_trip = P.a_trip / (sq_0 * W[8] * W[9]);
  const double Rup_trip = Rdown_trip * X[4] * CRT15 * 4.0 / 3.0;

  const bool he_active = 5e-9 <= x_He && x_He <= P.trigHe2;
  const double one_m_xHe = pmax(1.0 - x_He, 1e-30);
  const double one_m_xH = pmax(1.0 - x_H, 1e-30);
  double K_He, CfHe_t;
  if (he_active) {
    const double tauHe_s = kA2P_s * P.CK_He * 3.0 * n_He * one_m_xHe / Hz;
    const double tauHe_t = kA2P_t * n_He * one_m_xHe * 3.0 / (8.0 * kPi * Hz * W[12]);
    const double Doppler_s = c * kL_He_2p * sqrt(P.dop_fac * Tmat);
    const double gamma_2Ps = 3.0 * kA2P_s * P.fHe * one_m_xHe * W[10]
                             / (sqrt(kPi) * kSigma_He_2Ps * 8.0 * kPi * Doppler_s * one_m_xH)
                             / W[11];
    const double Doppler_t = c * kL_He_2Pt * sqrt(P.dop_fac * Tmat);
    const double gamma_2Pt = 3.0 * kA2P_t * P.fHe * one_m_xHe * W[10]
                             / (sqrt(kPi) * kSigma_He_2Pt * 8.0 * kPi * Doppler_t * one_m_xH)
                             / W[13];
    const double he_base[2] = {gamma_2Ps, gamma_2Pt}, he_ex[2] = {P.fudge_He, 0.9};
    const double he_arg[2] = {-tauHe_s, -tauHe_t};
    double G[2], E[2];
    gather_pow(tm, 2, he_base, he_ex, G);
    gather_exp(tm, 2, he_arg, E);
    const double pHe_s = (1.0 - E[0]) / pmax(tauHe_s, 1e-30);
    double K_He_denom;
    if (x_H < 0.9999999) {
      const double AHcon = kA2P_s / (1.0 + 0.36 * G[0]);
      K_He_denom = (kA2P_s * pHe_s + AHcon) * 3.0 * n_He * one_m_xHe;
    } else {
      K_He_denom = kA2P_s * pHe_s * 3.0 * n_He * one_m_xHe;
    }
    K_He = 1.0 / pmax(K_He_denom, 1e-300);
    const double pHe_t = (1.0 - E[1]) / pmax(tauHe_t, 1e-30);
    double num;
    if (x_H >= 0.99999) {
      num = kA2P_t * pHe_t;
    } else {
      const double AHcon_t = kA2P_t / (1.0 + 0.66 * G[1]) / 3.0;
      num = kA2P_t * pHe_t + AHcon_t;
    }
    const double CfHe_t_num = num * X[5];
    const double den = Rup_trip + CfHe_t_num;
    CfHe_t = den != 0.0 ? CfHe_t_num / den : NAN;
  } else {
    K_He = P.CK_He / Hz;
    CfHe_t = 0.0;
  }

  double C_peebles = 1.0;
  if (x_H < P.trigH2) {
    const double KLn = K * kLambda_H * n * one_m_xH;
    C_peebles = (1.0 + KLn) / (1.0 / P.fu + KLn / P.fu + K * Rup * n * one_m_xH);
  }
  double energy_rate = 0.0, chi_ion_fit = 0.0, chi_heat_fit = 0.0;
  if constexpr (Inj)
    injection_terms(P, S, tm, z, clip(x, 0.0, 1.0), &energy_rate, &chi_ion_fit, &chi_heat_fit);
  double dxH = 0.0;
  if (!(x_H > P.trigH)) {
    dxH = (x * x_H * n * Rdown - Rup * one_m_xH * X[6]) * C_peebles / (Hz * zp1);
    if constexpr (Inj) {   // extra ionization (chi_ion fit); d/dz, so it subtracts
      const double chi_ion_H = x < 1.0 ? chi_ion_fit : 0.0;
      dxH = dxH - energy_rate * chi_ion_H / n
                      * (1.0 / P.L_H_ion + (1.0 - C_peebles) / P.L_H_alpha) / (P.hPc * Hz * zp1);
    }
  }

  double dxHe = 0.0;
  if (!(x_He < 1e-15)) {
    const double He_Boltz = X[7];
    const double KB = K_He * n_He * one_m_xHe * He_Boltz;
    dxHe = ((x * x_He * n * Rdown_He - Rup_He * one_m_xHe * X[8])
            * (1.0 + KB * kLambda_He)) / (Hz * zp1 * (1.0 + KB * (kLambda_He + Rup_He)));
    dxHe = dxHe + (x * x_He * n * Rdown_trip - one_m_xHe * 3.0 * Rup_trip * X[9])
                      * CfHe_t / (Hz * zp1);
  }

  const double xs = pmax(x, 1e-30);
  const double timeTh = (1.0 / (P.CT * W[14])) * (1.0 + x + P.fHe) / xs;
  const double timeH = 2.0 / (3.0 * P.H0_s * W[15]);
  double dT;
  if (timeTh < P.H_frac * timeH) {
    const double epsilon = Hz * (1.0 + x + P.fHe) / (P.CT * W[16] * xs);
    dT = P.Tnow + epsilon * ((1.0 + P.fHe) / (1.0 + P.fHe + x)) * ((dxH + P.fHe * dxHe) / xs)
         - epsilon * dHdz / Hz + 3.0 * epsilon / zp1;
  } else {
    dT = P.CT * W[14] * x / (1.0 + x + P.fHe) * (Tmat - Trad) / (Hz * zp1) + 2.0 * Tmat / zp1;
    if constexpr (Inj) {   // injection heating (chi_heat fit)
      const double chi_heat = x < 1.0 ? (chi_heat_fit < 1.0 ? chi_heat_fit : 1.0) : 1.0;
      dT = dT - 2.0 / (3.0 * P.kB) * energy_rate * chi_heat / n / (1.0 + P.fHe + x) / (Hz * zp1);
    }
  }
  d[0] = dxH;
  d[1] = dxHe;
  d[2] = dT;
}

// Four classic RK4 sub-steps from za to zb (rk4_interval)
template <bool Inj>
RF_FN void rk4_interval(const Params& P, const Hubble& S, const Team& tm, const double y[3],
                        double za, double zb, double out[3]) {
  const int nsub = 4;
  const double h = (zb - za) / nsub;
  double y0 = y[0], y1 = y[1], y2 = y[2];
  double k1[3], k2[3], k3[3], k4[3];
  for (int i = 0; i < nsub; ++i) {
    const double zz = za + i * h;
    derivs<Inj>(P, S, tm, zz, y0, y1, y2, k1);
    derivs<Inj>(P, S, tm, zz + h / 2, y0 + h / 2 * k1[0], y1 + h / 2 * k1[1], y2 + h / 2 * k1[2],
                k2);
    derivs<Inj>(P, S, tm, zz + h / 2, y0 + h / 2 * k2[0], y1 + h / 2 * k2[1], y2 + h / 2 * k2[2],
                k3);
    derivs<Inj>(P, S, tm, zz + h, y0 + h * k3[0], y1 + h * k3[1], y2 + h * k3[2], k4);
    y0 = y0 + h / 6 * (k1[0] + 2 * k2[0] + 2 * k3[0] + k4[0]);
    y1 = y1 + h / 6 * (k1[1] + 2 * k2[1] + 2 * k3[1] + k4[1]);
    y2 = y2 + h / 6 * (k1[2] + 2 * k2[2] + 2 * k3[2] + k4[2]);
  }
  out[0] = y0;
  out[1] = y1;
  out[2] = y2;
}

RF_FN double saha(const Params& P, double z, double CB1_x, double factor) {
  return factor * exp(1.5 * log(P.CR * P.Tnow / (1.0 + z)) - CB1_x / (P.Tnow * (1.0 + z)))
         / P.Nnow;
}

RF_FN double x0_he3(const Params& P, double rhs) {
  return 0.5 * (sqrt(pow(rhs - 1.0 - P.fHe, 2.0) + 4.0 * (1.0 + 2.0 * P.fHe) * rhs)
                - (rhs - 1.0 - P.fHe));
}

// One interval i of the descending z grid: advances the state y and writes
// the six columns of the interval's row (z, x_e, T_b, w_b, c_b^2, kappa').
template <bool Inj>
RF_FN void interval(const Params& P, const Hubble& S, const Team& tm, int Nz, int i,
                    double y[3], double row[6]) {
  const double za = P.z_init * (double)(Nz - i) / (double)Nz;
  const double zb = P.z_init * (double)(Nz - i - 1) / (double)Nz;
  const double z = zb;
  const double Trad = P.Tnow * (1.0 + z);
  const double fHe = P.fHe;
  double x0, yn[3];
  if (z > P.zHe1 + P.dzHe1) {                          // A: fully ionized
    x0 = 1.0 + 2.0 * fHe;
    yn[0] = 1.0; yn[1] = 1.0; yn[2] = Trad;
  } else if (z > P.zHe2 + P.dzHe2) {                   // B: HeIII Saha
    const double x0_He3 = x0_he3(P, saha(P, z, P.CB1_He2, 1.0));
    if (z > P.zHe1 - P.dzHe1) {
      const double w = f1(clip((P.zHe1 - z) / P.dzHe1, -1.0, 1.0));
      x0 = w * x0_He3 + (1.0 - w) * (1.0 + 2.0 * fHe);
    } else {
      x0 = x0_He3;
    }
    yn[0] = 1.0; yn[1] = 1.0; yn[2] = Trad;
  } else if (z > P.zHe3 + P.dzHe3) {                   // C: HeIII done
    if (z > P.zHe2 - P.dzHe2) {
      const double x0_He3 = x0_he3(P, saha(P, z, P.CB1_He2, 1.0));
      const double w = f1(clip((P.zHe2 - z) / P.dzHe2, -1.0, 1.0));
      x0 = w * (1.0 + fHe) + (1.0 - w) * x0_He3;
    } else {
      x0 = 1.0 + fHe;
    }
    yn[0] = 1.0; yn[1] = 1.0; yn[2] = Trad;
  } else {
    const double rhs1 = saha(P, z, P.CB1_He1, 4.0);
    const double x0_He1 = 0.5 * (sqrt(pow(rhs1 - 1.0, 2.0) + 4.0 * (1.0 + fHe) * rhs1)
                                 - (rhs1 - 1.0));
    if (y[1] > P.trigHe) {                             // D: HeI Saha
      if (z > P.zHe3 - P.dzHe3) {
        const double w = f1(clip((P.zHe3 - z) / P.dzHe3, -1.0, 1.0));
        x0 = w * x0_He1 + (1.0 - w) * (1.0 + fHe);
      } else {
        x0 = x0_He1;
      }
      yn[0] = 1.0; yn[1] = (x0 - 1.0) / fHe; yn[2] = Trad;
    } else {
      const double rhsH = saha(P, z, P.CB1, 1.0);
      const double x_H0_saha = 0.5 * (sqrt(pow(rhsH, 2.0) + 4.0 * rhsH) - rhsH);
      double yi[3];
      rk4_interval<Inj>(P, S, tm, y, za, zb, yi);
      if (y[0] > P.trigH) {                            // E: He integrated, H Saha
        yn[0] = x_H0_saha; yn[1] = yi[1]; yn[2] = yi[2];
        const double x0_new = yn[0] + fHe * yn[1];
        if (P.trigHe - yi[1] < P.dtrigHe) {
          const double w = f2(clip((P.trigHe - yi[1]) / P.dtrigHe, 0.0, 1.0));
          x0 = w * x0_new + (1.0 - w) * x0_He1;
        } else {
          x0 = x0_new;
        }
      } else {                                         // F: full integration
        yn[0] = yi[0]; yn[1] = yi[1]; yn[2] = yi[2];
        if (P.trigH - yi[0] < P.dtrigH) {
          const double w = f2(clip((P.trigH - yi[0]) / P.dtrigH, 0.0, 1.0));
          x0 = w * yi[0] + (1.0 - w) * x_H0_saha + fHe * yi[1];
        } else {
          x0 = yi[0] + fHe * yi[1];
        }
      }
    }
  }
  double d[3];
  derivs<Inj>(P, S, tm, z, yn[0], yn[1], yn[2], d);
  const double Tb = yn[2];
  const double wb = P.wb_fac * (1.0 + (1.0 / P.not4 - 1.0) * P.YHe + x0 * (1.0 - P.YHe)) * Tb;
  row[0] = z;
  row[1] = x0;
  row[2] = Tb;
  row[3] = wb;
  row[4] = wb * (1.0 + (1.0 + z) * d[2] / Tb / 3.0);
  row[5] = pow(1.0 + z, 2.0) * P.dk_fac * x0;
  y[0] = yn[0];
  y[1] = yn[1];
  y[2] = yn[2];
}

// The whole history: out is (6, Nz), columns z, x_e, T_b, w_b, c_b^2, kappa'
// in ascending z (interval i lands in position Nz - 1 - i), written by
// thread 0. Inj: with the energy-injection terms (set exactly when P.inj_on
// is).
template <bool Inj>
RF_FN void history(const Params& P, const Hubble& S, const Team& tm, int Nz, double* out) {
  double y[3] = {1.0, 1.0, P.Tnow * (1.0 + P.z_init)};
  double row[6];
  for (int i = 0; i < Nz; ++i) {
    interval<Inj>(P, S, tm, Nz, i, y, row);
    if (tm.tid == 0)
      for (int c = 0; c < 6; ++c) out[(long)c * Nz + (Nz - 1 - i)] = row[c];
  }
}

// Inputs of the baryon-temperature march on the fine z grid (_tb_march).
struct March {
  const double* z;
  const double* xe;
  const double* H;
  const double* rho_g;
  const double* rho_b;
  double kappa_fac, YHe, T_cmb, m_H, m_e, not4;
  int n;
};

RF_FN double tb_dTdz(const March& M, int i, double Tb) {
  const double z = M.z[i], xe = M.xe[i];
  const double opacity = pow(1.0 + z, 2.0) * M.kappa_fac * xe;
  const double mu = M.m_H / (1.0 + (1.0 / M.not4 - 1.0) * M.YHe + xe * (1.0 - M.YHe));
  return 2.0 / (1.0 + z) * Tb
         - 2.0 * mu / M.m_e * 4.0 * M.rho_g[i] / 3.0 / M.rho_b[i] * opacity
               * (M.T_cmb * (1.0 + z) - Tb) / M.H[i];
}

// Backward-Euler march from the top of the grid down to z = 0, active below
// idx_start: Tb (n,) written in place.
RF_FN void tb_march(const March& M, double Tb_start, int idx_start, double* Tb) {
  const double dzf = M.z[1] - M.z[0];
  double T = Tb_start;
  Tb[M.n - 1] = Tb_start;
  for (int i = M.n - 2; i >= 0; --i) {
    if (i < idx_start) T = T - tb_dTdz(M, i + 1, T) * dzf;
    Tb[i] = T;
  }
}

}  // namespace rf

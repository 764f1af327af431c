// Per-lane tensor-mode integrator: equations, Cash-Karp step and source
// emission for ONE k mode, written as plain C++ functions for a TEAM of
// threads that share the lane's vectors: every loop over state components is
// strided over the team (`for (c = tid; c < n; c += nt)`), the few scalars
// every component needs (gw'', the polarization combination P2, the table
// values) and all step control are computed by every thread, so every branch
// is uniform, and the error ratio is a butterfly reduction that leaves the
// same bits in every thread. tensor_rkck.cu runs one lane per warp (a team of
// 32) on vectors in shared memory; compiled without nvcc the same functions
// build for the host with a team of one (tensor_rkck_host.cpp), which is how
// the arithmetic is checked against the plain PyTorch version without a card.
//
// Synchronisation rule: a function that writes a shared vector ends with
// team_sync(); a function that reads may assume its inputs are visible.
//
// Counterparts, line by line: classpp_public_torch/models/perturbations/
// tensors.py (rhs_full, tensor_ic, remap_tca_off, remap_rsa_on,
// tensor_rkck_plain) and ops/ode.py (rkck_step). Open, flat or closed
// universe; photons, polarization, (unless the method is `photons`) one
// massless-neutrino hierarchy driven by rho_ur + 3 sum p_ncdm (or rho_ur
// alone under `exact`) and (method `exact`) the Psi_l(q) hierarchy of every
// massive species: nq x nl entries a species, strided over the team like
// every other component, and its anisotropic stress in gw'', a sum over q
// per species reduced over the team in a fixed order (team_sum). The
// momentum data (q, weights, dln f0/dln q, m/T0, the normalisation) are read
// in place from one small device array. The lane program is a template on
// kExact: the launchers take integrate_lane<true> when nsx > 0, and in
// integrate_lane<false> every line of the block is a constant-false branch
// that folds away, so a path without exact species runs the arithmetic it
// ran before the block existed.
//
// Curvature K (sign sgnK) enters through s_l = sqrt(max(1 - K (l^2 - 1)/k^2,
// 0)), computed once per lane into its table `sl` in shared memory (the clamp
// keeps the closed k_min lanes, k^2 = (6 - 1e-4) K, real), cotKgen (one
// tan/tanh per right-hand side, only when sgnK != 0), the k^2 + 2K of the gw
// equation and the curved initial amplitude. With sgnK == 0 every s_l is
// exactly 1 and cotKgen = 1/(k tau): the flat arithmetic is unchanged.

#pragma once

#include <math.h>

#include "team.cuh"

#ifdef __CUDACC__
#define TK_FN __device__
#define TK_HOST_FN __host__ __device__
#define TK_TABLE __constant__ const
#else
#define TK_FN inline
#define TK_HOST_FN inline
#define TK_TABLE static const
#endif

namespace tk {

constexpr int kStages = 6;
constexpr int kNBg = 4;          // BG_COLS: a, H, rho_g, rho_ur (then p_ncdm per species)
constexpr int kNTh = 3;          // TH_COLS: dkappa, g, exp_m_kappa
constexpr int kFrameCols = 16;   // frame buffer: kNBg + ns + kNTh <= 16
constexpr double kSqrt6 = 2.449489742783178;

// status word of a lane
constexpr int kOk = 0, kIntervalCap = 1;

// Cash-Karp tableau, as in ops/ode.py
TK_TABLE double kC[kStages] = {0.0, 1.0 / 5.0, 3.0 / 10.0, 3.0 / 5.0, 1.0, 7.0 / 8.0};
TK_TABLE double kA[kStages][kStages - 1] = {
    {0, 0, 0, 0, 0},
    {1.0 / 5.0, 0, 0, 0, 0},
    {3.0 / 40.0, 9.0 / 40.0, 0, 0, 0},
    {3.0 / 10.0, -9.0 / 10.0, 6.0 / 5.0, 0, 0},
    {-11.0 / 54.0, 5.0 / 2.0, -70.0 / 27.0, 35.0 / 27.0, 0},
    {1631.0 / 55296.0, 175.0 / 512.0, 575.0 / 13824.0, 44275.0 / 110592.0, 253.0 / 4096.0}};
TK_TABLE double kB5[kStages] = {37.0 / 378.0, 0.0, 250.0 / 621.0, 125.0 / 594.0, 0.0,
                                512.0 / 1771.0};
TK_TABLE double kB4[kStages] = {2825.0 / 27648.0, 0.0, 18575.0 / 48384.0, 13525.0 / 55296.0,
                                277.0 / 14336.0, 1.0 / 4.0};

// State layout (TnIdx), filled by the Python wrapper in this order.
struct Layout {
  int n;          // state size; gw = 0, gw' = 1
  int F, nF;      // photon temperature l = 0..nF-1
  int G, nG;      // photon polarization
  int U, nU;      // massless neutrinos (nU = 0: method photons)
  int ns;         // ncdm species whose 3 p_ncdm drive the neutrino hierarchy
  int nc;         // first Psi_l(q) entry (method exact): species, then q, then l
  int nsx, nq, nl;  // exact ncdm species, momenta, multipoles l = 0..nl-1
};
constexpr int kLayoutInts = 12;

// The two table splines over ln(tau), and the exact species' momentum data:
// q (nq) shared, w and dlnf0 (nsx, nq), x_fac = m/T0 and pref (nsx).
struct Tables {
  const double* bg_y;
  const double* bg_y2;
  double bg_x0, bg_dx;
  int bg_n, bg_ncol;    // bg_ncol = kNBg + ns
  const double* th_y;
  const double* th_y2;
  double th_x0, th_dx;
  int th_n;
  const double *q, *w, *dlnf0, *x_fac, *pref;
};

// Point T's momentum pointers into `ncdm` (q, w, dlnf0, x_fac, pref packed in
// this order, tensors.py ncdm_pack); null without exact species.
TK_HOST_FN void set_ncdm(Tables& T, const Layout& L, const double* ncdm) {
  const long nsq = (long)L.nsx * L.nq;
  T.q = ncdm;
  T.w = ncdm ? ncdm + L.nq : nullptr;
  T.dlnf0 = ncdm ? T.w + nsq : nullptr;
  T.x_fac = ncdm ? T.dlnf0 + nsq : nullptr;
  T.pref = ncdm ? T.x_fac + L.nsx : nullptr;
}

typedef double* Vec;

// The threads that share a lane (team.cuh): one warp per lane on the card.
using team::Team;
using team::team_max;
using team::team_sum;
using team::team_sync;

struct Frame {
  double tau, a, H, rho_g, rho_rel, kap, g, emk;
};

struct Lane {
  double k, t_tca, t_rsa;
  double K;              // spatial curvature [Mpc^-2]
  int sgnK;              // its sign: 0 flat, -1 open, +1 closed
  const double* sl;      // s_l, l = 0..sl_count - 1 (set by integrate_lane)
};

// Entries of a lane's s_l table: s_{l+1} of the last moment of every
// hierarchy included (tensors.py sl_count).
TK_HOST_FN int sl_count(const Layout& L) {
  int c = L.nF;
  if (L.nG > c) c = L.nG;
  if (L.nU > c) c = L.nU;
  if (L.nsx && L.nl > c) c = L.nl;
  return c + 1;
}

// Table values at tau, the same in every thread; the table row meets in
// `buf` (kFrameCols doubles, shared by the team; team::table_row).
TK_FN void frame_at(const Tables& T, const Team& tm, double tau, double* buf, Frame& f) {
  const int nbg = T.bg_ncol;
  team::table_row(T, tm, kNTh, log(tau), buf);
  f.tau = tau;
  f.a = buf[0]; f.H = buf[1]; f.rho_g = buf[2];
  double rho_rel = buf[3];
  for (int s = 0; s < nbg - kNBg; ++s) rho_rel = rho_rel + 3.0 * buf[kNBg + s];
  f.rho_rel = rho_rel;
  f.kap = buf[nbg]; f.g = buf[nbg + 1]; f.emk = buf[nbg + 2];
}

// The free-streaming hierarchy derivative of block B (length nl) at moment
// l >= 1 away from the explicit low moments (tensors.py `_hier_deriv`):
// generic coupling, or the truncation at l = nl - 1, minus kap B_l.
TK_FN double hier(const double* B, int l, int nl, double k, double ck, const double* sl,
                  double kap) {
  const double d = l == nl - 1
                       ? k * (sl[l] * B[l - 1] - (double)nl * ck * B[l])
                       : k / (2.0 * l + 1.0) * ((double)l * sl[l] * B[l - 1]
                                                - (l + 1.0) * sl[l + 1] * B[l + 1]);
  return d - kap * B[l];
}

// gw at the initial time (tensors.py tensor_amplitude): 1/sqrt(6), times the
// curved eigentensor factor and, open, the bubble-nucleation factor.
TK_FN double gw_initial(const Lane& ln) {
  double amp = 1.0 / kSqrt6;
  if (ln.sgnK == 0) return amp;
  const double k2 = ln.k * ln.k, K = ln.K;
  amp = amp * sqrt(k2 * (k2 - K) / ((k2 + 3.0 * K) * (k2 + 2.0 * K)));
  if (ln.sgnK < 0) {
    const double q2 = fmax(k2 + 3.0 * K, 0.0);
    amp = amp * sqrt(tanh(3.141592653589793 / 2.0 * sqrt(q2) / sqrt(-K)));
    if (!(k2 + 3.0 * K >= 0.0)) amp = 0.0;
  }
  return amp;
}

TK_FN double P2_of(const Layout& L, const Vec y) {
  const double* F = y + L.F;
  const double* G = y + L.G;
  return -(1.0 / kSqrt6) * (F[0] / 10.0 + 2.0 / 7.0 * F[2] + 3.0 / 70.0 * F[4]
                            - 3.0 / 5.0 * G[0] + 6.0 / 7.0 * G[2] - 3.0 / 70.0 * G[4]);
}

// The anisotropic stress of the exact ncdm species in gw'' (tensors.py
// rhs_full): -sqrt(6) 4 a^2 sum_s pref_s/a^4 sum_q w q^4/eps (Psi0/15 +
// 2/21 Psi2 + Psi4/35), each species' q sum reduced over the team; the same
// in every thread.
TK_FN double gw_source_ncdm(const Layout& L, const Tables& T, const Team& tm, double a,
                            const Vec y) {
  const int nq = L.nq, nl = L.nl;
  const double a2 = a * a;
  double src = 0.0;
  for (int s = 0; s < L.nsx; ++s) {
    const double ax = a * T.x_fac[s];
    double part = 0.0;
    for (int iq = tm.tid; iq < nq; iq += tm.nt) {
      const double q = T.q[iq];
      const double eps = sqrt(q * q + ax * ax);
      const double qw = T.w[s * nq + iq] * (q * q);
      const double* P = y + L.nc + (s * nq + iq) * nl;
      part = part + qw * (q * q) / eps * (P[0] / 15.0 + 2.0 / 21.0 * P[2] + P[4] / 35.0);
    }
    src = src + T.pref[s] / (a2 * a2) * team_sum(tm, part);
  }
  return -kSqrt6 * 4.0 * a2 * src;
}

// dy/dtau into dy (tensors.py rhs_full); ends with team_sync(). kExact: the
// state carries the Psi_l(q) block (L.nsx > 0).
template <bool kExact>
TK_FN void rhs(const Layout& L, const Tables& T, const Team& tm, const Frame& fr,
               const Lane& ln, bool tca, bool rsa, const Vec y, Vec dy) {
  const double k = ln.k, k2 = k * k, K = ln.K;
  const double a = fr.a, aH = a * fr.H, a2 = a * a, kap = fr.kap;
  const bool hier_on = !tca && !rsa;
  const double* sl = ln.sl;
  const double s_l2 = sl[2], s_l3 = sl[3], s_l4 = sl[4], s2 = s_l2 * s_l2;
  double ck;
  if (ln.sgnK == 0) {
    ck = 1.0 / (k * fr.tau);
  } else {
    const double sab = sqrt(fabs(K));
    ck = sab / (k * (ln.sgnK > 0 ? tan(sab * fr.tau) : tanh(sab * fr.tau)));
  }
  const double* F = y + L.F;
  const double* G = y + L.G;
  const double* U = y + L.U;
  const double gwdot = y[1];
  const double gw_src_g =
      hier_on ? -kSqrt6 * 4.0 * a2 * fr.rho_g * (F[0] / 15.0 + 4.0 / 21.0 * F[2] + F[4] / 35.0)
              : 0.0;
  const double gw_src_ur =
      L.nU ? -kSqrt6 * 4.0 * a2 * fr.rho_rel * (U[0] / 15.0 + 4.0 / 21.0 * U[2] + U[4] / 35.0)
           : 0.0;
  double gw_src_nc = 0.0;
  if (kExact) gw_src_nc = gw_source_ncdm(L, T, tm, a, y);
  const double P2 = P2_of(L, y);
  for (int c = tm.tid; c < L.n; c += tm.nt) {
    double d;
    if (c == 0) {
      d = gwdot;
    } else if (c == 1) {
      d = -2.0 * aH * gwdot - (k2 + 2.0 * K) * y[0] + gw_src_g + gw_src_ur;
      if (kExact) d = d + gw_src_nc;
    } else if (c < L.G) {                     // photon temperature
      const int l = c - L.F;
      if (!hier_on) d = 0.0;
      else if (l == 0) d = -4.0 / 3.0 * F[1] - kap * (F[0] + kSqrt6 * P2) + kSqrt6 * gwdot;
      else if (l == 1) d = k2 * (F[0] / 4.0 - s_l2 * F[2]) - kap * F[1];
      else if (l == 2) d = 4.0 / 15.0 * s_l2 * F[1] - 3.0 / 10.0 * k * s_l3 * F[3] - kap * F[2];
      else if (l == 3) d = k / 7.0 * (6.0 * s_l3 * F[2] - 4.0 * s_l4 * F[4]) - kap * F[3];
      else d = hier(F, l, L.nF, k, ck, sl, kap);
    } else if (c < L.U) {                     // photon polarization
      const int l = c - L.G;
      if (!hier_on) d = 0.0;
      else if (l == 0) d = -k * G[1] - kap * (G[0] - kSqrt6 * P2);
      else d = hier(G, l, L.nG, k, ck, sl, kap);
    } else if (kExact && c >= L.nc) {         // exact ncdm Psi_l(q)
      const int nl = L.nl, e = c - L.nc, per = L.nq * nl;
      const int s = e / per, r = e - s * per, iq = r / nl, l = r - iq * nl;
      const double q = T.q[iq], ax = a * T.x_fac[s];
      const double qke = k * q / sqrt(q * q + ax * ax);
      const double* P = y + L.nc + (s * L.nq + iq) * nl;
      if (l == 0) d = -qke * P[1] - 0.25 * kSqrt6 * gwdot * T.dlnf0[s * L.nq + iq];
      else if (l == nl - 1) d = qke * P[l - 1] - (double)nl * k * ck * P[l];
      else d = qke / (2.0 * l + 1.0) * ((double)l * sl[l] * P[l - 1]
                                        - (l + 1.0) * sl[l + 1] * P[l + 1]);
    } else {                                  // massless neutrinos
      const int l = c - L.U;
      if (l == 0) d = -4.0 / 3.0 * U[1] + kSqrt6 * gwdot;
      else if (l == 1) d = k2 * (U[0] / 4.0 - s2 * U[2]);
      else if (l == 2) d = 4.0 / 15.0 * U[1] - 3.0 / 10.0 * k * s_l3 / s_l2 * U[3];
      else if (l == 3) d = k / 7.0 * (6.0 * s_l3 * s_l2 * U[2] - 4.0 * s_l4 * U[4]);
      else d = hier(U, l, L.nU, k, ck, sl, 0.0);
    }
    dy[c] = d;
  }
  team_sync(tm);
}

// (S_T2, S_P) at the frame's time (rhs_full's sources), the same in every thread.
TK_FN void sources(const Layout& L, const Frame& fr, bool tca, bool rsa, const Vec y,
                   double out[2]) {
  const double gwdot = y[1];
  const double P_src = rsa ? 0.0 : (tca ? 2.0 / 5.0 * kSqrt6 * gwdot / fr.kap : P2_of(L, y));
  out[0] = -gwdot * fr.emk + fr.g * P_src;
  out[1] = kSqrt6 * fr.g * P_src;
}

// Scratch of one lane, in doubles: y, Y, y5 (n each), the six stage
// derivatives (6 n), the frame buffer and the s_l table.
TK_HOST_FN long work_doubles(const Layout& L) { return 9L * L.n + kFrameCols + sl_count(L); }

// Integrate one lane from tau_ini through every sample (tensors.py
// tensor_rkck_plain / solve_one_k), writing its (S_T2, S_P) rows to S
// (ntau, 2). ln.sl is set to the lane's s_l table in `work`. Every thread
// returns the same status word and step count.
template <bool kExact>
TK_FN int integrate_lane(const Layout& L, const Tables& T, const Team& tm, Lane ln,
                         double tau_ini, const double* taus, int ntau, double rtol,
                         long max_interval_steps, const Vec work, double* S,
                         long long* nsteps_out) {
  const int tid = tm.tid, nt = tm.nt, n = L.n;
  const Vec y = work, Y = work + n, y5 = work + 2L * n, K = work + 3L * n;
  const Vec fbuf = work + 9L * n, sl = fbuf + kFrameCols;
  const double sw[2] = {ln.t_tca, ln.t_rsa};
  const double inf = INFINITY;

  const double k2 = ln.k * ln.k;
  for (int l = tid; l < sl_count(L); l += nt)
    sl[l] = ln.sgnK == 0 ? 1.0 : sqrt(fmax(1.0 - ln.K * ((double)l * l - 1.0) / k2, 0.0));
  ln.sl = sl;
  const double gw0 = gw_initial(ln);
  for (int c = tid; c < n; c += nt) y[c] = c == 0 ? gw0 : 0.0;
  team_sync(tm);
  Frame fr;
  double t = tau_ini, h = 0.1 * tau_ini;
  long long nsteps = 0;
  int status = kOk;
  for (int j = 0; j < ntau; ++j) {
    const double t_b = taus[j];
    if (!(t_b <= t)) {
      long n_int = 0;
      bool done = false;
      while (!done && n_int < max_interval_steps) {
        double t_stop = t_b;
        for (int s = 0; s < 2; ++s)
          if (sw[s] > t * (1.0 + 1e-14) && sw[s] < t_stop) t_stop = sw[s];
        const double h_eff = fmin(h, t_stop - t);
        const bool tca = t < ln.t_tca, rsa = t >= ln.t_rsa;
        // --- six Cash-Karp stages (ops/ode.py rkck_step)
        for (int i = 0; i < kStages; ++i) {
          const Vec Ys = i == 0 ? y : Y;
          if (i > 0) {
            for (int c = tid; c < n; c += nt) {
              double acc = kA[i][0] * K[c];
              for (int m = 1; m < i; ++m) acc = acc + kA[i][m] * K[(long)m * n + c];
              Y[c] = y[c] + h_eff * acc;
            }
            team_sync(tm);
          }
          frame_at(T, tm, t + kC[i] * h_eff, fbuf, fr);
          rhs<kExact>(L, T, tm, fr, ln, tca, rsa, Ys, K + (long)i * n);
        }
        // --- solution, embedded error and the error ratio
        double ratio = 0.0, bad = 0.0;
        for (int c = tid; c < n; c += nt) {
          double s5 = 0.0, s4 = 0.0;
          bool first5 = true, first4 = true;
          for (int m = 0; m < kStages; ++m) {
            const double f = K[(long)m * n + c];
            if (kB5[m] != 0.0) { s5 = first5 ? kB5[m] * f : s5 + kB5[m] * f; first5 = false; }
            if (kB4[m] != 0.0) { s4 = first4 ? kB4[m] * f : s4 + kB4[m] * f; first4 = false; }
          }
          const double v5 = y[c] + h_eff * s5, v4 = y[c] + h_eff * s4;
          y5[c] = v5;
          const double err = v5 - v4;
          const double scale = rtol * (fabs(y[c]) + fabs(h_eff * K[c]) + 1e-30) + 1e-11;
          const double r = fabs(err) / scale;
          if (!(r <= inf) || r == inf) bad = 1.0;
          else if (r > ratio) ratio = r;
        }
        ratio = team_max(tm, ratio);
        bad = team_max(tm, bad);
        if (bad > 0.0) ratio = inf;

        const bool accept = ratio <= 1.0;
        double fac = 0.9 * (ratio > 0.0 ? pow(ratio, -0.2) : 5.0);
        fac = fac < 0.2 ? 0.2 : (fac > 5.0 ? 5.0 : fac);
        const double h_next = (accept && h_eff < h) ? fmax(h, h_eff * fac) : h_eff * fac;
        const double t_new = accept ? t + h_eff : t;
        ++nsteps;
        ++n_int;
        h = fmax(h_next, 1e-300);
        if (accept) {
          team_sync(tm);   // every thread has read y for the ratio
          for (int c = tid; c < n; c += nt) y[c] = y5[c];
          team_sync(tm);
          // remaps where the step lands on a switch time
          if (t_new >= sw[0] && t < sw[0]) {          // tight coupling off
            frame_at(T, tm, t_new, fbuf, fr);
            const double gwdot = y[1];
            team_sync(tm);
            if (tid == 0) {
              y[L.F] = -4.0 / 3.0 * gwdot / fr.kap;
              y[L.G] = 1.0 / 3.0 * gwdot / fr.kap;
            }
            team_sync(tm);
          }
          if (t_new >= sw[1] && t < sw[1]) {          // radiation streaming on
            for (int c = L.F + tid; c < L.G + L.nG; c += nt) y[c] = 0.0;
            team_sync(tm);
          }
          t = t_new;
          done = t_new >= t_b * (1.0 - 1e-15);
        }
      }
      if (!done) status = kIntervalCap;
    }
    frame_at(T, tm, t_b, fbuf, fr);
    double s[2];
    sources(L, fr, t_b < ln.t_tca, t_b >= ln.t_rsa, y, s);
    if (tid == 0) {
      S[2L * j] = s[0];
      S[2L * j + 1] = s[1];
    }
    t = t_b;
  }
  *nsteps_out = nsteps;
  return status;
}

}  // namespace tk

// Per-lane scalar perturbation integrator: equations, IMEX step and source
// emission for ONE k mode, written as plain C++ functions for a TEAM of
// threads that share the lane's vectors: every loop over state components,
// hierarchy moments or momenta is strided over the team (`for (c = tid; c < n;
// c += nt)`), the scalar Einstein/tight-coupling block and all step control are
// computed redundantly by every thread (so every branch is uniform), and the
// momentum sums and the error ratio are butterfly reductions that leave the
// same bits in every thread. perturb_ark.cu runs one lane per warp (a team of
// 32) on vectors in shared memory; compiled without nvcc the same functions
// build for the host with a team of one, which is how the arithmetic can be
// checked against the plain PyTorch version without a card.
//
// Synchronisation rule: a function that writes a shared vector ends with
// team_sync(); a function that reads may assume its inputs are visible.
//
// Counterparts, line by line: classpp_public_torch/models/perturbations/
// equations.py (rhs_full, stiff_apply, stiff_solve, adiabatic_ic,
// isocurvature_ic, ic_to_newtonian, the remaps, compute_sources), ops/ode.py
// (ark_step) and solve.py (_step). Open, flat or closed universe, synchronous
// or Newtonian gauge, the adiabatic mode and (flat) the four isocurvature
// modes, picked per lane (Lane::ic); photons, polarization, baryons, cdm,
// massless neutrinos, n_s massive-neutrino species on a shared momentum grid,
// and the metric.
//
// The initial condition only sets the lane's first state: the adiabatic lanes
// run adiabatic_ic, which is the code it was, and the isocurvature lanes
// isocurvature_ic; the step loop is the same for every lane.
//
// The gauge is a template parameter kNewt of the lane program (rhs_full,
// adiabatic_ic, remap_tca_off, compute_sources, integrate_lane), so that the
// synchronous instance is the arithmetic it was: every Newtonian term sits
// behind `if constexpr (kNewt)` or a `kNewt ? ... : ...` whose synchronous
// side is the synchronous expression, and folds away there. In the Newtonian
// instance the eta slot holds phi, psi is constrained, theta_cdm evolves, and
// the species see metric_continuity = -3 phi', metric_euler = k^2 psi,
// metric_shear = 0 and metric_ufa = -6 phi' (equations.py rhs_full).
//
// A quintessence scalar field (synchronous gauge only) is a second template
// parameter kScf: its (delta phi, delta phi') pair sits after the ncdm block
// (Layout::phi_scf, -1 without the field), its four background columns
// (rho_scf, phi', dV, ddV) after the ncdm columns of the frame, and every scf
// term behind `if constexpr (kScf)`, so that the instances without it are the
// arithmetic they were (equations.py rhs_full; JAX equations.py:301-306,
// :395-410, :847-851, :928-929).
//
// Interacting dark matter with interacting dark radiation (idm_dr,
// synchronous gauge only) is a third template parameter kIdm: its block sits
// after the ur hierarchy (LayoutIdm::idm; the ncdm block moves
// behind it, and every access goes through Layout::ncdm), its two background
// columns (rho_idm_dr, rho_idr) after the ncdm columns and its three
// thermodynamics columns (dmu_idm_dr, dmu_idr, cidm_dr2) after the six of the
// frame, and every idm term behind `if constexpr (kIdm)` (equations.py
// rhs_full, stiff_apply, stiff_solve, adiabatic_ic; JAX equations.py:307-318,
// :382-389, :818-844, :880-931, :996-1102, :1125-1177). The idm-idr momentum
// exchange and the idr's per-l damping are stiff: in this instance the
// implicit range runs to the end of the idr block (n_stiff), with J zero
// and the solve the identity between theta_b and the block, and the idm terms
// are not masked under TCA or RSA as the photon drag is. The damping's alpha_l
// and beta_l come in a small table behind the ncdm data (TablesIdm::idr_alpha,
// idr_beta), not as constants: two parameter sets differ only in them.
//
// Curvature K (sign sgnK) enters through s_l = sqrt(max(1 - K (l^2 - 1)/k^2,
// 0)), s2 = 1 - 3 K/k^2 and cotKgen = sqrt|K| cot_K(sqrt|K| tau)/k. The s_l
// of a lane are computed once, into its table `sl` in shared memory, so a step
// pays no sqrt per hierarchy row; cotKgen costs one tan/tanh per right-hand
// side, and only when sgnK != 0. With sgnK == 0 every s_l is exactly 1 and
// cotKgen = 1/(k tau): the flat arithmetic is unchanged, since a product with
// an exact 1 rounds to the same double.

#pragma once

#include <math.h>

#include <type_traits>

#include "team.cuh"

#ifdef __CUDACC__
#define PK_FN __device__
#define PK_HOST_FN __host__ __device__
#define PK_TABLE __constant__ const
#else
#define PK_FN inline
#define PK_HOST_FN inline
#define PK_TABLE static const
#endif

namespace pk {

constexpr int kNSrc = 27;        // SrcIdx.n
constexpr int kNBgBase = 10;     // BG_COLS without the ncdm columns
constexpr int kNTh = 6;          // TH_COLS
constexpr int kNScf = 4;         // SCF_COLS: rho_scf, phi_prime_scf, dV_scf, ddV_scf
constexpr int kNIdmBg = 2;       // IDM_BG_COLS: rho_idm_dr, rho_idr
constexpr int kNIdmTh = 3;       // IDM_TH_COLS: dmu_idm_dr, dmu_idr, cidm_dr2
constexpr int kStages = 6;

// status word of a lane
constexpr int kOk = 0, kTooManySteps = 1, kNonFinite = 2;

// Section profile of integrate_lane, compiled in with -DPK_PROFILE (card
// only): cycles (clock64) spent in each section, summed over the lane's steps.
// Sections: 0 table reads, 1 stage combination, 2 stiff solve, 3 stiff apply,
// 4 right-hand side, 5 explicit part, 6 solution/error sums and ratio,
// 7 step control, remaps and sources.
constexpr int kProfSections = 8;
#if defined(__CUDACC__) && defined(PK_PROFILE)
#define PK_PROF_BEGIN long long prof_[pk::kProfSections] = {}; long long prof_t_ = clock64();
#define PK_PROF(i) { const long long c_ = clock64(); prof_[i] += c_ - prof_t_; prof_t_ = c_; }
#define PK_PROF_END(out) \
  if (tm.tid == 0 && (out)) for (int i_ = 0; i_ < pk::kProfSections; ++i_) (out)[i_] = prof_[i_];
#else
#define PK_PROF_BEGIN
#define PK_PROF(i)
#define PK_PROF_END(out)
#endif

// ARK4(3)6L[2]SA (Kennedy & Carpenter 2003), as in ops/ode.py
PK_TABLE double kGamma = 0.25;
PK_TABLE double kC[kStages] = {0.0, 1.0 / 2.0, 83.0 / 250.0, 31.0 / 50.0, 17.0 / 20.0, 1.0};
PK_TABLE double kAE[kStages][kStages - 1] = {
    {0, 0, 0, 0, 0},
    {1.0 / 2.0, 0, 0, 0, 0},
    {13861.0 / 62500.0, 6889.0 / 62500.0, 0, 0, 0},
    {-116923316275.0 / 2393684061468.0, -2731218467317.0 / 15368042101831.0,
     9408046702089.0 / 11113171139209.0, 0, 0},
    {-451086348788.0 / 2902428689909.0, -2682348792572.0 / 7519795681897.0,
     12662868775082.0 / 11960479115383.0, 3355817975965.0 / 11060851509271.0, 0},
    {647845179188.0 / 3216320057751.0, 73281519250.0 / 8382639484533.0,
     552539513391.0 / 3454668386233.0, 3354512671639.0 / 8306763924573.0, 4040.0 / 17871.0}};
PK_TABLE double kAI[kStages][kStages - 1] = {
    {0, 0, 0, 0, 0},
    {1.0 / 4.0, 0, 0, 0, 0},
    {8611.0 / 62500.0, -1743.0 / 31250.0, 0, 0, 0},
    {5012029.0 / 34652500.0, -654441.0 / 2922500.0, 174375.0 / 388108.0, 0, 0},
    {15267082809.0 / 155376265600.0, -71443401.0 / 120774400.0, 730878875.0 / 902184768.0,
     2285395.0 / 8070912.0, 0},
    {82889.0 / 524892.0, 0.0, 15625.0 / 83664.0, 69875.0 / 102672.0, -2260.0 / 8211.0}};
PK_TABLE double kB[kStages] = {82889.0 / 524892.0, 0.0, 15625.0 / 83664.0,
                               69875.0 / 102672.0, -2260.0 / 8211.0, 1.0 / 4.0};
PK_TABLE double kBH[kStages] = {4586570599.0 / 29645900160.0, 0.0,
                                178811875.0 / 945068544.0, 814220225.0 / 1159782912.0,
                                -3700637.0 / 11593932.0, 61727.0 / 225920.0};

// State layout (PtIdx): offsets and lengths, filled by the Python wrapper in
// this order.
struct Layout {
  int n;                        // state size
  int delta_g, theta_g, shear_g;
  int F_g, n_F_g;               // l = 3..l_max_g
  int G_g, n_G_g;               // l = 0..l_max_pol_g
  int delta_b, theta_b, delta_cdm;
  int theta_cdm;                // Newtonian gauge only; -1 in the synchronous gauge
  int delta_ur, theta_ur, shear_ur;
  int F_ur, n_F_ur;             // l = 3..l_max_ur
  int ncdm, ns, nq, nl;         // ncdm block: (ns, nq, nl)
  int eta;
  int phi_scf;                  // delta phi, delta phi' of a scalar field; -1 without one
};

// The layout of the idm instance: the idm_dr block's offsets beside it. The
// instances without idm_dr take Layout itself, so that their kernels keep
// the parameters (and so the code) they had.
struct LayoutIdm : Layout {
  int idm;                      // delta_idm_dr (then theta_idm, delta_idr, theta_idr,
                                // shear_idr, F_idr)
  int n_F_idr;                  // idr moments l = 3..l_max_idr; 0 in fluid mode
  int idr_fluid;                // 1: idr_nature = fluid (the shear slot stays 0)
};

// The host ints of a layout (solve.py _layout_ints): Layout's fields through
// eta, the idm block's three (idm -1 without it), then phi_scf.
constexpr int kLayoutInts = 26;
PK_HOST_FN void read_layout(const int* ints, LayoutIdm& L) {
  Layout& B = L;
  int* li = reinterpret_cast<int*>(&B);
  for (int i = 0; i < 22; ++i) li[i] = ints[i];
  L.phi_scf = ints[25];
  L.idm = ints[22];
  L.n_F_idr = ints[23];
  L.idr_fluid = ints[24];
}

// The two table splines over ln(tau) and the ncdm momentum data.
struct Tables {
  const double* bg_y;
  const double* bg_y2;
  double bg_x0, bg_dx;
  int bg_n, bg_ncol;            // bg_ncol = bg_cols(L): kNBgBase + 3 ns (+ kNScf)
  const double* th_y;
  const double* th_y2;
  double th_x0, th_dx;
  int th_n;
  const double* q;              // (nq,)
  const double* w;              // (ns, nq)
  const double* dlnf0;          // (ns, nq)
  const double* x_fac;          // (ns,)
  const double* pref;           // (ns,)
};

// The tables of the idm instance: the idr damping's coefficients beside them.
struct TablesIdm : Tables {
  const double* idr_alpha;      // (1 + n_F_idr,) alpha_l, l = 2..l_max_idr
  const double* idr_beta;       // (1 + n_F_idr,) beta_l
};

template <bool kIdm>
using LayoutOf = typename std::conditional<kIdm, LayoutIdm, Layout>::type;
template <bool kIdm>
using TablesOf = typename std::conditional<kIdm, TablesIdm, Tables>::type;

// One lane's vector (contiguous).
typedef double* Vec;

// The threads that share a lane (team.cuh): one warp per lane on the card.
using team::Team;
using team::team_max;
using team::team_sum;
using team::team_sync;

struct Frame {
  double tau, a, H, Hp, rho_g, rho_b, rho_cdm, rho_ur, rho_tot, p_tot, p_tot_prime;
  double kap, kapp, g, dg, emk, cb2;
  // rho, p and p' of ncdm species s: nc[3 s], nc[3 s + 1], nc[3 s + 2], the
  // ncdm columns of the frame buffer (valid until the next frame_at)
  const double* nc;
  // with a scalar field its kNScf columns, after the ncdm ones
  const double* scf;
};

struct Flags {
  bool tca, rsa, ufa, ncfa;
};

// Initial conditions: a lane's code (equations.py IC_KINDS).
constexpr int kIcAd = 0, kIcBi = 1, kIcCdi = 2, kIcNid = 3, kIcNiv = 4;

struct Lane {
  double k, eta_off, t_tca, t_ufa, t_rsa, t_ncfa;
  double K;                     // spatial curvature [Mpc^-2]
  int sgnK;                     // its sign: 0 flat, -1 open, +1 closed
  const double* sl;             // s_l, l = 0..sl_count - 1 (set by integrate_lane)
  int ic;                       // initial condition, kIcAd ... kIcNiv
};

// Entries of a lane's s_l table: every l a hierarchy couples, s_{l+1} of its
// last moment included (solve.py sl_count).
PK_HOST_FN int sl_count(const Layout& L) {
  int c = L.n_F_g + 4;
  if (L.n_G_g + 1 > c) c = L.n_G_g + 1;
  if (L.n_F_ur + 4 > c) c = L.n_F_ur + 4;
  if (L.nl + 1 > c) c = L.nl + 1;
  return c;
}
PK_HOST_FN int sl_count(const LayoutIdm& L) {
  const int c = sl_count(static_cast<const Layout&>(L));
  return L.n_F_idr + 4 > c ? L.n_F_idr + 4 : c;
}

// The implicit range [0, n_stiff): to theta_b, or with idm_dr to the end of
// the idr block.
template <bool kIdm>
PK_HOST_FN int n_stiff(const LayoutOf<kIdm>& L) {
  if constexpr (kIdm) return L.idm + 5 + L.n_F_idr;
  else return L.theta_b + 1;
}

// cotKgen at tau: 1/(k tau) when flat.
PK_FN double cot_kgen(const Lane& ln, double tau) {
  if (ln.sgnK == 0) return 1.0 / (ln.k * tau);
  const double sab = sqrt(fabs(ln.K));
  return sab / (ln.k * (ln.sgnK > 0 ? tan(sab * tau) : tanh(sab * tau)));
}

struct Locals {
  double aH, aH_prime, h_prime, eta_prime, alpha, alpha_prime, P;
  double delta_m, theta_m, delta_cb, theta_cb, theta_b_prime, eta;
  double phi, psi, phi_plus_psi, phi_prime;
  double delta_g_eff, theta_g_eff, delta_ur_eff, theta_ur_eff;
  double delta_nc, theta_nc, delta_tot, theta_tot, H_T_Nb_prime;
};

PK_FN Flags flags_at(const Lane& ln, double t) {
  return Flags{t < ln.t_tca, t >= ln.t_rsa, t >= ln.t_ufa, t >= ln.t_ncfa};
}

// Background columns of the tables: the base ones, 3 per ncdm species and
// the scalar field's or idm_dr's.
PK_HOST_FN int bg_cols(const Layout& L) {
  return kNBgBase + 3 * L.ns + (L.phi_scf >= 0 ? kNScf : 0);
}
PK_HOST_FN int bg_cols(const LayoutIdm& L) { return kNBgBase + 3 * L.ns + kNIdmBg; }

// Doubles of the frame buffer of the instance kScf: the background columns
// and the thermodynamics columns; frame_cols(L), that of the layout's.
template <bool kScf>
PK_HOST_FN int frame_cols_of(const Layout& L) {
  if constexpr (kScf) return kNBgBase + 3 * L.ns + kNScf + kNTh;
  return kNBgBase + 3 * L.ns + kNTh;
}
PK_HOST_FN int frame_cols(const Layout& L) {
  return L.phi_scf >= 0 ? frame_cols_of<true>(L) : frame_cols_of<false>(L);
}
// the idm instance's: idm_dr's two background and three thermodynamics
// columns beside the base ones
PK_HOST_FN int frame_cols(const LayoutIdm& L) {
  return kNBgBase + 3 * L.ns + kNIdmBg + kNTh + kNIdmTh;
}
// that of the instance (kScf, kIdm)
template <bool kScf, bool kIdm>
PK_HOST_FN int frame_cols_of_instance(const LayoutOf<kIdm>& L) {
  if constexpr (kIdm) return frame_cols(L);
  else return frame_cols_of<kScf>(L);
}

// Table values at tau, the same in every thread. `buf` (frame_cols doubles,
// shared by the team) carries the table row across (team::table_row).
PK_FN void frame_at(const Tables& T, const Team& tm, double tau, double* buf, Frame& f) {
  const int nbg = T.bg_ncol;
  team::table_row(T, tm, kNTh, log(tau), buf);
  const double* bgv = buf;
  const double* thv = buf + nbg;
  f.tau = tau;
  f.a = bgv[0]; f.H = bgv[1]; f.Hp = bgv[2]; f.rho_g = bgv[3]; f.rho_b = bgv[4];
  f.rho_cdm = bgv[5]; f.rho_ur = bgv[6]; f.rho_tot = bgv[7]; f.p_tot = bgv[8];
  f.p_tot_prime = bgv[9];
  f.nc = bgv + kNBgBase;
  f.scf = bgv + nbg - kNScf;
  f.kap = thv[0]; f.kapp = thv[1]; f.g = thv[2]; f.dg = thv[3]; f.emk = thv[4];
  f.cb2 = thv[5];
}

// frame_at for the idm instance: the table row with idm_dr's three
// thermodynamics columns too (read by idm_at).
PK_FN void frame_at_idm(const Tables& T, const Team& tm, double tau, double* buf, Frame& f) {
  const int nbg = T.bg_ncol;
  team::table_row(T, tm, kNTh + kNIdmTh, log(tau), buf);
  const double* bgv = buf;
  const double* thv = buf + nbg;
  f.tau = tau;
  f.a = bgv[0]; f.H = bgv[1]; f.Hp = bgv[2]; f.rho_g = bgv[3]; f.rho_b = bgv[4];
  f.rho_cdm = bgv[5]; f.rho_ur = bgv[6]; f.rho_tot = bgv[7]; f.p_tot = bgv[8];
  f.p_tot_prime = bgv[9];
  f.nc = bgv + kNBgBase;
  f.scf = bgv + nbg - kNScf;
  f.kap = thv[0]; f.kapp = thv[1]; f.g = thv[2]; f.dg = thv[3]; f.emk = thv[4];
  f.cb2 = thv[5];
}

// The frame of the instance: frame_at, or with idm_dr frame_at_idm.
template <bool kIdm>
PK_FN void frame_of(const Tables& T, const Team& tm, double tau, double* buf, Frame& f) {
  if constexpr (kIdm)
    frame_at_idm(T, tm, tau, buf, f);
  else
    frame_at(T, tm, tau, buf, f);
}

// idm_dr's values at the time of a frame that frame_at_idm filled, read from
// its buffer: rho_idm_dr, rho_idr (the last background columns) and
// dmu_idm_dr, dmu_idr, cidm_dr2 (after the kNTh thermodynamics columns).
struct Idm {
  double rho_idm, rho_idr, dmu_idm, dmu_idr, cidm2;
};
PK_FN Idm idm_at(const Tables& T, const Frame& fr) {
  const double* bgv = fr.nc - kNBgBase;
  const double* thv = bgv + T.bg_ncol;
  return Idm{bgv[T.bg_ncol - kNIdmBg], bgv[T.bg_ncol - 1], thv[kNTh], thv[kNTh + 1],
             thv[kNTh + 2]};
}

// The exact ncdm momentum sums of species s (perturb_total_stress_energy
// :6347-6395), reduced over the team: out = {sum qw eps Psi0, sum qw q Psi1,
// sum qw q^2/eps Psi2, sum qw q^2/eps Psi0}, the same in every thread.
PK_FN void ncdm_sums(const Layout& L, const Tables& T, const Team& tm, double a, int s,
                     const Vec y, double out[4]) {
  const int nq = L.nq, nl = L.nl, base = L.ncdm + s * nq * nl;
  const double ax = a * T.x_fac[s];
  double s0 = 0.0, s1 = 0.0, s2 = 0.0, s3 = 0.0;
  for (int iq = tm.tid; iq < nq; iq += tm.nt) {
    const double q = T.q[iq];
    const double eps = sqrt(q * q + ax * ax);
    const double qw = T.w[s * nq + iq] * q * q;
    const int o = base + iq * nl;
    const double P0 = y[o], P1 = y[o + 1], P2 = y[o + 2];
    s0 += qw * eps * P0;
    s1 += qw * q * P1;
    s2 += qw * q * q / eps * P2;
    s3 += qw * q * q / eps * P0;
  }
  out[0] = team_sum(tm, s0); out[1] = team_sum(tm, s1);
  out[2] = team_sum(tm, s2); out[3] = team_sum(tm, s3);
}

// dy/dtau into dy (when want_dy) and the local quantities the sources need
// (equations.py rhs_full), the same in every thread. Under the ncdm fluid
// approximation with one species only the three fluid slots of the ncdm block
// are written: the caller skips the rest of the block (its state and
// derivative are zero). Ends with team_sync() when it wrote dy.
template <bool kNewt, bool kScf, bool kIdm = false>
PK_FN void rhs_full(const LayoutOf<kIdm>& L, const TablesOf<kIdm>& T, const Team& tm,
                    const Frame& fr,
                    const Lane& ln, const Flags& fl, const Vec y, const Vec dy, bool want_dy,
                    Locals& loc) {
  const int tid = tm.tid, nt = tm.nt;
  const double k = ln.k, k2 = k * k, tau = fr.tau;
  const double a = fr.a, H = fr.H, Hp = fr.Hp;
  const double rho_g = fr.rho_g, rho_b = fr.rho_b, rho_cdm = fr.rho_cdm, rho_ur = fr.rho_ur;
  const double kap = fr.kap, kapp = fr.kapp, cb2 = fr.cb2;
  const double a2 = a * a, aH = a * H;
  const double app_a = Hp * a + 2.0 * aH * aH;
  const double aH_prime = Hp * a + aH * aH;
  const double R = 4.0 / 3.0 * rho_g / rho_b;
  const double cotKgen = cot_kgen(ln, tau);
  const double* sl = ln.sl;
  const double K = ln.K, s2 = 1.0 - 3.0 * K / k2, s_l2 = sl[2], s_l3 = sl[3];
  const bool tca = fl.tca, rsa = fl.rsa, ufa = fl.ufa, ncfa = fl.ncfa;

  const double delta_g = y[L.delta_g], theta_g = y[L.theta_g], shear_g = y[L.shear_g];
  const double delta_b = y[L.delta_b], theta_b = y[L.theta_b], delta_cdm = y[L.delta_cdm];
  const double delta_ur = y[L.delta_ur], theta_ur = y[L.theta_ur], shear_ur = y[L.shear_ur];
  const double eta = y[L.eta] + ln.eta_off;
  const double G0 = y[L.G_g], G2 = y[L.G_g + 2];

  // ncdm: exact momentum sums or fluid variables, per species
  // (JAX equations.py:320-346)
  const int ns = L.ns, nq = L.nq, nl = L.nl;
  double sum_rho_delta = 0.0, sum_rpt = 0.0, sum_rps = 0.0, sum_dp = 0.0;
  double sum_rho_nc = 0.0, sum_rpp_nc = 0.0;
  for (int s = 0; s < ns; ++s) {
    const int base = L.ncdm + s * nq * nl;
    const double rho_s = fr.nc[3 * s], p_s = fr.nc[3 * s + 1], pp_s = fr.nc[3 * s + 2];
    const double w_s = p_s / rho_s;
    double rd, rt, rs, dp;
    if (ncfa) {
      const double d_fl = y[base], t_fl = y[base + 1], s_fl = y[base + 2];
      const double cg2 = w_s * (1.0 - (3.0 * w_s - 2.0 + pp_s / p_s) / (3.0 + 3.0 * w_s));
      rd = rho_s * d_fl;
      rt = (rho_s + p_s) * t_fl;
      rs = (rho_s + p_s) * s_fl;
      dp = cg2 * rho_s * d_fl;
    } else {
      const double fac = T.pref[s] / a2 / a2;
      double sm[4];
      ncdm_sums(L, T, tm, a, s, y, sm);
      rd = fac * sm[0];
      rt = k * fac * sm[1];
      rs = 2.0 / 3.0 * fac * sm[2];
      dp = fac / 3.0 * sm[3];
    }
    sum_rho_delta += rd; sum_rpt += rt; sum_rps += rs; sum_dp += dp;
    sum_rho_nc += rho_s; sum_rpp_nc += rho_s + p_s;
  }

  // effective photon/ur variables in the Einstein sums
  const double d_g0 = rsa ? 0.0 : delta_g, t_g0 = rsa ? 0.0 : theta_g;
  const double s_g0 = (rsa || tca) ? 0.0 : shear_g;
  const double d_ur0 = rsa ? 0.0 : delta_ur, t_ur0 = rsa ? 0.0 : theta_ur;
  const double s_ur0 = rsa ? 0.0 : shear_ur;
  double delta_rho = rho_g * d_g0 + rho_b * delta_b + rho_cdm * delta_cdm + rho_ur * d_ur0;
  double rho_plus_p_theta = 4.0 / 3.0 * rho_g * t_g0 + rho_b * theta_b
                            + 4.0 / 3.0 * rho_ur * t_ur0;
  double rho_plus_p_shear = 4.0 / 3.0 * rho_g * s_g0 + 4.0 / 3.0 * rho_ur * s_ur0;
  double delta_p = 1.0 / 3.0 * rho_g * d_g0 + cb2 * rho_b * delta_b + 1.0 / 3.0 * rho_ur * d_ur0;
  // idm_dr and idr, before the ncdm sums (JAX equations.py:382-389)
  double delta_idm = 0.0, theta_idm = 0.0, delta_idr = 0.0, theta_idr = 0.0, shear_idr = 0.0;
  Idm im{};
  if constexpr (kIdm) {
    im = idm_at(T, fr);
    delta_idm = y[L.idm];
    theta_idm = y[L.idm + 1];
    delta_idr = y[L.idm + 2];
    theta_idr = y[L.idm + 3];
    shear_idr = y[L.idm + 4];
    delta_rho = delta_rho + im.rho_idm * delta_idm + im.rho_idr * delta_idr;
    rho_plus_p_theta = rho_plus_p_theta + im.rho_idm * theta_idm
                       + 4.0 / 3.0 * im.rho_idr * theta_idr;
    if (!L.idr_fluid) rho_plus_p_shear = rho_plus_p_shear + 4.0 / 3.0 * im.rho_idr * shear_idr;
    delta_p = delta_p + 1.0 / 3.0 * im.rho_idr * delta_idr;
  }
  if (ns) {
    delta_rho += sum_rho_delta;
    rho_plus_p_theta += sum_rpt;
    rho_plus_p_shear += sum_rps;
    delta_p += sum_dp;
  }
  // the scalar field's stress-energy (JAX equations.py:395-410, synchronous)
  double dphi = 0.0, dphip = 0.0, phip_bg = 0.0, ddV_bg = 0.0;
  if constexpr (kScf) {
    dphi = y[L.phi_scf];
    dphip = y[L.phi_scf + 1];
    phip_bg = fr.scf[1];
    ddV_bg = fr.scf[3];
    const double dV_bg = fr.scf[2];
    delta_rho += (phip_bg * dphip / a2 + dV_bg * dphi) / 3.0;
    rho_plus_p_theta += k2 / a2 * phip_bg * dphi / 3.0;
    delta_p += (phip_bg * dphip / a2 - dV_bg * dphi) / 3.0;
  }

  // Einstein equations, the radiation-streaming values and the metric terms
  // of the species' equations
  double h_prime, rsa_delta_g, rsa_theta_g, rsa_delta_ur, rsa_theta_ur;
  double eta_prime, alpha, alpha_prime, phi, psi, phi_prime, phi_plus_psi;
  double metric_continuity, metric_euler, metric_shear, metric_shear_prime, metric_ufa;
  double theta_cdm = 0.0;
  if constexpr (kNewt) {
    // the slot holds phi; under TCA the photon shear in psi is its
    // first-order value; no radiation correction under RSA here
    // (JAX equations.py:496-528)
    phi = eta;
    theta_cdm = y[L.theta_cdm];
    rho_plus_p_theta += rho_cdm * theta_cdm;
    const double rho_plus_p_shear_psi =
        rho_plus_p_shear + (tca ? 4.0 / 3.0 * rho_g * 16.0 / 45.0 / kap * theta_g : 0.0);
    psi = phi - 4.5 * (a2 / k2) * rho_plus_p_shear_psi;
    phi_prime = -aH * psi + 1.5 * (a2 / k2) * rho_plus_p_theta;
    rsa_delta_g = -4.0 * phi - 4.0 / k2 * kap * theta_b;
    rsa_theta_g = 6.0 * phi_prime + 3.0 / k2 * (
        kapp * theta_b + kap * (-aH * theta_b + cb2 * k2 * delta_b + k2 * phi));
    rsa_delta_ur = -4.0 * phi;
    rsa_theta_ur = 6.0 * phi_prime;
    metric_continuity = -3.0 * phi_prime;
    metric_euler = k2 * psi;
    metric_shear = 0.0;
    metric_shear_prime = 0.0;
    metric_ufa = -6.0 * phi_prime;
    h_prime = 0.0;
    eta_prime = phi_prime;
    alpha = 0.0;
    alpha_prime = 0.0;
    phi_plus_psi = phi + psi;
  } else {
    // Einstein 00 and the radiation-streaming values
    h_prime = (k2 * s2 * eta + 1.5 * a2 * delta_rho) / (0.5 * aH);
    rsa_delta_g = 4.0 / k2 * (aH * h_prime - k2 * eta)
                  - 4.0 / k2 * kap * (theta_b + 0.5 * h_prime);
    rsa_theta_g = -0.5 * h_prime + 3.0 / k2 * (
        kapp * (theta_b + 0.5 * h_prime)
        + kap * (-aH * theta_b + cb2 * k2 * delta_b - aH * h_prime + k2 * eta));
    rsa_delta_ur = 4.0 / k2 * (aH * h_prime - k2 * eta);
    rsa_theta_ur = -0.5 * h_prime;
    if (rsa) {
      delta_rho += rho_g * rsa_delta_g + rho_ur * rsa_delta_ur;
      rho_plus_p_theta += 4.0 / 3.0 * rho_g * rsa_theta_g + 4.0 / 3.0 * rho_ur * rsa_theta_ur;
    }

    // Einstein 0i, trace, shear
    eta_prime = (1.5 * a2 * rho_plus_p_theta + 0.5 * K * h_prime) / (k2 * s2);
    alpha = (h_prime + 6.0 * eta_prime) / (2.0 * k2);
    const double tca_shear_g_1 = 16.0 / 45.0 / kap * (theta_g + k2 * alpha);
    if (tca) rho_plus_p_shear += 4.0 / 3.0 * rho_g * tca_shear_g_1;
    alpha_prime = -2.0 * aH * alpha + eta - 4.5 * (a2 / k2) * rho_plus_p_shear;
    metric_continuity = 0.5 * h_prime;
    metric_shear = k2 * alpha;
    metric_shear_prime = k2 * alpha_prime;
    metric_euler = 0.0;
    metric_ufa = metric_continuity;
    phi = eta - aH * alpha;
    psi = aH * alpha + alpha_prime;
    phi_plus_psi = eta + alpha_prime;
    phi_prime = eta_prime - aH_prime * alpha - aH * alpha_prime;
  }

  const double d_g = rsa ? rsa_delta_g : delta_g;
  const double t_g = rsa ? rsa_theta_g : theta_g;

  // TCA slip and shear, compromise_CLASS
  const double tau_c = 1.0 / kap;
  const double dtau_c = -kapp * tau_c * tau_c;
  const double F = tau_c / (1.0 + R);
  const double F_prime = dtau_c / (1.0 + R) + tau_c * aH * R / ((1.0 + R) * (1.0 + R));
  const double slip_1 = kNewt
      ? (dtau_c / tau_c - 2.0 * aH / (1.0 + R)) * (theta_b - t_g) + F * (
            -app_a * theta_b
            + k2 * (-aH * d_g / 2.0 + cb2 * (-theta_b - metric_continuity)
                    + (t_g + metric_continuity) / 3.0)
            - aH * metric_euler)
      : (dtau_c / tau_c - 2.0 * aH / (1.0 + R)) * (theta_b - t_g) + F * (
      -app_a * theta_b
      + k2 * (-aH * d_g / 2.0 + cb2 * (-theta_b - metric_continuity)
              + (t_g + metric_continuity) / 3.0));
  const double shear_g_tca1 = 16.0 / 45.0 * tau_c * (t_g + metric_shear);
  const double theta_prime0 = kNewt
      ? (-aH * theta_b + k2 * (cb2 * delta_b + R / 4.0 * d_g)) / (1.0 + R) + metric_euler
      : (-aH * theta_b + k2 * (cb2 * delta_b + R / 4.0 * d_g)) / (1.0 + R);
  const double shear_g_prime1 = 16.0 / 45.0 * (tau_c * (theta_prime0 + metric_shear_prime)
                                                + dtau_c * (t_g + metric_shear));
  const double tca_slip = (1.0 - 2.0 * aH * F) * slip_1 + F * k2 * (
      2.0 * aH * s2 * shear_g_tca1 + s2 * shear_g_prime1
      - (1.0 / 3.0 - cb2) * (F * theta_prime0 + 2.0 * F_prime * theta_b));
  const double tca_shear_g = (1.0 - 11.0 / 6.0 * dtau_c) * shear_g_tca1
      - 11.0 / 6.0 * tau_c * 16.0 / 45.0 * tau_c * (theta_prime0 + metric_shear_prime);

  const double theta_b_prime_notca = kNewt
      ? -aH * theta_b + k2 * cb2 * delta_b + metric_euler + R * kap * (t_g - theta_b)
      : -aH * theta_b + k2 * cb2 * delta_b + R * kap * (t_g - theta_b);
  const double theta_b_prime_tca = kNewt
      ? (-aH * theta_b + k2 * (cb2 * delta_b + R * (d_g / 4.0 - s2 * tca_shear_g))
         + R * tca_slip) / (1.0 + R) + metric_euler
      : (-aH * theta_b + k2 * (cb2 * delta_b + R * (d_g / 4.0 - s2 * tca_shear_g))
       + R * tca_slip) / (1.0 + R);
  const double theta_b_prime = tca ? theta_b_prime_tca : theta_b_prime_notca;
  const double P0 = (G0 + G2 + 2.0 * s_l2 * shear_g) / 8.0;

  if (want_dy) {
    const bool hier_on = !(tca || rsa);
    const bool ur_on = !rsa;
    if (tid == 0) {
      // the scalar slots
      dy[L.delta_g] = rsa ? 0.0 : -4.0 / 3.0 * (t_g + metric_continuity);
      dy[L.delta_b] = -(theta_b + metric_continuity);
      dy[L.theta_b] = theta_b_prime;
      const double theta_g_prime_full = kNewt
          ? k2 * (d_g / 4.0 - s2 * shear_g) + metric_euler + kap * (theta_b - t_g)
          : k2 * (d_g / 4.0 - s2 * shear_g) + kap * (theta_b - t_g);
      const double theta_g_prime_tca = kNewt
          ? -(theta_b_prime + aH * theta_b - k2 * cb2 * delta_b) / R
            + k2 * (0.25 * d_g - s2 * tca_shear_g) + (1.0 + R) / R * metric_euler
          : -(theta_b_prime + aH * theta_b - k2 * cb2 * delta_b) / R
                                       + k2 * (0.25 * d_g - s2 * tca_shear_g);
      dy[L.theta_g] = rsa ? 0.0 : (tca ? theta_g_prime_tca : theta_g_prime_full);
      dy[L.shear_g] = hier_on ? 0.5 * (8.0 / 15.0 * (theta_g + metric_shear)
                                       - 3.0 / 5.0 * k * s_l3 / s_l2 * y[L.F_g]
                                       - kap * (2.0 * shear_g - 4.0 / 5.0 / s_l2 * P0))
                              : 0.0;
      if constexpr (kNewt) {   // cdm velocity (perturb_derivs :8238-8248)
        dy[L.delta_cdm] = -(theta_cdm + metric_continuity);
        dy[L.theta_cdm] = -aH * theta_cdm + metric_euler;
      } else {
        dy[L.delta_cdm] = -metric_continuity;
      }
      dy[L.delta_ur] = ur_on ? -4.0 / 3.0 * (theta_ur + metric_continuity) : 0.0;
      dy[L.theta_ur] = ur_on ? (kNewt ? k2 * (delta_ur / 4.0 - s2 * shear_ur) + metric_euler
                                      : k2 * (delta_ur / 4.0 - s2 * shear_ur))
                             : 0.0;
      const double d_shear_ur_full = 0.5 * (8.0 / 15.0 * (theta_ur + metric_shear)
                                            - 3.0 / 5.0 * k * s_l3 / s_l2 * y[L.F_ur]);
      const double d_shear_ur_ufa = -3.0 / tau * shear_ur
                                    + 2.0 / 3.0 * (theta_ur + metric_ufa);
      dy[L.shear_ur] = ur_on ? (ufa ? d_shear_ur_ufa : d_shear_ur_full) : 0.0;
      if constexpr (kIdm) {   // idm_dr and idr without their scattering (JAX :818-844)
        dy[L.idm] = -(theta_idm + metric_continuity);
        dy[L.idm + 1] = -aH * theta_idm + k2 * im.cidm2 * delta_idm;
        dy[L.idm + 2] = -4.0 / 3.0 * (theta_idr + metric_continuity);
        if (L.idr_fluid) {
          dy[L.idm + 3] = k2 / 4.0 * delta_idr;
          dy[L.idm + 4] = 0.0;
        } else {
          dy[L.idm + 3] = k2 * (delta_idr / 4.0 - s2 * shear_idr);
          dy[L.idm + 4] = 0.5 * (8.0 / 15.0 * (theta_idr + metric_shear)
                                 - 3.0 / 5.0 * k * s_l3 / s_l2 * y[L.idm + 5]);
        }
      }
      if constexpr (kScf) {   // Klein-Gordon (JAX equations.py:847-851)
        dy[L.phi_scf] = dphip;
        dy[L.phi_scf + 1] = -2.0 * aH * dphip - metric_continuity * phip_bg
                            - (k2 + a2 * ddV_bg) * dphi;
      }
      dy[L.eta] = eta_prime;
    }

    // photon moments l = 3..l_max_g: the couplings carry s_l, and F_2
    // enters the l = 3 equation as 2 s_2 shear_g
    const int nF = L.n_F_g;
    for (int j = tid; j < nF; j += nt) {
      double d = 0.0;
      if (hier_on) {
        const double l = 3.0 + j, cur = y[L.F_g + j];
        const double lm1 = j == 0 ? 2.0 * s_l2 * shear_g : y[L.F_g + j - 1];
        d = j < nF - 1 ? k / (2.0 * l + 1.0) * (l * sl[j + 3] * lm1
                                                - (l + 1.0) * sl[j + 4] * y[L.F_g + j + 1])
                             - kap * cur
                       : k * (sl[j + 3] * lm1 - (nF + 2 + 1.0) * cotKgen * cur) - kap * cur;
      }
      dy[L.F_g + j] = d;
    }
    // polarization l = 0..l_max_pol_g
    const int nG = L.n_G_g;
    for (int j = tid; j < nG; j += nt) {
      double d = 0.0;
      if (hier_on) {
        const double l = (double)j, cur = y[L.G_g + j];
        const double lm1 = j == 0 ? 0.0 : y[L.G_g + j - 1];
        if (j == nG - 1) {
          d = k * (sl[j] * lm1 - (nG - 1 + 1.0) * cotKgen * cur) - kap * cur;
        } else {
          const double nxt = y[L.G_g + j + 1];
          d = k / (2.0 * l + 1.0) * (l * sl[j] * lm1 - (l + 1.0) * sl[j + 1] * nxt) - kap * cur;
          if (j == 0) d = -k * nxt - kap * (cur - 4.0 * P0);
          if (j == 2) d = k / 5.0 * (2.0 * s_l2 * lm1 - 3.0 * s_l3 * nxt)
                          - kap * (cur - 4.0 / 5.0 * P0);
        }
      }
      dy[L.G_g + j] = d;
    }
    // massless neutrino moments l = 3..l_max_ur
    const int nU = L.n_F_ur;
    const bool ur_hier = ur_on && !ufa;
    for (int j = tid; j < nU; j += nt) {
      double d = 0.0;
      if (ur_hier) {
        const double l = 3.0 + j, cur = y[L.F_ur + j];
        const double lm1 = j == 0 ? 2.0 * s_l2 * shear_ur : y[L.F_ur + j - 1];
        d = j < nU - 1 ? k / (2.0 * l + 1.0) * (l * sl[j + 3] * lm1
                                                - (l + 1.0) * sl[j + 4] * y[L.F_ur + j + 1])
                       : k * (sl[j + 3] * lm1 - (nU + 2 + 1.0) * cotKgen * cur);
      }
      dy[L.F_ur + j] = d;
    }
    // idr moments l = 3..l_max_idr (free streaming; JAX equations.py:830-844)
    if constexpr (kIdm) {
      const int nI = L.n_F_idr, Fi = L.idm + 5;
      for (int j = tid; j < nI; j += nt) {
        const double l = 3.0 + j, cur = y[Fi + j];
        double d;
        if (j == nI - 1)
          d = k * (sl[j + 3] * y[Fi + j - 1] - (nI + 2 + 1.0) * cotKgen * cur);
        else if (j == 0)
          d = k / 7.0 * (6.0 * s_l3 * s_l2 * shear_idr - 4.0 * sl[4] * y[Fi + 1]);
        else
          d = k / (2.0 * l + 1.0) * (l * sl[j + 3] * y[Fi + j - 1]
                                     - (l + 1.0) * sl[j + 4] * y[Fi + j + 1]);
        dy[Fi + j] = d;
      }
    }

    // ncdm (JAX equations.py:693-729)
    for (int s = 0; s < ns; ++s) {
      const int base = L.ncdm + s * nq * nl;
      if (ncfa) {
        if (ns > 1)
          for (int i = 3 + tid; i < nq * nl; i += nt) dy[base + i] = 0.0;
        if (tid == 0) {
          const double rho_s = fr.nc[3 * s], p_s = fr.nc[3 * s + 1], pp_s = fr.nc[3 * s + 2];
          const double w_s = p_s / rho_s;
          const double d_fl = y[base], t_fl = y[base + 1], s_fl = y[base + 2];
          const double ca2 = w_s / 3.0 / (1.0 + w_s) * (5.0 - pp_s / p_s);
          const double ceff2 = ca2, cvis2 = 3.0 * w_s * ca2;
          dy[base] = -(1.0 + w_s) * (t_fl + metric_continuity) - 3.0 * aH * (ceff2 - w_s) * d_fl;
          dy[base + 1] = kNewt ? -aH * (1.0 - 3.0 * ca2) * t_fl + ceff2 / (1.0 + w_s) * k2 * d_fl
                                     - k2 * s_fl + metric_euler
                               : -aH * (1.0 - 3.0 * ca2) * t_fl + ceff2 / (1.0 + w_s) * k2 * d_fl
                         - k2 * s_fl;
          dy[base + 2] = -3.0 * (aH * (2.0 / 3.0 - ca2 - pp_s / p_s / 3.0) + 1.0 / tau) * s_fl
                         + 8.0 / 3.0 * cvis2 / (1.0 + w_s) * s_l2 * (t_fl + metric_ufa);
        }
      } else {
        const double ax = a * T.x_fac[s];
        for (int e = tid; e < nq * nl; e += nt) {
          const int iq = e / nl, l = e - iq * nl;
          const double q = T.q[iq];
          const double eps = sqrt(q * q + ax * ax);
          const double qk_eps = k * q / eps;
          const double dl0 = T.dlnf0[s * nq + iq];
          const int o = base + iq * nl;
          const double cur = y[o + l], lm1 = l == 0 ? 0.0 : y[o + l - 1];
          double d;
          if (l == nl - 1) {
            d = qk_eps * lm1 - (1.0 + (nl - 1.0)) * k * cotKgen * cur;
          } else {
            const double nxt = y[o + l + 1];
            if (l == 0) d = -qk_eps * nxt + metric_continuity * dl0 / 3.0;
            else if (l == 1) d = kNewt ? qk_eps / 3.0 * (lm1 - 2.0 * s_l2 * nxt)
                                             - eps * metric_euler / (3.0 * q * k) * dl0
                                       : qk_eps / 3.0 * (lm1 - 2.0 * s_l2 * nxt);
            else if (l == 2) d = qk_eps / 5.0 * (2.0 * s_l2 * lm1 - 3.0 * s_l3 * nxt)
                                 - s_l2 * metric_shear * 2.0 / 15.0 * dl0;
            else d = qk_eps / (2.0 * l + 1.0) * (l * sl[l] * lm1 - (l + 1.0) * sl[l + 1] * nxt);
          }
          dy[o + l] = d;
        }
      }
    }
    team_sync(tm);
  }

  // gauge-invariant matter variables and the rest of the locals
  const double rho_m_cb = rho_b + rho_cdm;
  const double rho_theta_cb = kNewt ? rho_b * theta_b + rho_cdm * theta_cdm : rho_b * theta_b;
  const double theta_cb_gauge = rho_theta_cb / rho_m_cb;
  const double delta_cb = (rho_b * delta_b + rho_cdm * delta_cdm) / rho_m_cb
                          + 3.0 * aH * theta_cb_gauge / k2;
  const double theta_cb = theta_cb_gauge + k2 * alpha;
  if constexpr (kIdm) {
    // the matter sums with idm_dr after the ncdm species (JAX :880-899)
    double rho_m = rho_m_cb, rpp_m = rho_m_cb;
    double delta_rho_m = rho_b * delta_b + rho_cdm * delta_cdm, rpt_m = rho_theta_cb;
    loc.delta_nc = 0.0;
    loc.theta_nc = 0.0;
    if (ns) {
      rho_m = rho_m + sum_rho_nc;
      rpp_m = rpp_m + sum_rpp_nc;
      delta_rho_m = delta_rho_m + sum_rho_delta;
      rpt_m = rpt_m + sum_rpt;
      loc.delta_nc = sum_rho_delta / sum_rho_nc;
      loc.theta_nc = sum_rpt / sum_rpp_nc;
    }
    rho_m = rho_m + im.rho_idm;
    rpp_m = rpp_m + im.rho_idm;
    delta_rho_m = delta_rho_m + im.rho_idm * delta_idm;
    rpt_m = rpt_m + im.rho_idm * theta_idm;
    const double theta_m_gauge = rpt_m / rpp_m;
    loc.delta_m = delta_rho_m / rho_m + 3.0 * aH * theta_m_gauge / k2;
    loc.theta_m = theta_m_gauge + k2 * alpha;
  } else if (ns) {
    const double rho_m = rho_m_cb + sum_rho_nc, rpp_m = rho_m_cb + sum_rpp_nc;
    const double delta_rho_m = rho_b * delta_b + rho_cdm * delta_cdm + sum_rho_delta;
    const double theta_m_gauge = (rho_theta_cb + sum_rpt) / rpp_m;
    loc.delta_m = delta_rho_m / rho_m + 3.0 * aH * theta_m_gauge / k2;
    loc.theta_m = theta_m_gauge + k2 * alpha;
    loc.delta_nc = sum_rho_delta / sum_rho_nc;
    loc.theta_nc = sum_rpt / sum_rpp_nc;
  } else {
    loc.delta_m = delta_cb;
    loc.theta_m = theta_cb;
    loc.delta_nc = 0.0;
    loc.theta_nc = 0.0;
  }
  loc.delta_cb = delta_cb;
  loc.theta_cb = theta_cb;
  loc.P = rsa ? 0.0 : (tca ? 5.0 * s_l2 * tca_shear_g / 8.0 : P0);
  const double rpp_tot = fr.rho_tot + fr.p_tot;
  loc.aH = aH; loc.aH_prime = aH_prime; loc.h_prime = h_prime; loc.eta_prime = eta_prime;
  loc.alpha = alpha; loc.alpha_prime = alpha_prime; loc.theta_b_prime = theta_b_prime;
  loc.eta = eta;
  loc.phi = phi;
  loc.psi = psi;
  loc.phi_plus_psi = phi_plus_psi;
  loc.phi_prime = phi_prime;
  loc.delta_g_eff = d_g; loc.theta_g_eff = t_g;
  loc.delta_ur_eff = rsa ? rsa_delta_ur : delta_ur;
  loc.theta_ur_eff = rsa ? rsa_theta_ur : theta_ur;
  if constexpr (kIdm)
    loc.delta_tot = delta_rho / (rho_g + rho_b + rho_cdm + rho_ur + sum_rho_nc + im.rho_idm
                                 + im.rho_idr);
  else if constexpr (kScf)
    loc.delta_tot = delta_rho / (rho_g + rho_b + rho_cdm + rho_ur + sum_rho_nc + fr.scf[0]);
  else
    loc.delta_tot = delta_rho / (rho_g + rho_b + rho_cdm + rho_ur + sum_rho_nc);
  loc.theta_tot = rho_plus_p_theta / rpp_tot;
  loc.H_T_Nb_prime = 3.0 * aH / rpp_tot * (
      -delta_p + fr.p_tot_prime * rho_plus_p_theta / (rpp_tot * k2) + rho_plus_p_shear);
}

// --- stiff (Thomson) split: J_s y over the stiff range [0, theta_b]; sl2 is
// the lane's s_2. Ends with team_sync().
PK_FN void stiff_apply(const Layout& L, const Team& tm, const Frame& fr, const Flags& fl,
                       double sl2, const Vec y, const Vec out) {
  const double kap = (fl.tca || fl.rsa) ? 0.0 : fr.kap;
  const double R = 4.0 / 3.0 * fr.rho_g / fr.rho_b;
  const double theta_g = y[L.theta_g], theta_b = y[L.theta_b], shear_g = y[L.shear_g];
  const double P0 = (y[L.G_g] + y[L.G_g + 2] + 2.0 * sl2 * shear_g) / 8.0;
  if (tm.tid == 0) {
    out[L.delta_g] = 0.0;
    out[L.delta_b] = 0.0;
    out[L.theta_g] = kap * (theta_b - theta_g);
    out[L.theta_b] = R * kap * (theta_g - theta_b);
    out[L.shear_g] = kap * (0.4 / sl2 * P0 - shear_g);
  }
  for (int i = L.F_g + tm.tid; i < L.G_g + L.n_G_g; i += tm.nt) {
    double v = -kap * y[i];
    if (i == L.G_g) v += kap * 4.0 * P0;
    if (i == L.G_g + 2) v += kap * 0.8 * P0;
    out[i] = v;
  }
  team_sync(tm);
}

// x = (I - gh J_s)^-1 r in closed form, in place on r: the Sherman-Morrison
// 3x3 block has u = (0.05/s_2, 0.5, 0.1), v = (2 s_2, 1, 1). Ends with
// team_sync().
PK_FN void stiff_solve(const Layout& L, const Team& tm, const Frame& fr, const Flags& fl,
                       double sl2, double gh, const Vec r) {
  const double kap = (fl.tca || fl.rsa) ? 0.0 : fr.kap;
  const double R = 4.0 / 3.0 * fr.rho_g / fr.rho_b;
  const double a = gh * kap;
  const double r_sh = r[L.shear_g], r_G0 = r[L.G_g], r_G2 = r[L.G_g + 2];
  const double r_g = r[L.theta_g], r_b = r[L.theta_b];
  team_sync(tm);   // every thread has read before any writes
  const double vr = 2.0 * sl2 * r_sh + r_G0 + r_G2;
  const double den = (1.0 + a) * (1.0 + (1.0 - 0.7) * a);
  for (int i = L.F_g + tm.tid; i < L.G_g + L.n_G_g; i += tm.nt) {
    double v = r[i] / (1.0 + a);
    if (i == L.G_g) v = r_G0 / (1.0 + a) + a * 0.5 * vr / den;
    if (i == L.G_g + 2) v = r_G2 / (1.0 + a) + a * 0.1 * vr / den;
    r[i] = v;
  }
  if (tm.tid == 0) {
    r[L.shear_g] = r_sh / (1.0 + a) + a * (0.05 / sl2) * vr / den;
    const double det = 1.0 + a * (1.0 + R);
    r[L.theta_g] = ((1.0 + a * R) * r_g + a * r_b) / det;
    r[L.theta_b] = (a * R * r_g + (1.0 + a) * r_b) / det;
  }
  team_sync(tm);
}

// The idm-idr part of the stiff split (equations.py stiff_apply, the idm
// block), after stiff_apply in the idm instance: J zero from theta_b to the
// idm block, the momentum exchange S^-1 dmu (theta_idr - theta_idm), dmu
// (theta_idm - theta_idr) and the idr damping -(alpha_l dmu + beta_l dmu_idr)
// on shear_idr and F_idr, none of it masked under TCA or RSA. Ends with
// team_sync().
PK_FN void stiff_apply_idm(const LayoutIdm& L, const TablesIdm& T, const Team& tm,
                           const Frame& fr, const Vec y, const Vec out) {
  const Idm im = idm_at(T, fr);
  const double dmu = im.dmu_idm, Sinv = 4.0 * im.rho_idr / (3.0 * im.rho_idm);
  const double th_idm = y[L.idm + 1], th_idr = y[L.idm + 3];
  for (int i = L.theta_b + 1 + tm.tid; i < L.idm; i += tm.nt) out[i] = 0.0;
  if (tm.tid == 0) {
    out[L.idm] = 0.0;
    out[L.idm + 1] = Sinv * dmu * (th_idr - th_idm);
    out[L.idm + 2] = 0.0;
    out[L.idm + 3] = dmu * (th_idm - th_idr);
    if (L.idr_fluid) out[L.idm + 4] = 0.0;
  }
  if (!L.idr_fluid)
    for (int j = tm.tid; j < 1 + L.n_F_idr; j += tm.nt) {
      const double damp = T.idr_alpha[j] * dmu + T.idr_beta[j] * im.dmu_idr;
      out[L.idm + 4 + j] = -damp * y[L.idm + 4 + j];
    }
  team_sync(tm);
}

// Its solve, in place on r after stiff_solve: the 2x2 {theta_idr, theta_idm}
// block, det = 1 + b (1 + S^-1) with b = gh dmu, and the idr damping's
// diagonal; the gap before the block is the identity. Ends with team_sync().
PK_FN void stiff_solve_idm(const LayoutIdm& L, const TablesIdm& T, const Team& tm,
                           const Frame& fr, double gh, const Vec r) {
  const Idm im = idm_at(T, fr);
  const double dmu = im.dmu_idm, Sinv = 4.0 * im.rho_idr / (3.0 * im.rho_idm);
  const double b = gh * dmu;
  if (tm.tid == 0) {
    const double r_r = r[L.idm + 3], r_m = r[L.idm + 1];
    const double det_i = 1.0 + b * (1.0 + Sinv);
    r[L.idm + 3] = ((1.0 + b * Sinv) * r_r + b * r_m) / det_i;
    r[L.idm + 1] = (b * Sinv * r_r + (1.0 + b) * r_m) / det_i;
  }
  if (!L.idr_fluid)
    for (int j = tm.tid; j < 1 + L.n_F_idr; j += tm.nt) {
      const double ad = gh * (T.idr_alpha[j] * dmu + T.idr_beta[j] * im.dmu_idr);
      r[L.idm + 4 + j] = r[L.idm + 4 + j] / (1.0 + ad);
    }
  team_sync(tm);
}

// Adiabatic initial state at fr.tau (equations.py adiabatic_ic), and in the
// Newtonian gauge its transform (equations.py ic_to_newtonian): alpha from the
// first two Einstein equations, every species shifted by it, theta_cdm =
// k^2 alpha, phi in the eta slot, and the ncdm Psi_0, Psi_1 seeded from the
// shifted ur variables. Ends with team_sync().
template <bool kNewt, bool kIdm = false>
PK_FN void adiabatic_ic(const LayoutOf<kIdm>& L, const TablesOf<kIdm>& T, const Team& tm,
                        const Frame& fr, const Lane& ln, const Vec y) {
  const double k = ln.k, tau = fr.tau, ci = 1.0, s2 = 1.0 - 3.0 * ln.K / (k * k);
  // with idm_dr, idm as matter and idr as free-streaming radiation (JAX
  // :1125-1130); the instances without it keep their expressions
  Idm im{};
  if constexpr (kIdm) im = idm_at(T, fr);
  const double rho_r = kIdm ? fr.rho_g + fr.rho_ur + im.rho_idr : fr.rho_g + fr.rho_ur;
  const double rho_m = kIdm ? fr.rho_b + fr.rho_cdm + im.rho_idm : fr.rho_b + fr.rho_cdm;
  const double fracnu = kIdm ? (fr.rho_ur + im.rho_idr) / rho_r : fr.rho_ur / rho_r;
  const double fracb = fr.rho_b / rho_m;
  const double om = fr.a * rho_m / sqrt(rho_r);
  const double kt = k * tau, ktau2 = kt * kt, ktau3 = kt * kt * kt;
  const double delta_g = -ktau2 / 3.0 * (1.0 - om * tau / 5.0) * ci * s2;
  const double theta_g = -k * ktau3 / 36.0 * (1.0 - 3.0 * (1.0 + 5.0 * fracb - fracnu)
                                              / 20.0 / (1.0 - fracnu) * om * tau) * ci * s2;
  const double theta_ur = -k * ktau3 / 36.0 / (4.0 * fracnu + 15.0) * (
      4.0 * fracnu + 11.0 + 12.0 * s2
      - 3.0 * (8.0 * fracnu * fracnu + 50.0 * fracnu + 275.0) / 20.0
      / (2.0 * fracnu + 15.0) * tau * om) * ci * s2;
  const double shear_ur = ktau2 / (45.0 + 12.0 * fracnu) * (3.0 * s2 - 1.0) * (
      1.0 + (4.0 * fracnu - 5.0) / 4.0 / (2.0 * fracnu + 15.0) * tau * om) * ci;
  const double l3_ur = ktau3 * 2.0 / 7.0 / (12.0 * fracnu + 45.0) * ci;
  double eta_hat = -ci * ktau2 / 12.0 / (15.0 + 4.0 * fracnu) * (
      5.0 + 4.0 * s2 * fracnu
      - (16.0 * fracnu * fracnu + 280.0 * fracnu + 325.0) / 10.0 / (2.0 * fracnu + 15.0) * tau * om);
  eta_hat = eta_hat + (ci - ln.eta_off);
  for (int i = tm.tid; i < L.n; i += tm.nt) y[i] = 0.0;
  team_sync(tm);
  // the ur density and velocity the ncdm Psi_0, Psi_1 are seeded from
  double nc_delta = delta_g, nc_theta = theta_ur;
  if constexpr (kNewt) {
    const double k2 = k * k, aH = fr.a * fr.H;
    double rho_ur = fr.rho_ur;
    for (int s = 0; s < L.ns; ++s) rho_ur += fr.nc[3 * s];   // still relativistic here
    const double rho_rn = fr.rho_g + rho_ur;
    const double fracg = fr.rho_g / rho_rn, fracn = rho_ur / rho_rn, fraccdm = 1.0 - fracb;
    const double rmr = rho_m / rho_rn;
    const double delta_tot = (fracg * delta_g + fracn * delta_g
                              + rmr * (fracb * (0.75 * delta_g) + fraccdm * (0.75 * delta_g)))
                             / (1.0 + rmr);
    const double velocity_tot = (4.0 / 3.0 * (fracg * theta_g + fracn * theta_ur)
                                 + rmr * fracb * theta_g) / (1.0 + rmr);
    const double eta = eta_hat + ln.eta_off;
    const double alpha = (eta + 1.5 * aH * aH / (k2 * s2)
                          * (delta_tot + 3.0 * aH / k2 * velocity_tot)) / aH;
    nc_delta = delta_g + -4.0 * aH * alpha;
    nc_theta = theta_ur + k2 * alpha;
    if (tm.tid == 0) {
      y[L.delta_g] = nc_delta;
      y[L.theta_g] = theta_g + k2 * alpha;
      y[L.delta_b] = 0.75 * delta_g + -3.0 * aH * alpha;
      y[L.theta_b] = theta_g + k2 * alpha;
      y[L.delta_cdm] = 0.75 * delta_g + -3.0 * aH * alpha;
      y[L.theta_cdm] = k2 * alpha;
      y[L.delta_ur] = nc_delta;
      y[L.theta_ur] = nc_theta;
      y[L.shear_ur] = shear_ur;
      y[L.F_ur] = l3_ur;
      y[L.eta] = eta - aH * alpha;
    }
  } else if (tm.tid == 0) {
    y[L.delta_g] = delta_g;
    y[L.theta_g] = theta_g;
    y[L.delta_b] = 0.75 * delta_g;
    y[L.theta_b] = theta_g;
    y[L.delta_cdm] = 0.75 * delta_g;
    if constexpr (kIdm) {   // (JAX equations.py:1169-1177)
      y[L.idm] = 0.75 * delta_g;
      y[L.idm + 1] = theta_ur;
      y[L.idm + 2] = delta_g;
      y[L.idm + 3] = theta_ur;
      if (!L.idr_fluid) {
        y[L.idm + 4] = shear_ur;
        y[L.idm + 5] = l3_ur;
      }
    }
    y[L.delta_ur] = delta_g;
    y[L.theta_ur] = theta_ur;
    y[L.shear_ur] = shear_ur;
    y[L.F_ur] = l3_ur;
    y[L.eta] = eta_hat;
  }
  // relativistic ncdm: Psi_l = (ur multipole) x coefficient x dlnf0/dlnq
  for (int e = tm.tid; e < L.ns * L.nq; e += tm.nt) {
    const int s = e / L.nq, iq = e - s * L.nq;
    const double ax = fr.a * T.x_fac[s];
    const double q = T.q[iq], eps = sqrt(q * q + ax * ax);
    const double dl0 = T.dlnf0[s * L.nq + iq];
    const int o = L.ncdm + (s * L.nq + iq) * L.nl;
    y[o] = -0.25 * nc_delta * dl0;
    y[o + 1] = -eps / (3.0 * q * k) * nc_theta * dl0;
    y[o + 2] = -0.5 * shear_ur * dl0;
    y[o + 3] = -0.25 * l3_ur * dl0;
  }
  team_sync(tm);
}

// Isocurvature initial state of kind ln.ic (bi, cdi, nid, niv) at fr.tau,
// flat, with entropy amplitude 1 (equations.py isocurvature_ic), and in the
// Newtonian gauge the generic transform of that synchronous state
// (equations.py ic_to_newtonian: alpha from the first two Einstein
// equations, every species shifted by it, theta_cdm = k^2 alpha, phi in the
// eta slot). The ncdm species count as relativistic; each Psi_0, Psi_1 is
// seeded from the (shifted) ur density and velocity, Psi_2 from the ur
// shear. Every thread computes the scalars; thread 0 writes them. Ends with
// team_sync().
template <bool kNewt>
PK_FN void isocurvature_ic(const Layout& L, const Tables& T, const Team& tm, const Frame& fr,
                           const Lane& ln, const Vec y) {
  const double k = ln.k, tau = fr.tau, e = 1.0;
  double rho_ur = fr.rho_ur;
  for (int s = 0; s < L.ns; ++s) rho_ur = rho_ur + fr.nc[3 * s];
  const double rho_r = fr.rho_g + rho_ur, rho_m = fr.rho_b + fr.rho_cdm;
  const double fracnu = rho_ur / rho_r, fracg = fr.rho_g / rho_r, fracb = fr.rho_b / rho_m;
  const double fraccdm = 1.0 - fracb;
  const double om = fr.a * rho_m / sqrt(rho_r);
  const double kt = k * tau, kt2 = kt * kt;
  double dg, tg, db, tb, dc, dur, tur, sur, eta;
  if (ln.ic == kIcCdi || ln.ic == kIcBi) {
    const double frac = ln.ic == kIcCdi ? fraccdm : fracb;
    dg = e * frac * om * tau * (-2.0 / 3.0 + om * tau / 4.0);
    tg = -e * frac * om * kt2 / 12.0;
    db = ln.ic == kIcCdi ? 0.75 * dg : e + 0.75 * dg;
    tb = tg;
    dc = ln.ic == kIcCdi ? e + 0.75 * dg : 0.75 * dg;
    dur = dg;
    tur = tg;
    sur = -e * frac * kt2 * tau * om / 6.0 / (2.0 * fracnu + 15.0);
    eta = -e * frac * om * tau * (1.0 / 6.0 - om * tau / 16.0);
  } else if (ln.ic == kIcNid) {
    dg = e * fracnu / fracg * (-1.0 + kt2 / 6.0);
    tg = -e * fracnu / fracg * k * k * tau * (0.25 - fracb / fracg * 3.0 / 16.0 * om * tau);
    db = e * fracnu / fracg / 8.0 * kt2;
    tb = tg;
    dc = -e * fracnu * fracb / fracg / 80.0 * kt2 * om * tau;
    dur = e * (1.0 - kt2 / 6.0);
    tur = e * k * k * tau / 4.0;
    sur = e * kt2 / (4.0 * fracnu + 15.0) / 2.0;
    eta = -e * fracnu / (4.0 * fracnu + 15.0) / 6.0 * kt2;
  } else {   // kIcNiv
    dg = e * kt * fracnu / fracg * (1.0 - 3.0 / 16.0 * fracb * (2.0 + fracg) / fracg * om * tau);
    tg = e * fracnu / fracg * 0.75 * k * (
        -1.0 + 0.75 * fracb / fracg * om * tau
        + 3.0 / 16.0 * om * om * tau * tau * fracb / fracg / fracg * (fracg - 3.0 * fracb)
        + kt2 / 6.0);
    db = 0.75 * dg;
    tb = tg;
    dc = -e * 9.0 / 64.0 * fracnu * fracb / fracg * kt * om * tau;
    dur = -e * kt * (1.0 + 3.0 / 16.0 * fracb * fracnu / fracg * om * tau);
    tur = e * 0.75 * k * (1.0 - kt2 / 6.0 * (4.0 * fracnu + 9.0) / (4.0 * fracnu + 5.0));
    sur = e / (4.0 * fracnu + 15.0) * kt * (1.0 + 3.0 * om * tau * fracnu / (4.0 * fracnu + 15.0));
    eta = e * fracnu * kt * (-1.0 / (4.0 * fracnu + 5.0)
                             + (-3.0 / 64.0 * fracb / fracg
                                + 15.0 / 4.0 / (4.0 * fracnu + 15.0) / (4.0 * fracnu + 5.0)
                                * om * tau));
  }
  double theta_cdm = 0.0;
  if constexpr (kNewt) {
    const double k2 = k * k, aH = fr.a * fr.H, rmr = rho_m / rho_r;
    const double s2 = 1.0 - 3.0 * ln.K / k2;
    const double delta_tot = (fracg * dg + fracnu * dur + rmr * (fracb * db + fraccdm * dc))
                             / (1.0 + rmr);
    const double velocity_tot = (4.0 / 3.0 * (fracg * tg + fracnu * tur) + rmr * fracb * tb)
                                / (1.0 + rmr);
    const double alpha = (eta + 1.5 * aH * aH / (k2 * s2)
                          * (delta_tot + 3.0 * aH / k2 * velocity_tot)) / aH;
    eta = eta - aH * alpha;
    dg = dg + -4.0 * aH * alpha;
    tg = tg + k2 * alpha;
    db = db + -3.0 * aH * alpha;
    tb = tb + k2 * alpha;
    dc = dc + -3.0 * aH * alpha;
    theta_cdm = k2 * alpha;
    dur = dur + -4.0 * aH * alpha;
    tur = tur + k2 * alpha;
  }
  for (int i = tm.tid; i < L.n; i += tm.nt) y[i] = 0.0;
  team_sync(tm);
  if (tm.tid == 0) {
    y[L.delta_g] = dg;
    y[L.theta_g] = tg;
    y[L.delta_b] = db;
    y[L.theta_b] = tb;
    y[L.delta_cdm] = dc;
    if constexpr (kNewt) y[L.theta_cdm] = theta_cdm;
    y[L.delta_ur] = dur;
    y[L.theta_ur] = tur;
    y[L.shear_ur] = sur;
    y[L.eta] = eta;
  }
  for (int e2 = tm.tid; e2 < L.ns * L.nq; e2 += tm.nt) {
    const int s = e2 / L.nq, iq = e2 - s * L.nq;
    const double ax = fr.a * T.x_fac[s];
    const double q = T.q[iq], eps = sqrt(q * q + ax * ax);
    const double dl0 = T.dlnf0[s * L.nq + iq];
    const int o = L.ncdm + (s * L.nq + iq) * L.nl;
    y[o] = -0.25 * dur * dl0;
    y[o + 1] = -eps / (3.0 * q * k) * tur * dl0;
    y[o + 2] = -0.5 * sur * dl0;
  }
  team_sync(tm);
}

// Photon hierarchy from its tight-coupling values (remap_tca_off). `fl` are
// the flags at the switch time; the shear is evaluated with tca forced on.
// Ends with team_sync().
template <bool kNewt, bool kScf, bool kIdm = false>
PK_FN void remap_tca_off(const LayoutOf<kIdm>& L, const TablesOf<kIdm>& T, const Team& tm,
                         const Frame& fr, const Lane& ln, Flags fl, const Vec y) {
  Locals loc;
  fl.tca = true;
  rhs_full<kNewt, kScf, kIdm>(L, T, tm, fr, ln, fl, y, y, false, loc);
  team_sync(tm);   // every thread has read y
  if (tm.tid == 0) {
    const double kk = ln.k / fr.kap, s_l2 = ln.sl[2], s_l3 = ln.sl[3];
    const double shear_g = 8.0 / 5.0 * loc.P / s_l2;   // P = 5 s_2 shear_g / 8 under TCA
    y[L.shear_g] = shear_g;
    y[L.F_g] = 6.0 / 7.0 * kk * s_l3 * shear_g;
    y[L.G_g] = 2.5 * shear_g;
    y[L.G_g + 1] = kk * (5.0 - 2.0 * s_l2) / 6.0 * shear_g;
    y[L.G_g + 2] = 0.5 * shear_g;
    y[L.G_g + 3] = kk * 3.0 * s_l3 / 14.0 * shear_g;
  }
  team_sync(tm);
}

PK_FN void remap_ufa_on(const Layout& L, const Team& tm, const Vec y) {
  for (int j = tm.tid; j < L.n_F_ur; j += tm.nt) y[L.F_ur + j] = 0.0;
  team_sync(tm);
}

PK_FN void remap_rsa_on(const Layout& L, const Team& tm, const Vec y) {
  for (int i = L.delta_g + tm.tid; i < L.G_g + L.n_G_g; i += tm.nt) y[i] = 0.0;
  for (int i = L.delta_ur + tm.tid; i < L.F_ur + L.n_F_ur; i += tm.nt) y[i] = 0.0;
  team_sync(tm);
}

// Collapse each ncdm block to its fluid moments (remap_ncdmfa_on). Ends with
// team_sync().
PK_FN void remap_ncdmfa_on(const Layout& L, const Tables& T, const Team& tm, const Frame& fr,
                           const Lane& ln, const Vec y) {
  const double a2 = fr.a * fr.a;
  for (int s = 0; s < L.ns; ++s) {
    const int base = L.ncdm + s * L.nq * L.nl;
    const double fac = T.pref[s] / (a2 * a2);
    double sm[4];
    ncdm_sums(L, T, tm, fr.a, s, y, sm);
    team_sync(tm);   // every thread has read the block
    for (int i = tm.tid; i < L.nq * L.nl; i += tm.nt) y[base + i] = 0.0;
    team_sync(tm);
    if (tm.tid == 0) {
      const double rho_s = fr.nc[3 * s], rpp = fr.nc[3 * s] + fr.nc[3 * s + 1];
      y[base] = fac * sm[0] / rho_s;
      y[base + 1] = ln.k * fac * sm[1] / rpp;
      y[base + 2] = 2.0 / 3.0 * fac * sm[2] / rpp;
    }
    team_sync(tm);
  }
}

// The 27 source columns at (k, fr.tau) (compute_sources), SrcIdx order, in
// the efficient form of the gauge, written by thread 0 to `out` (which no
// thread of the team reads).
template <bool kNewt, bool kScf, bool kIdm = false>
PK_FN void compute_sources(const LayoutOf<kIdm>& L, const TablesOf<kIdm>& T, const Team& tm,
                           const Frame& fr, const Lane& ln, const Flags& fl, const Vec y,
                           double* out) {
  Locals c;
  rhs_full<kNewt, kScf, kIdm>(L, T, tm, fr, ln, fl, y, y, false, c);
  if (tm.tid != 0) return;
  const double k = ln.k, k2 = k * k;
  const double g = fr.g, dg = fr.dg, emk = fr.emk;
  const double aH = c.aH, al = c.alpha, alp = c.alpha_prime;
  const double theta_b = y[L.theta_b];
  if constexpr (kNewt) {
    out[0] = g * (c.delta_g_eff / 4.0 + c.psi)
             + (g * (c.phi - c.psi) + emk * 2.0 * c.phi_prime)
             + (g * c.theta_b_prime + dg * theta_b) / k2;
    out[1] = emk * k * (c.psi - c.phi);
  } else {
    out[0] = g * (c.delta_g_eff / 4.0 + alp)
             + (g * (c.eta - alp - 2.0 * aH * al)
                + emk * 2.0 * (c.eta_prime - c.aH_prime * al - aH * alp))
             + (g * (c.theta_b_prime / k2 + alp) + dg * (theta_b / k2 + al));
    out[1] = emk * k * (alp + 2.0 * aH * al - c.eta);
  }
  out[2] = g * c.P;
  out[3] = sqrt(6.0) * g * c.P;
  out[4] = c.phi; out[5] = c.psi; out[6] = c.phi_plus_psi; out[7] = c.phi_prime;
  out[8] = c.delta_m; out[9] = c.theta_m; out[10] = c.delta_cb; out[11] = c.theta_cb;
  out[12] = c.h_prime; out[13] = c.eta;
  out[14] = c.delta_g_eff; out[15] = c.theta_g_eff;
  out[16] = y[L.delta_b]; out[17] = theta_b;
  out[18] = y[L.delta_cdm]; out[19] = kNewt ? y[L.theta_cdm] : 0.0;
  out[20] = c.delta_ur_eff; out[21] = c.theta_ur_eff;
  out[22] = c.delta_nc; out[23] = c.theta_nc;
  out[24] = c.delta_tot; out[25] = c.H_T_Nb_prime; out[26] = c.theta_tot;
}

// Scratch of one lane, in doubles: y, Y, ynew (n each), FE (6 n), FI (6 nst),
// E (nst), with nst = n_stiff the stiff range, the frame buffer and the s_l
// table (the layout's instance).
PK_HOST_FN long work_doubles(const Layout& L) {
  return 9L * L.n + 7L * (L.theta_b + 1) + frame_cols(L) + sl_count(L);
}
PK_HOST_FN long work_doubles(const LayoutIdm& L) {
  return 9L * L.n + 7L * n_stiff<true>(L) + frame_cols(L) + sl_count(L);
}

// Integrate one lane from tau_ini through every sample (solve.py `_step`
// until the lane's last sample), writing its source rows to S (ntau, 27).
// rtol/atol: this lane's per-component tolerances; work: the lane's scratch,
// shared by the team (ln.sl is set to its s_l table). Every thread returns the
// same status word and step count.
template <bool kNewt, bool kScf, bool kIdm = false>
PK_FN int integrate_lane(const LayoutOf<kIdm>& L, const TablesOf<kIdm>& T, const Team& tm, Lane ln,
                         double tau_ini, const double* taus, int ntau, const double* rtol,
                         const double* atol, long max_steps, const Vec work, double* S,
                         long long* nsteps_out, long long* prof_out = nullptr) {
  const int tid = tm.tid, nt = tm.nt;
  const int n = L.n, nst = n_stiff<kIdm>(L), ns = L.ns;
  const Vec y = work, Y = work + n, ynew = work + 2L * n, FE = work + 3L * n;
  const Vec FI = work + 9L * n, E = work + 9L * n + 6L * nst, fbuf = E + nst;
  const Vec sl = fbuf + frame_cols_of_instance<kScf, kIdm>(L);
  const double sw[4] = {ln.t_tca, ln.t_ufa, ln.t_rsa, ln.t_ncfa};
  const int nsw = ns ? 4 : 3;
  const double inf = INFINITY;

  // s_l of this lane, once: the max(., 0) clamp keeps the closed k_min lanes
  // (where 1 - K (l^2 - 1)/k^2 < 0 for large l) real
  const double k2 = ln.k * ln.k;
  for (int l = tid; l < sl_count(L); l += nt)
    sl[l] = ln.sgnK == 0 ? 1.0 : sqrt(fmax(1.0 - ln.K * ((double)l * l - 1.0) / k2, 0.0));
  team_sync(tm);
  ln.sl = sl;
  const double sl2 = sl[2];

  Frame fr;
  double t = tau_ini, h = 0.1 * tau_ini;
  frame_of<kIdm>(T, tm, t, fbuf, fr);
  if (ln.ic == kIcAd)
    adiabatic_ic<kNewt, kIdm>(L, T, tm, fr, ln, y);
  else
    isocurvature_ic<kNewt>(L, T, tm, fr, ln, y);

  int j = 0, bad_in_a_row = 0, status = kOk;
  long long nsteps = 0;
  PK_PROF_BEGIN
  while (j < ntau) {
    if (nsteps >= max_steps) { status = kTooManySteps; break; }
    const double t_b = taus[j];
    double t_stop = t_b;
    for (int s = 0; s < nsw; ++s)
      if (sw[s] > t * (1.0 + 1e-14) && sw[s] < t_stop) t_stop = sw[s];
    const double h_eff = fmin(h, t_stop - t);
    const Flags fl = flags_at(ln, t);
    const double gh = kGamma * h_eff;
    // with one species in its fluid phase the ncdm block beyond the three
    // fluid slots is identically zero: the live components are [0, na) and
    // [na + gap, n), m of them
    const bool skip = fl.ncfa && ns == 1;
    const int na = skip ? L.ncdm + 3 : n, gap = skip ? L.nq * L.nl - 3 : 0, m = n - gap;

    // --- six stages (ops/ode.py ark_step)
    for (int i = 0; i < kStages; ++i) {
      frame_of<kIdm>(T, tm, t + kC[i] * h_eff, fbuf, fr);
      PK_PROF(0)
      const Vec fe = FE + (long)i * n, fi = FI + (long)i * nst;
      if (i > 0) {
        for (int ci = tid; ci < m; ci += nt) {
          const int c = ci < na ? ci : ci + gap;
          double acc = 0.0;
          for (int mm = 0; mm < i; ++mm) acc += kAE[i][mm] * FE[mm * n + c];
          if (c < nst)
            for (int mm = 0; mm < i; ++mm)
              if (kAI[i][mm] != 0.0) acc += kAI[i][mm] * FI[mm * nst + c];
          Y[c] = y[c] + h_eff * acc;
        }
        team_sync(tm);
        PK_PROF(1)
        stiff_solve(L, tm, fr, fl, sl2, gh, Y);
        if constexpr (kIdm) stiff_solve_idm(L, T, tm, fr, gh, Y);
        PK_PROF(2)
      }
      const Vec Ys = i == 0 ? y : Y;
      Locals unused;
      stiff_apply(L, tm, fr, fl, sl2, Ys, fi);
      if constexpr (kIdm) stiff_apply_idm(L, T, tm, fr, Ys, fi);
      PK_PROF(3)
      rhs_full<kNewt, kScf, kIdm>(L, T, tm, fr, ln, fl, Ys, fe, true, unused);
      PK_PROF(4)
      for (int c = tid; c < nst; c += nt) fe[c] -= fi[c];
      team_sync(tm);
      PK_PROF(5)
    }

    // --- solution, embedded error through (I - gh J)^-1, error ratio
    double ratio = 0.0, bad = 0.0;
    for (int pass = 0; pass < 2; ++pass) {
      // pass 0: combine; the stiff range of the error goes through E
      // pass 1: ratio over the stiff range after the solve
      const int cnt = pass == 0 ? m : nst;
      for (int ci = tid; ci < cnt; ci += nt) {
        const int c = ci < na ? ci : ci + gap;
        double err;
        if (pass == 0) {
          double sb = 0.0, se = 0.0;
          for (int mm = 0; mm < kStages; ++mm) {
            if (kB[mm] == 0.0) continue;
            const double f = FE[mm * n + c] + (c < nst ? FI[mm * nst + c] : 0.0);
            sb += kB[mm] * f;
            se += (kB[mm] - kBH[mm]) * f;
          }
          ynew[c] = y[c] + h_eff * sb;
          err = h_eff * se;
          if (c < nst) { E[c] = err; continue; }
        } else {
          err = E[c];
        }
        const double k1 = FE[c] + (c < nst ? FI[c] : 0.0);
        const double scale = rtol[c] * (fabs(y[c]) + fabs(h_eff * k1) + 1e-30) + atol[c];
        const double r = fabs(err) / scale;
        if (!(r <= inf) || r == inf) bad = 1.0;
        else if (r > ratio) ratio = r;
      }
      if (pass == 0) {
        team_sync(tm);
        stiff_solve(L, tm, fr, fl, sl2, gh, E);
        if constexpr (kIdm) stiff_solve_idm(L, T, tm, fr, gh, E);
      }
    }
    ratio = team_max(tm, ratio);
    bad = team_max(tm, bad);
    if (bad > 0.0) ratio = inf;
    PK_PROF(6)

    const bool accept = ratio <= 1.0;
    double fac = 0.9 * (ratio > 0.0 ? pow(ratio, -0.25) : 5.0);
    fac = fac < 0.2 ? 0.2 : (fac > 5.0 ? 5.0 : fac);
    const double h_next = (accept && h_eff < h) ? fmax(h, h_eff * fac) : h_eff * fac;
    const double t_new = accept ? t + h_eff : t;
    ++nsteps;
    h = fmax(h_next, 1e-300);
    bad_in_a_row = bad > 0.0 ? bad_in_a_row + 1 : 0;
    if (bad_in_a_row > 64 || !(h <= inf) || !(t_new <= inf)) { status = kNonFinite; break; }
    if (accept) {
      for (int ci = tid; ci < m; ci += nt) {
        const int c = ci < na ? ci : ci + gap;
        y[c] = ynew[c];
      }
      team_sync(tm);
      // remaps where the step lands on a switch time
      bool crossed[4];
      bool any = false;
      for (int s = 0; s < nsw; ++s) {
        crossed[s] = t_new >= sw[s] && t < sw[s];
        any = any || crossed[s];
      }
      if (any) {
        const Flags fn = flags_at(ln, t_new);
        frame_of<kIdm>(T, tm, t_new, fbuf, fr);
        if (crossed[0]) remap_tca_off<kNewt, kScf, kIdm>(L, T, tm, fr, ln, fn, y);
        if (crossed[1]) remap_ufa_on(L, tm, y);
        if (crossed[2]) remap_rsa_on(L, tm, y);
        if (ns && crossed[3]) remap_ncdmfa_on(L, T, tm, fr, ln, y);
      }
      t = t_new;
      if (t_new >= t_b * (1.0 - 1e-15)) {
        frame_of<kIdm>(T, tm, t_b, fbuf, fr);
        compute_sources<kNewt, kScf, kIdm>(L, T, tm, fr, ln, flags_at(ln, t_b), y,
                                           S + (long)j * kNSrc);
        t = t_b;
        ++j;
      }
    }
    PK_PROF(7)
  }
  PK_PROF_END(prof_out)
  *nsteps_out = nsteps;
  return status;
}

}  // namespace pk

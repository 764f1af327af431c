// Host build of the per-lane perturbation integrator (perturb_ark.cuh): the
// same functions that perturb_ark.cu runs one lane per warp on the card, here
// with a team of one thread in a plain loop over the lanes. It exists so that
// the kernel's arithmetic can be held against the plain PyTorch version on a
// machine with no card and no nvcc:
//
//   g++ -O2 -std=c++17 -shared -fPIC -o libperturb_ark_host.so perturb_ark_host.cpp
//
// The arguments of perturb_ark_host_ic are those of perturb_ark_launch
// (perturb_ark.cu) with host pointers and a scratch of work_doubles, without
// the block order and the stream; like the card's launcher it runs the
// instance of the layout's scalar field (Layout::phi_scf) and gauge.
// perturb_ark_host_gauge is its case of adiabatic lanes (ic null),
// perturb_ark_host_curved that case in the synchronous gauge,
// perturb_ark_host the flat synchronous one (K = 0), perturb_ark_host_scf
// the synchronous case that requires a scalar field in the layout, and
// perturb_ark_host_idm the one that requires idm_dr (the idr damping's
// alpha_l, beta_l behind the ncdm data, as perturb_ark_launch takes them). The
// package never loads this library; tests/test_torch_perturbations.py,
// tests/test_torch_curved.py, tests/test_torch_newtonian.py,
// tests/test_torch_isocurvature.py, tests/test_torch_scf.py and
// tests/test_torch_idm_dr.py do.

#include "perturb_ark.cuh"

namespace {

template <bool kNewt, bool kScf, bool kIdm>
void run_lanes(const pk::LayoutOf<kIdm>& L, const pk::TablesOf<kIdm>& T, const double* lanes,
               const double* taus,
               const double* rtol, const double* atol, const int* ic, double k_eta_split,
               double K, int sgnK,
               long long max_steps, int nlanes, int ntau, double* work, double* S,
               long long* nsteps, int* status) {
  for (int lane = 0; lane < nlanes; ++lane) {
    pk::Lane ln;
    ln.k = lanes[lane];
    const double tau_ini = lanes[nlanes + lane];
    ln.t_tca = lanes[2 * nlanes + lane];
    ln.t_ufa = lanes[3 * nlanes + lane];
    ln.t_rsa = lanes[4 * nlanes + lane];
    ln.t_ncfa = lanes[5 * nlanes + lane];
    ln.ic = ic ? ic[lane] : pk::kIcAd;
    ln.eta_off = kNewt ? 0.0 : (ln.ic == pk::kIcAd && ln.k < k_eta_split ? 1.0 : 0.0);
    ln.K = K;
    ln.sgnK = sgnK;
    ln.sl = nullptr;
    status[lane] = pk::integrate_lane<kNewt, kScf, kIdm>(
        L, T, pk::Team{0, 1}, ln, tau_ini, taus, ntau, rtol + (long)lane * L.n,
        atol + (long)lane * L.n, (long)max_steps, work, S + (long)lane * ntau * pk::kNSrc,
        &nsteps[lane]);
  }
}

}  // namespace

extern "C" int perturb_ark_host_ic(const int* layout, const double* lanes, const double* taus,
                                   const double* bg_y, const double* bg_y2, double bg_x0,
                                   double bg_dx, int bg_n, const double* th_y,
                                   const double* th_y2, double th_x0, double th_dx, int th_n,
                                   const double* ncdm, const double* rtol, const double* atol,
                                   const int* ic, double k_eta_split, double K, int sgnK,
                                   int gauge, long long max_steps, int nlanes, int ntau,
                                   double* work, double* S, long long* nsteps, int* status) {
  pk::LayoutIdm LI;
  pk::read_layout(layout, LI);
  const pk::Layout& L = LI;
  const bool idm = LI.idm >= 0;
  pk::TablesIdm TI;
  pk::Tables& T = TI;
  T.bg_y = bg_y; T.bg_y2 = bg_y2; T.bg_x0 = bg_x0; T.bg_dx = bg_dx; T.bg_n = bg_n;
  T.bg_ncol = idm ? pk::bg_cols(LI) : pk::bg_cols(L);
  T.th_y = th_y; T.th_y2 = th_y2; T.th_x0 = th_x0; T.th_dx = th_dx; T.th_n = th_n;
  const long nsq = (long)L.ns * L.nq;
  T.q = ncdm; T.w = ncdm + L.nq; T.dlnf0 = T.w + nsq; T.x_fac = T.dlnf0 + nsq;
  T.pref = T.x_fac + L.ns;
  TI.idr_alpha = T.pref + L.ns;
  TI.idr_beta = TI.idr_alpha + 1 + LI.n_F_idr;
  if (gauge < 0 || gauge > 1 || (gauge == 1) != (L.theta_cdm >= 0)
      || (gauge == 1 && (L.phi_scf >= 0 || idm)) || (idm && L.phi_scf >= 0))
    return 1;
  if (gauge == 1)
    run_lanes<true, false, false>(L, T, lanes, taus, rtol, atol, ic, k_eta_split, K, sgnK,
                                  max_steps, nlanes, ntau, work, S, nsteps, status);
  else if (L.phi_scf >= 0)
    run_lanes<false, true, false>(L, T, lanes, taus, rtol, atol, ic, k_eta_split, K, sgnK,
                                  max_steps, nlanes, ntau, work, S, nsteps, status);
  else if (idm)
    run_lanes<false, false, true>(LI, TI, lanes, taus, rtol, atol, ic, k_eta_split, K, sgnK,
                                  max_steps, nlanes, ntau, work, S, nsteps, status);
  else
    run_lanes<false, false, false>(L, T, lanes, taus, rtol, atol, ic, k_eta_split, K, sgnK,
                                   max_steps, nlanes, ntau, work, S, nsteps, status);
  return 0;
}

extern "C" int perturb_ark_host_scf(const int* layout, const double* lanes, const double* taus,
                                    const double* bg_y, const double* bg_y2, double bg_x0,
                                    double bg_dx, int bg_n, const double* th_y,
                                    const double* th_y2, double th_x0, double th_dx, int th_n,
                                    const double* ncdm, const double* rtol, const double* atol,
                                    double k_eta_split, double K, int sgnK, long long max_steps,
                                    int nlanes, int ntau, double* work, double* S,
                                    long long* nsteps, int* status) {
  if (layout[pk::kLayoutInts - 1] < 0) return 1;   // no scalar field in the layout
  return perturb_ark_host_ic(layout, lanes, taus, bg_y, bg_y2, bg_x0, bg_dx, bg_n, th_y, th_y2,
                             th_x0, th_dx, th_n, ncdm, rtol, atol, nullptr, k_eta_split, K, sgnK,
                             0, max_steps, nlanes, ntau, work, S, nsteps, status);
}

extern "C" int perturb_ark_host_idm(const int* layout, const double* lanes, const double* taus,
                                    const double* bg_y, const double* bg_y2, double bg_x0,
                                    double bg_dx, int bg_n, const double* th_y,
                                    const double* th_y2, double th_x0, double th_dx, int th_n,
                                    const double* ncdm, const double* rtol, const double* atol,
                                    double k_eta_split, double K, int sgnK, long long max_steps,
                                    int nlanes, int ntau, double* work, double* S,
                                    long long* nsteps, int* status) {
  if (layout[22] < 0) return 1;   // no idm_dr in the layout (pk::read_layout)
  return perturb_ark_host_ic(layout, lanes, taus, bg_y, bg_y2, bg_x0, bg_dx, bg_n, th_y, th_y2,
                             th_x0, th_dx, th_n, ncdm, rtol, atol, nullptr, k_eta_split, K, sgnK,
                             0, max_steps, nlanes, ntau, work, S, nsteps, status);
}

extern "C" int perturb_ark_host_gauge(const int* layout, const double* lanes,
                                      const double* taus, const double* bg_y,
                                      const double* bg_y2, double bg_x0, double bg_dx, int bg_n,
                                      const double* th_y, const double* th_y2, double th_x0,
                                      double th_dx, int th_n, const double* ncdm,
                                      const double* rtol, const double* atol,
                                      double k_eta_split, double K, int sgnK, int gauge,
                                      long long max_steps, int nlanes, int ntau, double* work,
                                      double* S, long long* nsteps, int* status) {
  return perturb_ark_host_ic(layout, lanes, taus, bg_y, bg_y2, bg_x0, bg_dx, bg_n, th_y, th_y2,
                             th_x0, th_dx, th_n, ncdm, rtol, atol, nullptr, k_eta_split, K, sgnK,
                             gauge, max_steps, nlanes, ntau, work, S, nsteps, status);
}

extern "C" int perturb_ark_host_curved(const int* layout, const double* lanes,
                                       const double* taus, const double* bg_y,
                                       const double* bg_y2, double bg_x0, double bg_dx, int bg_n,
                                       const double* th_y, const double* th_y2, double th_x0,
                                       double th_dx, int th_n, const double* ncdm,
                                       const double* rtol, const double* atol,
                                       double k_eta_split, double K, int sgnK,
                                       long long max_steps, int nlanes, int ntau, double* work,
                                       double* S, long long* nsteps, int* status) {
  return perturb_ark_host_gauge(layout, lanes, taus, bg_y, bg_y2, bg_x0, bg_dx, bg_n, th_y, th_y2,
                                th_x0, th_dx, th_n, ncdm, rtol, atol, k_eta_split, K, sgnK, 0,
                                max_steps, nlanes, ntau, work, S, nsteps, status);
}

extern "C" int perturb_ark_host(const int* layout, const double* lanes, const double* taus,
                                const double* bg_y, const double* bg_y2, double bg_x0,
                                double bg_dx, int bg_n, const double* th_y,
                                const double* th_y2, double th_x0, double th_dx, int th_n,
                                const double* ncdm, const double* rtol, const double* atol,
                                double k_eta_split, long long max_steps, int nlanes, int ntau,
                                double* work, double* S, long long* nsteps, int* status) {
  return perturb_ark_host_curved(layout, lanes, taus, bg_y, bg_y2, bg_x0, bg_dx, bg_n, th_y,
                                 th_y2, th_x0, th_dx, th_n, ncdm, rtol, atol, k_eta_split, 0.0,
                                 0, max_steps, nlanes, ntau, work, S, nsteps, status);
}

// pk::work_doubles of a layout: the lane scratch the kernel sizes its shared
// memory by, so the wrapper's count (solve.py work_doubles) can be held to it.
extern "C" long long perturb_ark_host_work_doubles(const int* layout) {
  pk::LayoutIdm LI;
  pk::read_layout(layout, LI);
  return LI.idm >= 0 ? pk::work_doubles(LI) : pk::work_doubles(static_cast<const pk::Layout&>(LI));
}

// Host build of the per-lane tensor integrator (tensor_rkck.cuh): the same
// functions that tensor_rkck.cu runs one lane per warp on the card, here with
// a team of one thread in a plain loop over the lanes. It exists so that the
// kernel's arithmetic can be held against the plain PyTorch version on a
// machine with no card and no nvcc:
//
//   g++ -O2 -std=c++17 -shared -fPIC -o libtensor_rkck_host.so tensor_rkck_host.cpp
//
// The arguments of tensor_rkck_host_curved are those of tensor_rkck_launch
// (tensor_rkck.cu) with host pointers and a scratch of work_doubles, without
// the stream; tensor_rkck_host is the flat case (K = 0). The package never
// loads this library; tests/test_torch_tensors.py, tests/test_torch_curved.py
// and tests/test_torch_tensor_exact.py do.

#include "tensor_rkck.cuh"

extern "C" int tensor_rkck_host_curved(const int* layout, const double* lanes,
                                       const double* taus, const double* bg_y,
                                       const double* bg_y2, double bg_x0, double bg_dx, int bg_n,
                                       const double* th_y, const double* th_y2, double th_x0,
                                       double th_dx, int th_n, const double* ncdm, double rtol,
                                       double K, int sgnK, long long max_interval_steps,
                                       int nlanes, int ntau, double* work, double* S,
                                       long long* nsteps, int* status) {
  tk::Layout L;
  int* li = reinterpret_cast<int*>(&L);
  for (int i = 0; i < tk::kLayoutInts; ++i) li[i] = layout[i];
  if (tk::kNBg + L.ns + tk::kNTh > tk::kFrameCols) return 1;
  tk::Tables T;
  T.bg_y = bg_y; T.bg_y2 = bg_y2; T.bg_x0 = bg_x0; T.bg_dx = bg_dx; T.bg_n = bg_n;
  T.bg_ncol = tk::kNBg + L.ns;
  T.th_y = th_y; T.th_y2 = th_y2; T.th_x0 = th_x0; T.th_dx = th_dx; T.th_n = th_n;
  if (L.nsx && ncdm == nullptr) return 1;
  tk::set_ncdm(T, L, L.nsx ? ncdm : nullptr);
  for (int lane = 0; lane < nlanes; ++lane) {
    tk::Lane ln;
    ln.k = lanes[lane];
    const double tau_ini = lanes[nlanes + lane];
    ln.t_tca = lanes[2 * nlanes + lane];
    ln.t_rsa = lanes[3 * nlanes + lane];
    ln.K = K;
    ln.sgnK = sgnK;
    ln.sl = nullptr;
    const tk::Team tm{0, 1};
    status[lane] = L.nsx ? tk::integrate_lane<true>(L, T, tm, ln, tau_ini, taus, ntau, rtol,
                                                    (long)max_interval_steps, work,
                                                    S + 2L * lane * ntau, &nsteps[lane])
                         : tk::integrate_lane<false>(L, T, tm, ln, tau_ini, taus, ntau, rtol,
                                                     (long)max_interval_steps, work,
                                                     S + 2L * lane * ntau, &nsteps[lane]);
  }
  return 0;
}

extern "C" int tensor_rkck_host(const int* layout, const double* lanes, const double* taus,
                                const double* bg_y, const double* bg_y2, double bg_x0,
                                double bg_dx, int bg_n, const double* th_y,
                                const double* th_y2, double th_x0, double th_dx, int th_n,
                                const double* ncdm, double rtol, long long max_interval_steps,
                                int nlanes, int ntau, double* work, double* S, long long* nsteps,
                                int* status) {
  return tensor_rkck_host_curved(layout, lanes, taus, bg_y, bg_y2, bg_x0, bg_dx, bg_n, th_y,
                                 th_y2, th_x0, th_dx, th_n, ncdm, rtol, 0.0, 0,
                                 max_interval_steps, nlanes, ntau, work, S, nsteps, status);
}

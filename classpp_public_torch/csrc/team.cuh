// The team of threads that runs one serial program together, shared by the
// per-lane integrators (perturb_ark.cuh, tensor_rkck.cuh) and the RECFAST
// history (recfast.cuh). On the card a team is one warp (32 threads, every
// thread running the same instruction stream); compiled without nvcc the same
// code builds for the host with a team of one, which is how the CPU tests
// check a kernel's arithmetic without a card. The reductions are butterflies
// that leave the same bits in every thread.

#pragma once

#include <math.h>

#ifdef __CUDACC__
#define TEAM_FN __device__ inline
#else
#define TEAM_FN inline
#endif

namespace team {

// thread tid of nt
struct Team {
  int tid, nt;
};

#ifdef __CUDACC__
TEAM_FN void team_sync(const Team&) { __syncwarp(); }
TEAM_FN double team_sum(const Team&, double v) {
  for (int m = 16; m > 0; m >>= 1) v += __shfl_xor_sync(0xffffffffu, v, m);
  return v;
}
TEAM_FN double team_max(const Team&, double v) {
  for (int m = 16; m > 0; m >>= 1) v = fmax(v, __shfl_xor_sync(0xffffffffu, v, m));
  return v;
}
#else
TEAM_FN void team_sync(const Team&) {}
TEAM_FN double team_sum(const Team&, double v) { return v; }
TEAM_FN double team_max(const Team&, double v) { return v; }
#endif

// UniformSpline.eval of column c at x (ops/splines.py:170): y, y2 are (n, ncol)
TEAM_FN double spline_col(const double* y, const double* y2, double x0, double dx, int n,
                          int ncol, double x, int c) {
  const double t = (x - x0) / dx;
  int i = (int)floor(t);
  i = i < 0 ? 0 : (i > n - 2 ? n - 2 : i);
  const double b = t - (double)i, a = 1.0 - b;
  const double ca = a * a * a - a, cb = b * b * b - b, h2 = dx * dx;
  const double* yl = y + (long)i * ncol;
  const double* y2l = y2 + (long)i * ncol;
  return a * yl[c] + b * yl[ncol + c] + (ca * y2l[c] + cb * y2l[ncol + c]) * h2 / 6.0;
}

// The background columns, then the nth thermodynamics columns, of the two
// table splines of T (fields bg_* and th_*) at x, into buf (shared by the
// team), the same in every thread. The columns are spread over the team: one
// table row read per thread instead of a serial walk over the columns.
template <class Tables>
TEAM_FN void table_row(const Tables& T, const Team& tm, int nth, double x, double* buf) {
  const int nbg = T.bg_ncol;
  team_sync(tm);   // the previous row has been read by every thread
  for (int c = tm.tid; c < nbg + nth; c += tm.nt)
    buf[c] = c < nbg ? spline_col(T.bg_y, T.bg_y2, T.bg_x0, T.bg_dx, T.bg_n, nbg, x, c)
                     : spline_col(T.th_y, T.th_y2, T.th_x0, T.th_dx, T.th_n, nth, x, c - nbg);
  team_sync(tm);
}

}  // namespace team

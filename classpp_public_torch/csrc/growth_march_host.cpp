// Host build of the growth-factor march (growth_march.cuh): the same
// functions that growth_march.cu runs in one block on the card, here with a
// team of one thread. It exists so that the kernel's arithmetic can be held
// against the plain loop on a machine with no card and no nvcc:
//
//   g++ -O2 -std=c++17 -shared -fPIC -o libgrowth_march_host.so growth_march_host.cpp
//
// The arguments are those of growth_march_launch (growth_march.cu) with host
// pointers, without the stream. The package never loads this library;
// tests/test_torch_tensor_exact.py does.

#include "growth_march.cuh"

extern "C" long growth_march_coef_doubles(int n, int substeps) {
  return gm::coef_doubles(n, substeps);
}

extern "C" int growth_march_host(const double* y, const double* y2, double x0, double dx,
                                 int n_spl, const double* ts, const double* aH, int n,
                                 int substeps, double y00, double y01, double* coef, double* Y,
                                 double* out) {
  if (n < 2 || n_spl < 2 || substeps < 1) return 1;
  const gm::Spline S{y, y2, x0, dx, n_spl};
  gm::coef_table(S, ts, n, substeps, 0, 1, coef);
  gm::march(ts, n, substeps, coef, y00, y01, Y);
  gm::normalise(Y, aH, n, 0, 1, out);
  return 0;
}

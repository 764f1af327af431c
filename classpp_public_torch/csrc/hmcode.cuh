// The per-node arithmetic of the two HMcode kernels (hmcode_sigma.cu,
// hmcode_onehalo.cu), as plain functions so that the same code builds for the
// card and, compiled without nvcc, for the host (hmcode_host.cpp), which is
// how the CPU tests hold it against the plain PyTorch versions without a card.
// Each follows the JAX expression (classpp_public_tpu/models/nonlinear.py
// :211-258, :349-358) in its order of operations.
#pragma once

#include <math.h>

#include "special.cuh"

namespace hmcode {

constexpr int kSigmaThreads = 128;     // hmcode_sigma: threads per (spectrum, R)
constexpr int kOnehaloThreads = 256;   // hmcode_onehalo: threads per (row, k)

// The three weighted integrands of node i of the sigma integrals at radius r:
// D2 w W^2, D2 w 2 k W W', D2 w / k^2 / 3 W^2, with w the node's trapezoid
// weight in ln k and D2 = base[i].
SPECIAL_FN void sigma_node(const double* base, const double* k, const double* lnk, int nk,
                           int i, double r, double* s1, double* s2, double* s3) {
  const double w = 0.5 * (lnk[i < nk - 1 ? i + 1 : nk - 1] - lnk[i > 0 ? i - 1 : 0]);
  const double ki = k[i], x = ki * r;
  double W, Wp;
  if (x < 0.01) {
    W = 1.0 - x * x / 10.0;
    Wp = -0.2 * x;
  } else {
    double sx, cx;
    sincos(x, &sx, &cx);
    const double tail = sx - x * cx;
    W = 3.0 / (x * x * x) * tail;
    Wp = 3.0 / (x * x) * sx - 9.0 / (x * x * x * x) * tail;
  }
  const double bw = base[i] * w;
  *s1 += bw * W * W;
  *s2 += bw * 2.0 * ki * W * Wp;
  *s3 += bw / (ki * ki) / 3.0 * W * W;
}

// Node i of the one-halo integral of one row at wavenumber kk: m g_ST(nu)
// W_NFW(nu^eta kk, r_v, c)^2 times the node's trapezoid weight in nu; 0 where
// nu > 10.
SPECIAL_FN double onehalo_node(const double* nu, const double* m, const double* rv,
                               const double* conc, int nm, int i, double eta, double kk) {
  const double n = nu[i];
  if (!(n <= 10.0)) return 0.0;
  const double w = 0.5 * (nu[i < nm - 1 ? i + 1 : nm - 1] - nu[i > 0 ? i - 1 : 0]);
  const double gst = 0.21616 * (1.0 + pow(0.707 * n * n, -0.3)) * exp(-0.707 * n * n / 2.0);
  const double c = conc[i];
  const double ks = pow(n, eta) * kk * rv[i] / c;
  double si1, ci1, si2, ci2;
  special::si_ci(ks, &si1, &ci1);
  special::si_ci(ks * (1.0 + c), &si2, &ci2);
  double sk, ck;
  sincos(ks, &sk, &ck);
  const double p1 = ck * (ci2 - ci1);
  const double p2 = sk * (si2 - si1);
  const double p3 = sin(ks * c) / (ks * (1.0 + c));
  const double wn = (p1 + p2 - p3) / (log(1.0 + c) - c / (1.0 + c));
  return m[i] * gst * wn * wn * w;
}

}  // namespace hmcode

// The sine and cosine integrals Si(x), Ci(x) for x > 0, as a device function.
//
// The CUDA twin of `si_ci` in classpp_public_torch/ops/special.py (JAX
// classpp_public_tpu/ops/special.py:25-110): the power series for x < 4 (30
// terms) and, for x >= 4, the modified-Lentz continued fraction of E1(ix)
// with its first step unrolled (60 steps), the complex arithmetic as (re, im)
// pairs, in the same order of operations. Where the plain version evaluates
// both branches and picks one, this takes one branch per element. Compiled
// without nvcc it builds for the host (csrc/hmcode_host.cpp).
#pragma once

#include <math.h>

#ifdef __CUDACC__
#define SPECIAL_FN __host__ __device__ inline
#else
#define SPECIAL_FN inline
#endif

namespace special {

constexpr double kEuler = 0.57721566490153286060651209008240243104215933593992;
constexpr double kHalfPi = 1.57079632679489661923;   // pi / 2
constexpr int kSeries = 30;
constexpr int kLentz = 60;

SPECIAL_FN void si_ci(double x, double* si, double* ci) {
  if (x < 4.0) {
    // Si = sum (-1)^n x^(2n+1) / ((2n+1) (2n+1)!), Cin = sum_{n>=1} (-1)^(n+1)
    // x^(2n) / (2n (2n)!), Ci = gamma + ln x - Cin
    const double x2 = x * x;
    double s = 0.0, cin = 0.0, t_odd = x, t_even = x2 / 2.0;
    for (int n = 0; n < kSeries; ++n) {
      const double sign = (n & 1) ? -1.0 : 1.0;
      s = s + sign * t_odd / (double)(2 * n + 1);
      cin = cin + sign * t_even / (double)(2 * n + 2);
      t_odd = t_odd * x2 / (double)((2 * n + 2) * (2 * n + 3));
      t_even = t_even * x2 / (double)((2 * n + 3) * (2 * n + 4));
    }
    *si = s;
    *ci = kEuler + log(x) - cin;
    return;
  }
  // E1(ix) = e^{-ix} h, h = 1/(b0 - 1^2/(b1 - 2^2/(b2 - ...))), b_j = 2j + 1 + ix
  double br = 1.0;
  const double bi = x;
  const double d_den = br * br + bi * bi;
  double dr = br / d_den, di = -bi / d_den;
  double hr = dr, hi = di;
  // the first step unrolled with c0 = infinity, so c1 = b
  double a = -1.0;
  br = br + 2.0;
  double tr = a * dr + br, ti = a * di + bi;
  double den = tr * tr + ti * ti;
  dr = tr / den;
  di = -ti / den;
  double cr = br, cim = bi;
  double er = cr * dr - cim * di, ei = cr * di + cim * dr;
  double hr_new = hr * er - hi * ei;
  hi = hr * ei + hi * er;
  hr = hr_new;
  for (int i = 3; i < kLentz + 2; ++i) {
    a = -((i - 1.0) * (i - 1.0));
    br = br + 2.0;
    tr = a * dr + br;                     // d = 1/(a d + b)
    ti = a * di + bi;
    den = tr * tr + ti * ti;
    dr = tr / den;
    di = -ti / den;
    const double den_c = cr * cr + cim * cim;   // c = b + a/c
    const double cr_new = br + a * cr / den_c;
    cim = bi - a * cim / den_c;
    cr = cr_new;
    er = cr * dr - cim * di;              // h *= c d
    ei = cr * di + cim * dr;
    hr_new = hr * er - hi * ei;
    hi = hr * ei + hi * er;
    hr = hr_new;
  }
  double sx, cx;
  sincos(x, &sx, &cx);
  const double e1r = cx * hr + sx * hi;
  const double e1i = cx * hi - sx * hr;
  *ci = -e1r;
  *si = kHalfPi + e1i;
}

}  // namespace special

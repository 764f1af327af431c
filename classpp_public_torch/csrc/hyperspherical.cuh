// Hyperspherical Bessel functions Phi_l^nu(x) for the curved line-of-sight
// scans (transfer_los_curved.cu, transfer_tensor_los_curved.cu): the seeds,
// one step of the upward recurrence with its forbidden-region mask, the
// running log prefactor and the small-x curved series. Every function is the
// counterpart of a line of classpp_public_torch/models/transfer.py
// (`_hyper_setup`, `_hyper_scan`, `_curved_series_phi`), which copies
// classpp_public_tpu/models/transfer.py :494-614 and :757-805.
//
// x = sqrt|K| (tau0 - tau), beta = nu = q/sqrt|K|, Ktilde = sgnK. Per q (one
// block) the scalars sqrtK(l) = sqrt(max(beta^2 - Ktilde l^2, 1e-30)) and the
// log prefactor lnC depend on l only; per (q, tau) point a thread keeps x,
// sin_K, cot_K, beta x, beta sin_K, 6 cbrt(beta sin_K) + 2 and the two last
// Phi in registers.

#pragma once

#include <math.h>

namespace hs {

// The (q, tau) point of a thread: its geometry and its last two Phi.
struct Point {
  double x, sinK, cosK, cotK, bx, xf, buf6;
  double pm1, pm2;     // Phi_{l-1}, Phi_{l-2}
};

__device__ __forceinline__ double sqrt_k(double beta2, double Kt, double l) {
  return sqrt(fmax(beta2 - Kt * l * l, 1e-30));
}

// Seeds Phi_0, Phi_1 at chi = tau0 - tau (hyperspherical.c:482-483), with the
// series of j_0 for beta x < 0.3.
__device__ __forceinline__ Point seed(double chi, double sab, double beta, double beta2, int sgnK) {
  Point p;
  const double x = fmax(sab * chi, 1e-12);
  p.x = x;
  if (sgnK > 0) {
    p.sinK = sin(x);
    p.cosK = cos(x);
  } else {
    p.sinK = sinh(x);
    p.cosK = cosh(x);
  }
  p.cotK = p.cosK / p.sinK;
  const double bx = fmax(beta * x, 1e-12);
  const double bx2 = bx * bx;
  p.bx = bx;
  const double j0f = bx < 0.3 ? 1.0 - bx2 / 6.0 * (1.0 - bx2 / 20.0 * (1.0 - bx2 / 42.0))
                              : sin(bx) / bx;
  const double Kt = sgnK > 0 ? 1.0 : -1.0;
  const double Phi0 = j0f * (x / p.sinK);
  p.pm2 = Phi0;
  p.pm1 = Phi0 * (p.cotK - beta / tan(bx)) / sqrt_k(beta2, Kt, 1.0);
  p.xf = beta * p.sinK;
  p.buf6 = 6.0 * cbrt(p.xf) + 2.0;
  return p;
}

// Phi_l from the recurrence (hyperspherical.c:472-485), or 0 in the forbidden
// region: l > beta sin_K + 6 cbrt(beta sin_K) + 2, and, closed, the buffer
// capped at (beta - l)/2 + 2 and l + 1/2 >= beta (the discrete spectrum ends
// at l = nu; beta is an integer only up to round-off, and sqrtK(nu) is the
// clamped 1e-15, so the value there is dropped by the select, never
// multiplied by 0). inv_sq_l = 1/sqrtK(l), one division per (q, l) instead
// of one per point: a float64 division is a dozen dependent operations, the
// rest of the step three.
__device__ __forceinline__ double step(const Point& p, double l, double beta, double inv_sq_l,
                                       double sq_lm1, int sgnK) {
  const double v = ((2.0 * l - 1.0) * p.cotK * p.pm1 - sq_lm1 * p.pm2) * inv_sq_l;
  bool mask;
  if (sgnK > 0)
    mask = (l <= p.xf + fmin(p.buf6, 0.5 * (beta - l) + 2.0)) && (l + 0.5 < beta);
  else
    mask = l <= p.xf + p.buf6;
  return mask ? v : 0.0;
}

// The series prefactor's step: lnC_l = lnC_{l-1} + ln(sqrtK(l)/beta), the
// log clamped so that it stays real for l >= beta (closed).
__device__ __forceinline__ double ln_c_step(double lnC, double l, double beta2, double Kt) {
  return lnC + 0.5 * log1p(fmax(-Kt * l * l / beta2, -1.0 + 1e-14));
}

// The coefficients c1, c2, c3 of the curved small-x series at (l, beta^2)
// (transfer.py `_curved_series_phi`).
struct Series {
  double c1, c2, c3;
};

__device__ __forceinline__ Series series(double l, double beta2, double Kt) {
  const double l2 = l * l;
  Series c;
  c.c1 = (Kt * (l2 + 3.0 * l + 3.0) - 3.0 * beta2) / (6.0 * (2.0 * l + 3.0));
  c.c2 = (5.0 * l2 * l2 + 30.0 * l2 * l + 95.0 * l2 + 150.0 * l + 105.0
          - Kt * beta2 * (30.0 * l2 + 90.0 * l + 150.0) + 45.0 * beta2 * beta2
          + (12.0 * l2 * l + 38.0 * l2 + 30.0 * l)) / (360.0 * (4.0 * l2 + 16.0 * l + 15.0));
  const double b2 = beta2, b4 = beta2 * beta2, b6 = beta2 * beta2 * beta2;
  const double l3 = l2 * l, l4 = l2 * l2, l5 = l2 * l2 * l, l6 = l2 * l2 * l2;
  c.c3 = (Kt * (35.0 * l6 + 315.0 * l5 + 1680.0 * l4 + 5355.0 * l3 + 11200.0 * l2
                + 13755.0 * l + 8085.0)
          - b2 * (315.0 * l4 + 1890.0 * l3 + 7245.0 * l2 + 13230.0 * l + 13755.0)
          + Kt * b4 * (945.0 * l2 + 2835.0 * l + 6615.0)
          + Kt * (252.0 * l5 + 2042.0 * l4 + 7188.0 * l3 + 11980.0 * l2 + 8442.0 * l + 1680.0)
          - 945.0 * b6
          - b2 * (756.0 * l3 + 2898.0 * l2 + 3402.0 * l + 1680.0))
         / (45360.0 * (8.0 * l3 + 60.0 * l2 + 142.0 * l + 105.0));
  return c;
}

// Phi_l, dPhi_l/dx and d2Phi_l/dx2 at an emitted l of point p whose
// recurrence value is pl: the series where beta x < 1 (lnC: the prefactor
// at l; lndf = ln (2l+1)!!), the recurrence elsewhere, and d2Phi from the
// hyperspherical equation (hyperspherical.c:389).
__device__ __forceinline__ void emitted(const Point& p, double l, double pl, double sq_l,
                                        double lnC, double lndf, const Series& c, double beta2,
                                        double Kt, double& pl_e, double& dp_e, double& d2p) {
  if (p.bx < 1.0) {
    const double x = p.x, x2 = x * x;
    const double base = exp(l * log(p.bx) - lndf + lnC);
    const double poly = 1.0 + x2 * (c.c1 + x2 * (c.c2 + x2 * c.c3));
    const double dpoly = x * (2.0 * c.c1 + x2 * (4.0 * c.c2 + x2 * 6.0 * c.c3));
    pl_e = base * poly;
    dp_e = base * (l / x * poly + dpoly);
  } else {
    pl_e = pl;
    dp_e = sq_l * p.pm1 - (l + 1.0) * p.cotK * pl;
  }
  d2p = -2.0 * dp_e * p.cotK + pl_e * (l * (l + 1.0) / (p.sinK * p.sinK) - beta2 + Kt);
}

}  // namespace hs

"""Special functions: the sine and cosine integrals Si(x), Ci(x).

Counterpart of classpp_public_tpu/ops/special.py (`si_ci` :25): the power
series for x < 4 and, for x >= 4, the modified-Lentz continued fraction of
E1(ix) with its first step unrolled, the complex arithmetic carried as (re,
im) pairs. The same 30 series terms and 60 Lentz steps, in the same order of
operations. Both branches are evaluated on every element and the result is
picked per element, as the JAX function does; the CUDA twin
(csrc/special.cuh) takes one branch per element.
"""

from __future__ import annotations

import math

import torch

EULER = 0.57721566490153286060651209008240243104215933593992
N_SERIES = 30     # series terms: for x < 4 the last term is below 1e-15 relative
N_CF = 60         # Lentz steps: converged to 1e-16 for x >= 4


def si_ci(x: torch.Tensor):
    """(Si(x), Ci(x)) elementwise for x > 0.

    Si(x) = int_0^x sin t / t dt, Ci(x) = gamma + ln x + int_0^x (cos t - 1)/t dt."""
    small = x < 4.0
    xs = torch.where(small, x, 1.0)       # series argument
    xc = torch.where(small, 4.0, x)       # continued-fraction argument

    # power series: Si = sum (-1)^n x^(2n+1) / ((2n+1) (2n+1)!),
    # Cin = sum_{n>=1} (-1)^(n+1) x^(2n) / (2n (2n)!), Ci = gamma + ln x - Cin
    x2 = xs * xs
    si_s = torch.zeros_like(xs)
    cin_s = torch.zeros_like(xs)
    t_odd = xs                             # x^(2n+1) / (2n+1)!
    t_even = x2 / 2.0                      # x^(2n+2) / (2n+2)!
    for n in range(N_SERIES):
        sign = (-1) ** n
        si_s = si_s + sign * t_odd / (2 * n + 1)
        cin_s = cin_s + sign * t_even / (2 * n + 2)
        t_odd = t_odd * x2 / ((2 * n + 2) * (2 * n + 3))
        t_even = t_even * x2 / ((2 * n + 3) * (2 * n + 4))
    ci_s = EULER + torch.log(xs) - cin_s

    # E1(ix) = e^{-ix} h, h = 1/(b0 - 1^2/(b1 - 2^2/(b2 - ...))), b_j = 2j + 1 + ix;
    # Ci = -Re E1(ix), Si = pi/2 + Im E1(ix)
    br, bi = 1.0 + torch.zeros_like(xc), xc
    d_den = br * br + bi * bi
    dr, di = br / d_den, -bi / d_den
    hr, hi = dr, di
    # the first step unrolled with c0 = infinity, so c1 = b
    a = -1.0
    br = br + 2.0
    tr, ti = a * dr + br, a * di + bi
    den = tr * tr + ti * ti
    dr, di = tr / den, -ti / den
    cr, ci_ = br, bi
    er, ei = cr * dr - ci_ * di, cr * di + ci_ * dr
    hr, hi = hr * er - hi * ei, hr * ei + hi * er
    for i in range(3, N_CF + 2):
        a = -((i - 1.0) ** 2)
        br = br + 2.0
        tr, ti = a * dr + br, a * di + bi          # d = 1/(a d + b)
        den = tr * tr + ti * ti
        dr, di = tr / den, -ti / den
        den_c = cr * cr + ci_ * ci_                # c = b + a/c
        cr, ci_ = br + a * cr / den_c, bi - a * ci_ / den_c
        er, ei = cr * dr - ci_ * di, cr * di + ci_ * dr   # h *= c d
        hr, hi = hr * er - hi * ei, hr * ei + hi * er
    cx, sx = torch.cos(xc), torch.sin(xc)
    e1r = cx * hr + sx * hi
    e1i = cx * hi - sx * hr
    return torch.where(small, si_s, math.pi / 2.0 + e1i), torch.where(small, ci_s, -e1r)

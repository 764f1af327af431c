"""Linear and nonlinear matter power spectra (counterpart of
classpp_public_tpu/models/nonlinear.py: `pk_linear_at_z` :82, `sigma_R` :103,
`_halofit_one_z` :112, `_halofit_core` :433, `compute_nonlinear` :543).

The linear P(k, tau) comes from sources x primordial (nonlinear_pk_linear,
nonlinear_module.cpp:1886); halofit is Takahashi 2012 with the Bird
massive-neutrino corrections (nonlinear_halofit :2291). sigma^2(R, z) for a
whole log-R grid and all requested redshifts is one call of the Gaussian
window sums (`halofit_sums_plain`), R_nl comes from a monotone inversion and
two Newton steps; the crossing search, the Newton steps and the closed-form
fit are tensor code on (z,) and (z, k). Halofit is the one nonlinear method
here. In a curved universe halofit feels Omega_k through Omega_m(z) and
Omega_v(z) = 1 - Omega_m - Omega_r, read from the background columns whose
rho_crit carries the curvature term (nonlinear.py:459-462).
"""

from __future__ import annotations

import math
from typing import NamedTuple

import numpy as np
import torch

from ..ops.splines import interp, spline_d2, spline_eval
from .background import tau_of_z
from .perturbations.indices import SrcIdx
from .primordial import PrimordialResult

N_R_GRID = 160   # trial radii of the sigma(R) = 1 search


class PkResult(NamedTuple):
    k: torch.Tensor           # (nk,)
    z: torch.Tensor           # (nz,) requested redshifts
    pk_lin: torch.Tensor      # (nz, nk) linear P_m(k, z) [Mpc^3]
    pk_nl: torch.Tensor       # (nz, nk) halofit P_m(k, z)
    pk_cb_lin: torch.Tensor   # (nz, nk) cdm + baryon
    pk_cb_nl: torch.Tensor
    k_nl: torch.Tensor        # (nz,) nonlinearity scale
    k_nl_cb: torch.Tensor     # (nz,) cb nonlinearity scale
    sigma8: float             # sigma8(z = 0)


def _delta_at_z(pert, sources, bg, z, col):
    """delta(k, z): the source column `col` of `sources` splined in tau."""
    tau_q = tau_of_z(bg, z).to(pert.tau.device)
    S = sources[:, :, SrcIdx.ix[col]].T.contiguous()     # (ntau, nk)
    return spline_eval(pert.tau, S, spline_d2(pert.tau, S), tau_q)


def pk_linear_at_z(pert, bg, pm: PrimordialResult, z, col: str = "delta_m") -> torch.Tensor:
    """P(k, z) = 2 pi^2 / k^3 P_R(k) delta(k, z)^2, delta splined in tau."""
    k = pert.k
    delta = _delta_at_z(pert, pert.sources, bg, z, col)
    return 2.0 * math.pi**2 / k**3 * pm.scalar_pk(k) * delta**2


def sigma_R(k: torch.Tensor, pk: torch.Tensor, R) -> torch.Tensor:
    """Top-hat sigma(R) (nonlinear_sigmas :2041), trapezoid in ln k."""
    R = torch.atleast_1d(torch.as_tensor(R, dtype=k.dtype, device=k.device))
    x = k[None, :] * R[:, None]
    W = 3.0 * (torch.sin(x) - x * torch.cos(x)) / x**3
    integrand = k[None, :] ** 3 * pk[None, :] / (2.0 * math.pi**2) * W**2
    return torch.sqrt(torch.trapezoid(integrand, torch.log(k), dim=-1))


def halofit_sums_plain(base: torch.Tensor, k: torch.Tensor, R: torch.Tensor) -> torch.Tensor:
    """Plain version of the Gaussian-window sums (nonlinear.py:119-133).
    base (nz, nk) = P(k) k^2 / (2 pi^2) on the halofit grid k (nk,); R (nz, nR).
    Returns (nz, nR, 3): s1 = int D2 e^{-x2} dln k, s2 = int D2 2 x2 e^{-x2} dln k,
    s3 = int D2 4 x2 (1 - x2) e^{-x2} dln k with D2 = base k, x2 = (k R)^2."""
    lnk = torch.log(k)
    x2 = (k[None, None, :] * R[:, :, None]) ** 2
    f = (base * k)[:, None, :] * torch.exp(-x2)
    return torch.stack([torch.trapezoid(f, lnk, dim=-1),
                        torch.trapezoid(f * 2.0 * x2, lnk, dim=-1),
                        torch.trapezoid(f * 4.0 * x2 * (1.0 - x2), lnk, dim=-1)], dim=-1)


def halofit_sums(base: torch.Tensor, k: torch.Tensor, R: torch.Tensor) -> torch.Tensor:
    """The Gaussian-window sums: CUDA kernel (one block per (z, R)) for CUDA
    tensors, plain version for CPU tensors. Shapes as `halofit_sums_plain`."""
    return halofit_sums_plain(base, k, R)


def _interp_rows(x, xp: torch.Tensor, fp: torch.Tensor) -> torch.Tensor:
    """numpy.interp(x[i], xp[i], fp[i]) for every row i of xp (nz, n), xp
    increasing along each row; x a float or (nz,), fp (n,) or (nz, n): linear
    between the bracketing nodes, clamped to the end values outside."""
    n = xp.shape[1]
    if isinstance(x, torch.Tensor):
        xq = x[:, None].contiguous()
    else:
        xq = torch.full((xp.shape[0], 1), x, dtype=xp.dtype, device=xp.device)
    i = torch.clamp(torch.searchsorted(xp.contiguous(), xq, right=True), 1, n - 1)
    x0, x1 = torch.gather(xp, 1, i - 1), torch.gather(xp, 1, i)
    if fp.dim() == 1:
        f0, f1, lo, hi = fp[i - 1], fp[i], fp[0], fp[-1]
    else:
        f0, f1, lo, hi = torch.gather(fp, 1, i - 1), torch.gather(fp, 1, i), fp[:, :1], fp[:, -1:]
    out = f0 + (xq - x0) / (x1 - x0) * (f1 - f0)
    out = torch.where(xq < xp[:, :1], lo, torch.where(xq > xp[:, -1:], hi, out))
    return out[:, 0]


def _halofit_scale(k_hf: torch.Tensor, pk_hf: torch.Tensor, min_k_nl: float):
    """The nonlinear scale of each redshift: R_nl with sigma(R_nl) = 1, and the
    sums (s1, s2, s3) there (nonlinear.py:116-146). pk_hf (nz, nk_hf): linear
    P on the dense log grid k_hf."""
    base = (pk_hf * k_hf**2 / (2.0 * math.pi**2)).contiguous()
    nz = pk_hf.shape[0]
    # sigma(R) on a log grid, invert sigma = 1 at its first crossing
    lgR = torch.linspace(math.log10(1.0 / float(k_hf[-1]) * 0.3), math.log10(1.0 / min_k_nl),
                         N_R_GRID, dtype=k_hf.dtype, device=k_hf.device)
    Rg = (10.0 ** lgR)[None, :].expand(nz, N_R_GRID).contiguous()
    lnsig = 0.5 * torch.log(halofit_sums(base, k_hf, Rg)[:, :, 0])   # decreasing in R
    R_nl = 10.0 ** _interp_rows(0.0, -lnsig, lgR)
    # two Newton steps on ln sigma(ln R): dln s1/dln R = -s2/s1
    for _ in range(2):
        s = halofit_sums(base, k_hf, R_nl[:, None].contiguous())[:, 0]
        f = 0.5 * torch.log(s[:, 0])
        fprime = -0.5 * s[:, 1] / s[:, 0]
        R_nl = R_nl * torch.exp(-f / fprime)
    s = halofit_sums(base, k_hf, R_nl[:, None].contiguous())[:, 0]
    return R_nl, s[:, 0], s[:, 1], s[:, 2]


def _halofit_ratio(scale, k_out, pk_lin_out, Omega_m, Omega_v, w0, fnu, Omega0_m, h, min_k_nl):
    """Takahashi 2012 + Bird (nonlinear_halofit :2655-2710) on (nz, nk):
    P_nl(k_out) from the linear P there and the scale of `_halofit_scale`.
    Omega_m, Omega_v, w0: (nz,); fnu, Omega0_m, h: floats."""
    R_nl, s1, s2, s3 = scale
    anorm = 1.0 / (2.0 * math.pi**2)
    d1 = -s2 / s1
    d2 = -(s2 / s1) ** 2 - s3 / s1
    rknl = 1.0 / R_nl
    rneff = -3.0 - d1
    rncur = -d2
    gam = 0.1971 - 0.0843 * rneff + 0.8460 * rncur
    a = 10.0 ** (1.5222 + 2.8553 * rneff + 2.3706 * rneff**2 + 0.9903 * rneff**3
                 + 0.2250 * rneff**4 - 0.6038 * rncur + 0.1749 * Omega_v * (1.0 + w0))
    b = 10.0 ** (-0.5642 + 0.5864 * rneff + 0.5716 * rneff**2 - 1.5474 * rncur
                 + 0.2279 * Omega_v * (1.0 + w0))
    c = 10.0 ** (0.3698 + 2.0404 * rneff + 0.8161 * rneff**2 + 0.5869 * rncur)
    xmu = 0.0
    xnu = 10.0 ** (5.2105 + 3.6902 * rneff)
    alpha = torch.abs(6.0835 + 1.3373 * rneff - 0.1959 * rneff**2 - 5.5274 * rncur)
    beta = (2.0379 - 0.7354 * rneff + 0.3157 * rneff**2 + 1.2490 * rneff**3
            + 0.3980 * rneff**4 - 0.1682 * rncur + fnu * (1.081 + 0.395 * rneff**2))
    frac = Omega_v / (1.0 - Omega_m)
    far = torch.abs(1.0 - Omega_m) > 0.01
    f1 = torch.where(far, frac * Omega_m**-0.0307 + (1 - frac) * Omega_m**-0.0732, 1.0)
    f2 = torch.where(far, frac * Omega_m**-0.0585 + (1 - frac) * Omega_m**-0.1423, 1.0)
    f3 = torch.where(far, frac * Omega_m**0.0743 + (1 - frac) * Omega_m**0.0725, 1.0)

    def col(v):
        return v[:, None]

    rk = k_out[None, :]
    pk_lin_dimless = pk_lin_out * rk**3 * anorm
    y = rk / col(rknl)
    pk_halo = col(a) * y ** col(f1 * 3.0) / (1.0 + col(b) * y ** col(f2)
                                             + (col(f3 * c) * y) ** col(3.0 - gam))
    pk_halo = pk_halo / (1.0 + xmu / y + col(xnu) / y**2) \
        * (1.0 + fnu * (0.977 - 18.015 * (Omega0_m - 0.3)))
    pk_linaa = pk_lin_dimless * (1.0 + fnu * 47.48 * (rk / h) ** 2 / (1.0 + 1.5 * (rk / h) ** 2))
    pk_quasi = pk_lin_dimless * (1.0 + pk_linaa) ** col(beta) / (1.0 + pk_linaa * col(alpha)) \
        * torch.exp(-y / 4.0 - y**2 / 8.0)
    pk_nl = (pk_halo + pk_quasi) / rk**3 / anorm
    return torch.where(rk > min_k_nl, pk_nl, pk_lin_out), rknl


def _halofit_one_z(k_hf, pk_hf, k_out, pk_lin_out, Omega_m, Omega_v, w0, fnu, Omega0_m, h,
                   min_k_nl):
    """Halofit at one redshift (nonlinear.py:112): (pk_nl (nk_out,), k_nl).
    k_hf: dense log grid; pk_hf: linear P on it."""
    def one(v):
        return torch.as_tensor(v, dtype=k_hf.dtype, device=k_hf.device).reshape(1)

    pk_nl, rknl = _halofit_ratio(_halofit_scale(k_hf, pk_hf[None, :], min_k_nl), k_out,
                                 pk_lin_out[None, :], one(Omega_m), one(Omega_v), one(w0),
                                 float(fnu), float(Omega0_m), float(h), min_k_nl)
    return pk_nl[0], rknl[0]


def compute_nonlinear(pert, bg, bidx, pm: PrimordialResult, pr, params,
                      z_pk=(0.0,)) -> PkResult:
    """Linear and halofit P(k, z) at every z of z_pk, total and cdm+baryon,
    with k_nl and sigma8 (the whole of `_halofit_core`, nonlinear.py:443-487)."""
    k = pert.k
    dev, f64 = k.device, k.dtype
    k_np = pert.k_np if pert.k_np is not None else k.cpu().numpy()
    z_arr = torch.as_tensor(np.atleast_1d(np.asarray(z_pk, dtype=np.float64)), device=dev)
    # halofit k grid: log-spaced at halofit_k_per_decade between the k bounds
    n_hf = int(math.log10(k_np[-1] / k_np[0]) * pr.halofit_k_per_decade) + 1
    k_hf = torch.as_tensor(k_np[0] * 10.0 ** (np.arange(n_hf) / pr.halofit_k_per_decade),
                           dtype=f64, device=dev)
    min_k_nl = float(pr.halofit_min_k_nonlinear)
    w0_z = torch.full_like(z_arr, -1.0)
    fnu = float(bg.Omega0_ncdm_tot) / float(bg.Omega0_m)

    loga, tau_of_loga = bg.loga.to(dev), bg.tau_of_loga.to(dev)
    tau_q = interp(-torch.log1p(z_arr), loga, tau_of_loga)
    anorm_k = 2.0 * math.pi**2 / k**3 * pm.scalar_pk(k)
    taus = pert.tau
    S_of = {col: pert.sources[:, :, SrcIdx.ix[col]] for col in ("delta_m", "delta_cb")}

    def pk_of(col, tq):
        S = S_of[col].T.contiguous()
        return anorm_k * spline_eval(taus, S, spline_d2(taus, S), tq) ** 2

    pk_lin = pk_of("delta_m", tau_q)          # (nz, nk)
    pk_cb = pk_of("delta_cb", tau_q)
    bgv = bg.lntau_spline.to(dev).eval(torch.log(tau_q))
    Om = bgv[:, bidx["Omega_m"]]
    Ov = 1.0 - Om - bgv[:, bidx["Omega_r"]]

    # ln P splined in ln k onto the halofit grid. The cb ratio uses the sums
    # of the TOTAL spectrum with fnu = 0 (nonlinear.py:475-479), so the scale
    # is found once and serves both.
    lnk = torch.log(k)
    lnp = torch.log(pk_lin).T.contiguous()                       # (nk, nz)
    pk_hf = torch.exp(spline_eval(lnk, lnp, spline_d2(lnk, lnp), torch.log(k_hf))).T.contiguous()
    scale = _halofit_scale(k_hf, pk_hf, min_k_nl)
    args = (Om, Ov, w0_z)
    pk_nl, k_nl = _halofit_ratio(scale, k, pk_lin, *args, fnu, float(bg.Omega0_m),
                                 params.h, min_k_nl)
    pk_cb_nl, k_nl_cb = _halofit_ratio(scale, k, pk_cb, *args, 0.0, float(bg.Omega0_m),
                                       params.h, min_k_nl)
    pk0 = pk_of("delta_m", interp(torch.zeros((), dtype=f64, device=dev), loga, tau_of_loga))
    sigma8 = float(sigma_R(k, pk0, 8.0 / params.h)[0])
    return PkResult(k=k, z=z_arr, pk_lin=pk_lin, pk_nl=pk_nl, pk_cb_lin=pk_cb,
                    pk_cb_nl=pk_cb_nl, k_nl=k_nl, k_nl_cb=k_nl_cb, sigma8=sigma8)

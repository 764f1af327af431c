"""Linear and nonlinear matter power spectra (counterpart of
classpp_public_tpu/models/nonlinear.py: `HMCODE_FEEDBACK` :32, `pk_ic_deltas`
:64, `pair_primordial_pk` :73, `pk_linear_at_z` :82, `sigma_R` :103,
`_halofit_one_z` :112, `_extend_pk` :188, `_sigma_integrals` :211,
`_sigma_disp` :234, `_window_nfw` :246, `_growint` :258, `_hmcode_one_z` :273,
`compute_hmcode` :368, `_halofit_core` :433, `compute_nonlinear` :543).

The linear P(k, tau) comes from sources x primordial (nonlinear_pk_linear,
nonlinear_module.cpp:1886); halofit is Takahashi 2012 with the Bird
massive-neutrino corrections (nonlinear_halofit :2291). sigma^2(R, z) for a
whole log-R grid and all requested redshifts is one call of the Gaussian
window sums, R_nl comes from a monotone inversion and two Newton steps. The
sums are the hand-written CUDA kernel csrc/halofit_sigma.cu on CUDA tensors
(`halofit_sums`) and `halofit_sums_plain` on CPU tensors; the crossing
search, the Newton steps and the closed-form fit are tensor code on (z,) and
(z, k). The Pk_equal method is not ported. In a curved
universe halofit feels Omega_k through Omega_m(z) and Omega_v(z) = 1 -
Omega_m - Omega_r, read from the background columns whose rho_crit carries
the curvature term (nonlinear.py:459-462; the Omega_k terms of
nonlinear.py:390-399 and :505-515 belong to hmcode's dark-energy correction
and Pk_equal).

HMcode-2016 (Mead et al.; nonlinear_hmcode, nonlinear_module.cpp:2811-3258)
runs every redshift of the total and of the cdm + baryon spectrum as the rows
of one batch, where the JAX package vmaps one redshift at a time. Two
hand-written CUDA kernels carry its integrals: the top-hat sigma integrals
(sigma^2, dsigma^2/dR and the displacement sigma_d^2 for every row and
radius: csrc/hmcode_sigma.cu, `hmcode_sigma`) and the NFW one-halo integral
over the mass grid (csrc/hmcode_onehalo.cu, `hmcode_onehalo`), each with its
plain PyTorch version beside it (`hmcode_sigma_plain`,
`hmcode_onehalo_plain`) for CPU tensors. The spectrum's extension, the ln P
splines, the inversion of sigma_cb(r_nl) = delta_c, the Newton polish, the
concentrations and the blend are tensor code around them. The dark-energy
correction of the concentrations (use_fld, nonlinear.py:393-403) waits for the
fluid, which the port refuses (config/params.check_lcdm): `_growint` is here
for it.

With isocurvature modes P(k) sums every correlated pair of initial conditions,
P = 2 pi^2/k^3 sum P_12(k) delta_1 delta_2, the off-diagonal pairs twice
(nonlinear_pk_linear :1886, spectra_module.cpp:305-308); halofit takes one
effective delta with delta_eff^2 = sum P_12/P_ad delta_1 delta_2 and the sign
of delta_ad, folded per (k, tau) before the splines (nonlinear.py:589-612),
and so does its sigma8. HMcode takes the pair sums of `pk_linear_at_z`, as
the JAX package does.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import numpy as np
import torch

from ..ops import cuda
from ..ops.special import si_ci
from ..ops.splines import interp, spline_d2, spline_eval
from .background import tau_of_z
from .perturbations.indices import SrcIdx
from .primordial import PrimordialResult

N_R_GRID = 160   # trial radii of the sigma(R) = 1 search
launches = 0     # halofit_sigma kernel launches (halofit_sums on CUDA tensors)
hmcode_sigma_launches = 0     # hmcode_sigma kernel launches (hmcode_sigma on CUDA tensors)
hmcode_onehalo_launches = 0   # hmcode_onehalo kernel launches (hmcode_onehalo on CUDA tensors)
# elements of one temporary of the plain HMcode integrals (they loop over rows)
PLAIN_CHUNK = 1 << 22

# HMcode baryonic feedback presets (nonlinear_hmcode_baryonic_feedback,
# nonlinear_module.cpp:3424-3474): name -> (eta_0, c_min)
HMCODE_FEEDBACK = {
    "emu_dmonly": (0.603, 3.13),
    "owls_dmonly": (0.64, 3.43),
    "owls_ref": (0.68, 3.91),
    "owls_agn": (0.76, 2.32),
    "owls_dblim": (0.70, 3.01),
}


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


def pk_ic_deltas(pert, bg, z, col: str = "delta_m") -> dict:
    """{ic: delta(k, z)} of every initial condition, "ad" first."""
    return {ic: _delta_at_z(pert, src, bg, z, col)
            for ic, src in {"ad": pert.sources, **(pert.sources_iso or {})}.items()}


def pair_primordial_pk(pm: PrimordialResult, n1, n2, k):
    """The primordial spectrum of the pair (n1, n2); None when uncorrelated."""
    if n1 == "ad" and n2 == "ad":
        return pm.scalar_pk(k)
    if n1 == n2:
        return pm.iso_pk(n1, k)
    return pm.cross_pk(n1, n2, k)


def _pairs(names):
    """(n1, n2, factor) of each pair of `names` with n1 not after n2, in the
    JAX package's order; factor 2 off the diagonal."""
    return [(n1, names[i2], 1.0 if i1 == i2 else 2.0)
            for i1, n1 in enumerate(names) for i2 in range(i1, len(names))]


def pk_linear_at_z(pert, bg, pm: PrimordialResult, z, col: str = "delta_m") -> torch.Tensor:
    """P(k, z) = 2 pi^2 / k^3 P_R(k) delta(k, z)^2, delta splined in tau; with
    isocurvature modes the sum over the correlated pairs."""
    k = pert.k
    if not pert.sources_iso:
        delta = _delta_at_z(pert, pert.sources, bg, z, col)
        return 2.0 * math.pi**2 / k**3 * pm.scalar_pk(k) * delta**2
    ds = pk_ic_deltas(pert, bg, z, col)
    total = torch.zeros_like(k)
    for n1, n2, f in _pairs(list(ds)):
        pk12 = pair_primordial_pk(pm, n1, n2, k)
        if pk12 is not None:
            total = total + f * pk12 * ds[n1] * ds[n2]
    return 2.0 * math.pi**2 / k**3 * total


def halofit_delta(pert, pm: PrimordialResult, col: str) -> torch.Tensor:
    """(nk, ntau) the delta halofit reads: the source column, or with
    isocurvature modes sign(delta_ad) sqrt(max(sum_pairs P_12/P_ad delta_1
    delta_2, 0)) (nonlinear.py:589-612)."""
    S = pert.sources[:, :, SrcIdx.ix[col]]
    if not pert.sources_iso:
        return S
    d = {"ad": S, **{ic: src[:, :, SrcIdx.ix[col]] for ic, src in pert.sources_iso.items()}}
    p_ad = pm.scalar_pk(pert.k)
    tot = torch.zeros_like(S)
    for n1, n2, f in _pairs(list(d)):
        p12 = pair_primordial_pk(pm, n1, n2, pert.k)
        if p12 is not None:
            tot = tot + f * (p12 / p_ad)[:, None] * d[n1] * d[n2]
    return torch.sign(S) * torch.sqrt(torch.clamp(tot, min=0.0))


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
    global launches
    if base.device.type == "cpu":
        return halofit_sums_plain(base, k, R)
    if base.device.type != "cuda":
        raise ValueError(f"halofit_sums: unsupported device {base.device}")
    nz, nk = base.shape
    if k.shape != (nk,) or R.dim() != 2 or R.shape[0] != nz:
        raise ValueError(f"halofit_sums: bad shapes base{tuple(base.shape)} k{tuple(k.shape)} "
                         f"R{tuple(R.shape)}")
    for name, t in (("base", base), ("k", k), ("R", R)):
        if t.dtype != torch.float64 or not t.is_contiguous() or t.device != base.device:
            raise ValueError(f"halofit_sums: {name} must be contiguous float64 on {base.device}")
    out = torch.empty((nz, R.shape[1], 3), dtype=torch.float64, device=base.device)
    err = cuda.library().halofit_sigma_launch(
        base.data_ptr(), k.data_ptr(), R.data_ptr(), nz, nk, R.shape[1], out.data_ptr(),
        cuda.stream_ptr(base.device))
    cuda.check(err, "halofit_sigma")
    launches += 1
    return out


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


def _trapz(y: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """The trapezoid rule along the last axis as numpy.trapezoid sums it; x
    broadcasts against y."""
    return 0.5 * (torch.diff(x, dim=-1) * (y[..., 1:] + y[..., :-1])).sum(-1)


def _extend_pk(k: torch.Tensor, pk_z: torch.Tensor, pm: PrimordialResult, k_max_extra: float,
               per_decade: float = 10.0, k_np=None):
    """The linear P(k) continued beyond the source k_max, HMcode style
    (nonlinear.py:188; nonlinear_get_source extrap_max_scaled,
    nonlinear_module.cpp:1750-1835): the source S(k) = S_max ln(a k) / ln(a
    k_max), a fixed by the last two tabulated points, with the primordial
    spectrum analytic, on a log tail of per_decade points a decade up to
    k_max_extra. pk_z (..., nk); k_np: the host copy of k, which sets the tail
    length. Returns (k_ext, pk_ext) with k_ext = [k, tail]."""
    k_last = float(k_np[-1]) if k_np is not None else float(k[-1])
    n_extra = int(math.log10(k_max_extra / k_last) * per_decade) + 1
    k_tail = torch.as_tensor(np.asarray(k_last) * 10.0 ** ((np.arange(n_extra) + 1.0) / per_decade),
                             dtype=k.dtype, device=k.device)
    anorm = 1.0 / (2.0 * math.pi**2)
    # |S| on the last two points: P = 2 pi^2 / k^3 P_R S^2
    S = torch.sqrt(pk_z[..., -2:] * k[-2:] ** 3 * anorm / pm.scalar_pk(k[-2:]))
    s_prev, s_max = S[..., 0:1], S[..., 1:2]
    lnk_max, lnk_prev = torch.log(k[-1]), torch.log(k[-2])
    ln_a = (s_prev * lnk_max - s_max * lnk_prev) / (s_max - s_prev)
    S_tail = s_max * (ln_a + torch.log(k_tail)) / (ln_a + lnk_max)
    pk_tail = S_tail**2 * pm.scalar_pk(k_tail) / (k_tail**3 * anorm)
    return torch.cat([k, k_tail]), torch.cat([pk_z, pk_tail], dim=-1)


def _tophat(x: torch.Tensor):
    """The top-hat window W(x) = 3 (sin x - x cos x) / x^3 and W'(x), with the
    series W = 1 - x^2/10, W' = -x/5 below x = 0.01 (nonlinear.py:219-226)."""
    small = x < 0.01
    xs = torch.where(small, 1.0, x)
    W = torch.where(small, 1.0 - x * x / 10.0, 3.0 / xs**3 * (torch.sin(x) - x * torch.cos(x)))
    Wp = torch.where(small, -0.2 * x,
                     3.0 / xs**2 * torch.sin(x) - 9.0 / xs**4 * (torch.sin(x) - x * torch.cos(x)))
    return W, Wp


def hmcode_sigma_plain(base: torch.Tensor, k: torch.Tensor, lnk: torch.Tensor,
                       R: torch.Tensor) -> torch.Tensor:
    """Plain version of the HMcode sigma integrals (nonlinear.py:211-243).
    base (nspec, nk) = k^3 P(k) / (2 pi^2) on the log grid k = exp(lnk) (nk,);
    R (nspec, nR). Returns (nspec, nR, 3): sigma^2 = int base W^2 dln k,
    dsigma^2/dR = int base 2 k W W' dln k, sigma_d^2 = int base / k^2 / 3 W^2
    dln k, each by the trapezoid rule in ln k."""
    per = max(1, PLAIN_CHUNK // max(1, R.shape[1] * k.shape[0]))
    out = []
    for i in range(0, base.shape[0], per):
        b = base[i:i + per, None, :]
        W, Wp = _tophat(k[None, None, :] * R[i:i + per, :, None])
        out.append(torch.stack([_trapz(b * W * W, lnk),
                                _trapz(b * 2.0 * k * W * Wp, lnk),
                                _trapz(b / k**2 / 3.0 * W * W, lnk)], dim=-1))
    return torch.cat(out)


def hmcode_sigma(base: torch.Tensor, k: torch.Tensor, lnk: torch.Tensor,
                 R: torch.Tensor) -> torch.Tensor:
    """The HMcode sigma integrals: CUDA kernel (one block per (spectrum, R))
    for CUDA tensors, plain version for CPU tensors. Shapes as
    `hmcode_sigma_plain`."""
    global hmcode_sigma_launches
    if base.device.type == "cpu":
        return hmcode_sigma_plain(base, k, lnk, R)
    if base.device.type != "cuda":
        raise ValueError(f"hmcode_sigma: unsupported device {base.device}")
    nspec, nk = base.shape
    if k.shape != (nk,) or lnk.shape != (nk,) or R.dim() != 2 or R.shape[0] != nspec:
        raise ValueError(f"hmcode_sigma: bad shapes base{tuple(base.shape)} k{tuple(k.shape)} "
                         f"lnk{tuple(lnk.shape)} R{tuple(R.shape)}")
    for name, t in (("base", base), ("k", k), ("lnk", lnk), ("R", R)):
        if t.dtype != torch.float64 or not t.is_contiguous() or t.device != base.device:
            raise ValueError(f"hmcode_sigma: {name} must be contiguous float64 on {base.device}")
    out = torch.empty((nspec, R.shape[1], 3), dtype=torch.float64, device=base.device)
    err = cuda.library().hmcode_sigma_launch(
        base.data_ptr(), k.data_ptr(), lnk.data_ptr(), R.data_ptr(), nspec, nk, R.shape[1],
        out.data_ptr(), cuda.stream_ptr(base.device))
    cuda.check(err, "hmcode_sigma")
    hmcode_sigma_launches += 1
    return out


def _window_nfw(kx, rv, c):
    """Fourier transform of the NFW profile (nonlinear.py:246;
    nonlinear_hmcode_window_nfw, nonlinear_module.cpp:3718-3765), analytic in
    Si and Ci; the JAX expression, whose terms cancel at small ks."""
    ks = kx * rv / c
    si1, ci1 = si_ci(ks)
    si2, ci2 = si_ci(ks * (1.0 + c))
    p1 = torch.cos(ks) * (ci2 - ci1)
    p2 = torch.sin(ks) * (si2 - si1)
    p3 = torch.sin(ks * c) / (ks * (1.0 + c))
    return (p1 + p2 - p3) / (torch.log(1.0 + c) - c / (1.0 + c))


def hmcode_onehalo_plain(nu: torch.Tensor, m: torch.Tensor, rv: torch.Tensor,
                         conc: torch.Tensor, eta: torch.Tensor, k: torch.Tensor) -> torch.Tensor:
    """Plain version of the one-halo integral (nonlinear.py:349-358): for
    every row and k, the trapezoid in nu of m g_ST(nu) W_NFW(nu^eta k, r_v,
    c)^2, the nodes with nu > 10 set to 0. nu, rv, conc (nrow, nm); m (nm,);
    eta (nrow,); k (nk,). Returns (nrow, nk)."""
    per = max(1, PLAIN_CHUNK // max(1, k.shape[0] * m.shape[0]))
    out = []
    for i in range(0, nu.shape[0], per):
        n = nu[i:i + per, None, :]
        gst = 0.21616 * (1.0 + (0.707 * n * n) ** -0.3) * torch.exp(-0.707 * n * n / 2.0)
        kx = n ** eta[i:i + per, None, None] * k[None, :, None]
        Wn = _window_nfw(kx, rv[i:i + per, None, :], conc[i:i + per, None, :])
        integ = torch.where(n <= 10.0, m * gst * Wn * Wn, 0.0)
        out.append(_trapz(integ, n))
    return torch.cat(out)


def hmcode_onehalo(nu: torch.Tensor, m: torch.Tensor, rv: torch.Tensor, conc: torch.Tensor,
                   eta: torch.Tensor, k: torch.Tensor) -> torch.Tensor:
    """The one-halo integral: CUDA kernel (one block per (row, k)) for CUDA
    tensors, plain version for CPU tensors. Shapes as `hmcode_onehalo_plain`."""
    global hmcode_onehalo_launches
    if nu.device.type == "cpu":
        return hmcode_onehalo_plain(nu, m, rv, conc, eta, k)
    if nu.device.type != "cuda":
        raise ValueError(f"hmcode_onehalo: unsupported device {nu.device}")
    nrow, nm = nu.shape
    if (m.shape != (nm,) or rv.shape != nu.shape or conc.shape != nu.shape
            or eta.shape != (nrow,) or k.dim() != 1):
        raise ValueError(f"hmcode_onehalo: bad shapes nu{tuple(nu.shape)} m{tuple(m.shape)} "
                         f"rv{tuple(rv.shape)} conc{tuple(conc.shape)} eta{tuple(eta.shape)} "
                         f"k{tuple(k.shape)}")
    for name, t in (("nu", nu), ("m", m), ("rv", rv), ("conc", conc), ("eta", eta), ("k", k)):
        if t.dtype != torch.float64 or not t.is_contiguous() or t.device != nu.device:
            raise ValueError(f"hmcode_onehalo: {name} must be contiguous float64 on {nu.device}")
    out = torch.empty((nrow, k.shape[0]), dtype=torch.float64, device=nu.device)
    err = cuda.library().hmcode_onehalo_launch(
        nu.data_ptr(), m.data_ptr(), rv.data_ptr(), conc.data_ptr(), eta.data_ptr(),
        k.data_ptr(), nrow, nm, k.shape[0], out.data_ptr(), cuda.stream_ptr(nu.device))
    cuda.check(err, "hmcode_onehalo")
    hmcode_onehalo_launches += 1
    return out


def _growint(Omega0_m, Omega0_k, Omega0_de, w0, wa) -> float:
    """Linder & Cahn 2007 approximate growth D = exp(-int Omega_m(a)^gamma dln a)
    from a = 1/11 to 1 (nonlinear.py:258; nonlinear_hmcode_growint,
    nonlinear_module.cpp:3623-3712), on a 1024-point a grid. For the
    dark-energy correction of the concentrations, which the fluid slice
    connects."""
    a = torch.linspace(1.0 / 11.0, 1.0, 1024, dtype=torch.float64)
    z = 1.0 / a - 1.0
    X_de = a ** (-3.0 * (1.0 + w0 + wa)) * torch.exp(-3.0 * wa * (1.0 - a))
    H2 = Omega0_m * (1.0 + z) ** 3 + Omega0_k * (1.0 + z) ** 2 + Omega0_de * X_de
    Om = Omega0_m * (1.0 + z) ** 3 / H2
    gamma = 0.55 if w0 == -1.0 else (0.55 + 0.02 * (1.0 + w0) if w0 < -1.0
                                     else 0.55 + 0.05 * (1.0 + w0))
    return float(torch.exp(_trapz(-(Om**gamma) / a, a)))


def compute_hmcode(pert, bg, bidx, pm: PrimordialResult, pr, params, z_pk=(0.0,),
                   eta_0: float = 0.603, c_min: float = 3.13) -> PkResult:
    """HMcode-2016 P(k, z) at every z of z_pk, total and cdm + baryon
    (`compute_hmcode`, nonlinear.py:368-430, and `_hmcode_one_z` :273-365),
    every redshift of both spectra one row of a batch. A total row corrects
    P_m with f_nu = Omega_ncdm / Omega_m and Omega0_m; a cb row corrects P_cb
    with f_nu = 0 and Omega0_cb (Omega0_m without ncdm); both find r_nl on
    the cb spectrum (nonlinear.py:417-420). The sigma integrals run through
    `hmcode_sigma` (one launch for every row's radii, one for each of the two
    Newton steps and one at r_nl), the one-halo integral through
    `hmcode_onehalo` (one launch); sigma8 is `sigma_R` on the source k grid."""
    if params.use_fld:
        raise NotImplementedError(
            "HMcode with a dark-energy fluid is not ported "
            "(classpp_public_tpu/models/nonlinear.py:393-403)")
    k = pert.k
    dev, f64 = k.device, k.dtype
    k_np = pert.k_np if pert.k_np is not None else k.cpu().numpy()
    z_np = np.atleast_1d(np.asarray(z_pk, dtype=np.float64))
    nz = len(z_np)
    z_arr = torch.as_tensor(z_np, device=dev)
    anorm = 1.0 / (2.0 * math.pi**2)
    h = float(params.h)
    pk_lin = pk_linear_at_z(pert, bg, pm, torch.as_tensor(z_np), "delta_m")
    pk_cb = pk_linear_at_z(pert, bg, pm, torch.as_tensor(z_np), "delta_cb")

    # growth table D(z) on a linear a grid (nonlinear_hmcode_fill_growtab :3573),
    # and Omega_m(z), D(z) at the requested redshifts, from the background
    spl = bg.lntau_spline.to(dev)
    a_g = torch.linspace(pr.ainit_for_growtab, pr.amax_for_growtab, pr.n_hmcode_tables,
                         dtype=f64, device=dev)
    z_g = 1.0 / a_g - 1.0
    growtable = spl.eval(torch.log(tau_of_z(bg, z_g).to(dev)))[:, bidx["D"]].contiguous()
    bgv = spl.eval(torch.log(tau_of_z(bg, z_arr).to(dev)))
    Om_z, D_z = bgv[:, bidx["Omega_m"]], bgv[:, bidx["D"]]
    fnu = float(bg.Omega0_ncdm_tot) / float(bg.Omega0_m)
    Om0 = float(bg.Omega0_m)
    Om0_cb = Om0 - float(bg.Omega0_ncdm_tot) if float(bg.Omega0_ncdm_tot) else Om0

    # the rows: every z of the total spectrum, then every z of the cb one
    def rows(a, b):
        return torch.as_tensor([a] * nz + [b] * nz, dtype=f64, device=dev)

    target = torch.cat([pk_lin, pk_cb])                        # (nrow, nk)
    fnu_r, om_eff = rows(fnu, 0.0), rows(Om0, Om0_cb)
    D_r, z_r, Om_r = D_z.repeat(2), z_arr.repeat(2), Om_z.repeat(2)
    nrow = 2 * nz

    # the extended spectra (target rows, then the cb spectrum of every row),
    # ln P splined in ln k onto sigma_k_per_decade points a decade
    k_ext, pk_ext = _extend_pk(k, torch.cat([target, pk_cb, pk_cb]), pm, pr.hmcode_max_k_extra,
                               k_np=k_np)
    n_s = int(math.log10(pr.hmcode_max_k_extra / float(k_np[0])) * pr.sigma_k_per_decade) + 1
    lnk_s = torch.log(k[0]) + torch.arange(n_s, dtype=f64, device=dev) \
        / pr.sigma_k_per_decade * math.log(10.0)
    lnk_ext = torch.log(k_ext)
    lnp = torch.log(pk_ext).T.contiguous()
    pk_s = torch.exp(spline_eval(lnk_ext, lnp, spline_d2(lnk_ext, lnp), lnk_s)).T
    k_s = torch.exp(lnk_s)
    base = (k_s[None, :] ** 3 * pk_s * anorm).contiguous()     # (2 nrow, n_s)

    # every row's radii: 8/h (sigma8), 1e-12 and 100/h (sigma_d), the mass
    # grid's r (nu, and the cb inversion) and f^(1/3) r (the formation z)
    nm = pr.nsteps_for_p1h_integral
    rho_crit = 2.7754e11 * h * h            # M_sun / Mpc^3
    m = torch.exp(torch.linspace(math.log(pr.mmin_for_p1h_integral / h),
                                 math.log(pr.mmax_for_p1h_integral / h), nm, dtype=f64,
                                 device=dev))
    r_real = (3.0 * m / (4.0 * math.pi * rho_crit * om_eff[:, None])) ** (1.0 / 3.0)
    fraction = 0.01 ** (1.0 / 3.0)
    fixed = torch.as_tensor([8.0 / h, 1e-12, 100.0 / h], dtype=f64, device=dev)
    R = torch.cat([fixed.expand(nrow, 3), r_real, r_real * fraction], dim=1)
    sig = hmcode_sigma(base, k_s, lnk_s, torch.cat([R, R]).contiguous())
    t, c = sig[:nrow], sig[nrow:]
    sigma8 = torch.sqrt(t[:, 0, 0])
    sigma_disp, sigma_disp100 = torch.sqrt(t[:, 1, 2]), torch.sqrt(t[:, 2, 2])
    sigma_r = torch.sqrt(t[:, 3:3 + nm, 0])
    sigmaf_r = torch.sqrt(t[:, 3 + nm:, 0])
    sig_cb = torch.sqrt(c[:, 3:3 + nm, 0])

    # spherical-collapse thresholds (ref :2973-2981)
    delta_c = 1.59 + 0.0314 * torch.log(sigma8)
    delta_c = delta_c * (1.0 + 0.0123 * torch.log10(Om_r))
    delta_c = delta_c * (1.0 + 0.262 * fnu_r)
    Delta_v = 418.0 * Om_r ** (-0.352) * (1.0 + 0.916 * fnu_r)
    r_virial = r_real / Delta_v[:, None] ** (1.0 / 3.0)
    nu = delta_c[:, None] / sigma_r

    # the nonlinear scale sigma_cb(r_nl) = delta_c: the monotone inversion of
    # ln sigma_cb on the mass grid, two Newton steps, then n_eff at r_nl
    base_cb = base[nrow:]
    r_nl = torch.exp(_interp_rows(torch.log(delta_c), -torch.log(sig_cb), torch.log(r_real)))
    for _ in range(2):
        o = hmcode_sigma(base_cb, k_s, lnk_s, r_nl[:, None].contiguous())[:, 0]
        s = torch.sqrt(o[:, 0])
        f = torch.log(s / delta_c)
        fp = r_nl * o[:, 1] / (2.0 * s * s)     # dln sigma / dln R
        r_nl = r_nl * torch.exp(-f / fp)
    k_nl = 1.0 / r_nl
    o = hmcode_sigma(base_cb, k_s, lnk_s, r_nl[:, None].contiguous())[:, 0]
    s_nl = torch.sqrt(o[:, 0])
    n_eff = -3.0 - r_nl * o[:, 1] / (s_nl**2)
    alpha = 3.24 * 1.85**n_eff

    # halo concentrations, Bullock et al. (ref :3143-3165)
    g_form = torch.clamp(delta_c[:, None] * D_r[:, None] / sigmaf_r, max=1.0)
    z_form = interp(g_form, growtable, z_g)
    conc = torch.where(z_form < z_r[:, None], c_min, c_min * (1.0 + z_form) / (1.0 + z_r[:, None]))

    # damping (ref :3168-3174), the one-halo term, the two-halo term and the blend
    eta = eta_0 - 0.3 * sigma8
    k_star = 0.584 / sigma_disp
    fdamp = torch.clamp(0.0095 * (sigma_disp100 * h) ** 1.37, 1e-3, 0.99)
    p1h = hmcode_onehalo(nu.contiguous(), m, r_virial.contiguous(), conc.contiguous(),
                         eta.contiguous(), k)
    y2 = (k[None, :] / k_star[:, None]) ** 2
    fac = torch.where(y2 > 7.0, 0.0, torch.exp(-y2))
    pk_1h = p1h * anorm * k**3 * (1.0 - fac) / (rho_crit * om_eff[:, None])
    pk_2h = target * k**3 * anorm * (1.0 - fdamp[:, None] * torch.tanh(
        k * sigma_disp[:, None] / torch.sqrt(fdamp)[:, None]) ** 2)
    pk_2h = torch.clamp(pk_2h, min=0.0)
    a_col = alpha[:, None]
    pk_nl = (pk_1h**a_col + pk_2h**a_col) ** (1.0 / a_col) / k**3 / anorm

    pk0 = pk_linear_at_z(pert, bg, pm, 0.0, "delta_m")
    sigma8_0 = float(sigma_R(k, pk0, 8.0 / h)[0])
    return PkResult(k=k, z=z_arr, pk_lin=pk_lin, pk_nl=pk_nl[:nz], pk_cb_lin=pk_cb,
                    pk_cb_nl=pk_nl[nz:], k_nl=k_nl[:nz], k_nl_cb=k_nl[nz:], sigma8=sigma8_0)


def compute_nonlinear(pert, bg, bidx, pm: PrimordialResult, pr, params, z_pk=(0.0,),
                      method: str = "halofit", hm_eta0: float = 0.603, hm_cmin: float = 3.13,
                      tau_rec=None) -> PkResult:
    """Linear and nonlinear P(k, z) at every z of z_pk, total and cdm+baryon,
    with k_nl and sigma8: halofit (the whole of `_halofit_core`,
    nonlinear.py:443-487) or, with method "hmcode", `compute_hmcode` with the
    feedback parameters eta_0 = hm_eta0 and c_min = hm_cmin."""
    if method == "hmcode":
        return compute_hmcode(pert, bg, bidx, pm, pr, params, z_pk=z_pk, eta_0=hm_eta0,
                              c_min=hm_cmin)
    if method != "halofit":
        raise ValueError(f"unknown non linear method {method!r} (halofit, hmcode)")
    if params.pk_eq and params.use_fld:
        raise NotImplementedError(
            "the Pk_equal method is not ported (classpp_public_tpu/models/nonlinear.py:494)")
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
    S_of = {col: halofit_delta(pert, pm, col) for col in ("delta_m", "delta_cb")}

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

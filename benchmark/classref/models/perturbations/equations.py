"""Scalar perturbation equations, batched over lanes: RHS, the stiff
(Thomson) split, adiabatic initial conditions, approximation
remaps and the source functions.

Counterpart of classpp_public_tpu/models/perturbations/equations.py
(`PertCtx` :134, `rhs_full` :225, `stiff_apply` :1017, `stiff_solve` :1057,
`adiabatic_ic` :1109, `initial_conditions` :1412,
`remap_tca_off` :1421, `remap_ufa_on` :1448, `remap_ncdmfa_on` :1456,
`remap_rsa_on` :1482, `compute_sources` :1501), restricted to what the
benchmark's cells run: adiabatic initial conditions in the synchronous gauge,
photons, polarization, baryons, cdm, massless neutrinos, massive neutrinos
(ncdm: the Psi_l(q) hierarchy on a shared momentum grid, or its fluid
approximation) and the metric. The curvature enters through the
free-streaming factors s_l = sqrt(1 - K (l^2 - 1)/k^2), s2 = 1 - 3 K/k^2 and
cotKgen = sqrt|K| cot_K(sqrt|K| tau)/k (`curvature`); in a flat universe
s_l = s2 = 1 exactly and cotKgen = 1/(k tau). In the synchronous gauge
metric_euler is 0, which the equations leave out, and metric_ufa equals
metric_continuity.

Every function takes the state as (L, n): one row per lane (k mode), each
with its own time, wavenumber and approximation flags. The tables are read
once per stage time through `frame_at`.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import torch

from ..thermodynamics import ThIdx
from .indices import PtIdx, SrcIdx

# table columns read by the equations, in Frame order
BG_COLS = ("a", "H", "H_prime", "rho_g", "rho_b", "rho_cdm", "rho_ur",
           "rho_tot", "p_tot", "p_tot_prime")
TH_COLS = ("dkappa", "ddkappa", "g", "dg", "exp_m_kappa", "cb2")


class NcdmCtx(NamedTuple):
    """ncdm phase-space data on the shared momentum grid (equations.py:34).
    eps(q, a) = sqrt(q^2 + (a m/T0)^2), q in units of T_ncdm0;
    rho_s = pref_s / a^4 sum_q w_q q^2 eps."""

    q: torch.Tensor       # (nq,) shared momentum nodes
    w: torch.Tensor       # (ns, nq) per-species weights including f0(q)
    dlnf0: torch.Tensor   # (ns, nq) dln f0 / dln q
    x_fac: torch.Tensor   # (ns,) m/T_ncdm0
    pref: torch.Tensor    # (ns,) normalisation (class units, Mpc^-2)

    def to(self, device) -> "NcdmCtx":
        return NcdmCtx(*(v.to(device) for v in self))


class PertTables(NamedTuple):
    """Background and thermodynamics runtime splines restricted to the
    columns the equations read (BG_COLS then rho, p, pseudo_p of each ncdm
    species; TH_COLS). Column-wise splines, so restricting the columns is
    exact."""

    bg: object    # UniformSpline over ln(tau)
    th: object    # UniformSpline over ln(tau)
    idx: PtIdx
    ncdm: NcdmCtx = None   # when idx.n_ncdm > 0
    K: float = 0.0         # spatial curvature [Mpc^-2] = -Omega_k H0^2; sign idx.sgnK


class Frame(NamedTuple):
    """Table values at one time per lane."""

    tau: torch.Tensor
    a: torch.Tensor
    H: torch.Tensor
    Hp: torch.Tensor
    rho_g: torch.Tensor
    rho_b: torch.Tensor
    rho_cdm: torch.Tensor
    rho_ur: torch.Tensor
    rho_tot: torch.Tensor
    p_tot: torch.Tensor
    p_tot_prime: torch.Tensor
    kap: torch.Tensor
    kapp: torch.Tensor
    g: torch.Tensor
    dg: torch.Tensor
    emk: torch.Tensor
    cb2: torch.Tensor
    rho_nc: torch.Tensor = None   # (L, ns) per ncdm species
    p_nc: torch.Tensor = None
    pp_nc: torch.Tensor = None


def make_tables(bg, bidx, th, idx: PtIdx, ncdm: NcdmCtx = None, K: float = 0.0) -> PertTables:
    """Restrict the runtime splines to BG_COLS (+ ncdm columns) / TH_COLS."""
    bi = [bidx[n] for n in BG_COLS]
    for i in range(idx.n_ncdm):
        bi += [bidx[f"rho_ncdm{i}"], bidx[f"p_ncdm{i}"], bidx[f"pseudo_p_ncdm{i}"]]
    ti = [ThIdx.ix[n] for n in TH_COLS]
    b, t = bg.lntau_spline, th.lntau_spline
    return PertTables(
        bg=b._replace(y=b.y[:, bi].contiguous(), y2=b.y2[:, bi].contiguous()),
        th=t._replace(y=t.y[:, ti].contiguous(), y2=t.y2[:, ti].contiguous()),
        idx=idx, ncdm=ncdm, K=K)


def frame_at(tau: torch.Tensor, tables: PertTables) -> Frame:
    lntau = torch.log(tau)
    bgv = tables.bg.eval(lntau)
    thv = tables.th.eval(lntau).unbind(-1)
    nb, idx = len(BG_COLS), tables.idx
    ne = nb + 3 * idx.n_ncdm
    nc = bgv[:, nb:ne].reshape(bgv.shape[0], -1, 3).unbind(-1) if idx.n_ncdm else (None,) * 3
    return Frame(tau, *bgv[:, :nb].unbind(-1), *thv, *nc)


class PertCtx(NamedTuple):
    """Per-lane data fixed during one step: wavenumber, approximation flags
    at the step's start time, the eta storage offset (low-k adiabatic
    lanes store eta - 1 so its deviation keeps full relative precision) and
    the lanes' k-only factors."""

    k: torch.Tensor
    tca_on: torch.Tensor   # bool
    rsa_on: torch.Tensor
    ufa_on: torch.Tensor
    eta_off: torch.Tensor
    tables: PertTables
    ncdmfa_on: torch.Tensor = None   # ncdm fluid approximation (bool)
    kf: "KFactors" = None            # the lanes' k-only factors (k_factors), or computed per call


def _ncdm_moments(fr: Frame, y: torch.Tensor, ctx: PertCtx):
    """Psi (L, ns, nq, nl), eps (L, ns, nq), fac (L, ns) and the exact
    momentum sums (rho delta, (rho+p) theta, (rho+p) shear, delta p), each
    (L, ns) (perturb_total_stress_energy :6347-6395)."""
    idx, nc = ctx.tables.idx, ctx.tables.ncdm
    ns, nq, nl = idx.n_ncdm, idx.q_size_ncdm, idx.n_l_ncdm
    Psi = y[:, idx.ncdm: idx.ncdm + idx.n_ncdm_block].reshape(-1, ns, nq, nl)
    a = fr.a
    eps = torch.sqrt(nc.q[None, None, :] ** 2 + (a[:, None, None] * nc.x_fac[None, :, None]) ** 2)
    fac = nc.pref[None, :] / (a * a * a * a)[:, None]
    q = nc.q[None, None, :]
    qw = (nc.w * nc.q[None, :] ** 2)[None]
    rho_delta = fac * torch.sum(qw * eps * Psi[..., 0], dim=-1)
    rpt = ctx.k[:, None] * fac * torch.sum(qw * q * Psi[..., 1], dim=-1)
    rps = 2.0 / 3.0 * fac * torch.sum(qw * q**2 / eps * Psi[..., 2], dim=-1)
    dp = fac / 3.0 * torch.sum(qw * q**2 / eps * Psi[..., 0], dim=-1)
    return Psi, eps, fac, (rho_delta, rpt, rps, dp)


def _w(cond, a, b):
    return torch.where(cond, a, b)


class Hierarchy(NamedTuple):
    """The k-only factors of one hierarchy's free streaming over its
    multipoles l, per lane (L, nl): s_l, s_{l+1}, l s_l, (l + 1) s_{l+1} and
    k/(2 l + 1) (for ncdm, whose factor is q k/eps, 2 l + 1 alone)."""

    sl: torch.Tensor
    sl1: torch.Tensor
    lo: torch.Tensor
    hi: torch.Tensor
    kd: torch.Tensor


class KFactors(NamedTuple):
    """The factors of the equations that depend on k alone, per lane
    (equations.py:257-272; perturb_workspace :2532 s_l, :5856 s2_squared): s2
    = s_l[2]^2 = 1 - 3 K/k^2, s_l2, s_l3, and each hierarchy's, with s_l =
    sqrt(max(1 - K (l^2 - 1)/k^2, 0)). The plain integrator computes them
    once for its lanes (`k_factors`), not at every right-hand side; each is
    the expression it stands for, so that it rounds alike."""

    s2: torch.Tensor
    s_l2: torch.Tensor
    s_l3: torch.Tensor
    g: Hierarchy           # photons, l = 3..l_max_g
    p: Hierarchy           # polarization, l = 0..l_max_pol_g
    u: Hierarchy           # massless neutrinos, l = 3..l_max_ur
    n: Hierarchy = None    # ncdm, l = 0..l_max_ncdm


def _s_of_l(k2: torch.Tensor, K: float):
    """l -> s_l = sqrt(max(1 - K (l^2 - 1)/k^2, 0)) per lane, (L, nl)."""
    def s_of_l(lv):
        return torch.sqrt(torch.clamp(1.0 - K * (lv * lv - 1.0) / k2[:, None], min=0.0))
    return s_of_l


def k_factors(k: torch.Tensor, K: float, idx: PtIdx) -> KFactors:
    k2 = k * k
    s_of_l = _s_of_l(k2, K)

    def hier(l0, l1, ncdm=False):
        lv = torch.arange(l0, l1 + 1, dtype=k.dtype, device=k.device)
        sl, sl1 = s_of_l(lv), s_of_l(lv + 1.0)
        return Hierarchy(sl, sl1, lv * sl, (lv + 1.0) * sl1,
                         2.0 * lv + 1.0 if ncdm else k[:, None] / (2.0 * lv + 1.0))

    s2 = 1.0 - 3.0 * K / k2
    return KFactors(s2, torch.sqrt(torch.clamp(s2, min=0.0)),
                    torch.sqrt(torch.clamp(1.0 - K * 8.0 / k2, min=0.0)),
                    hier(3, idx.l_max_g), hier(0, idx.l_max_pol_g), hier(3, idx.l_max_ur),
                    hier(0, idx.n_l_ncdm - 1, True) if idx.n_ncdm else None)


def cot_kgen(k: torch.Tensor, tau: torch.Tensor, K: float, sgnK: int) -> torch.Tensor:
    """sqrt|K| cot_K(sqrt|K| tau) / k per lane (perturb_workspace :7966);
    1/(k tau) when flat."""
    if sgnK == 0:
        return 1.0 / (k * tau)
    sab = math.sqrt(abs(K))
    tanK = torch.tan(sab * tau) if sgnK > 0 else torch.tanh(sab * tau)
    return sab / (k * tanK)


class Curvature(NamedTuple):
    """The curvature factors at (k, tau) per lane, with s_l as a function of
    l (the tensor integrator's hierarchies)."""

    s2: torch.Tensor
    s_of_l: object
    s_l2: torch.Tensor
    s_l3: torch.Tensor
    cotKgen: torch.Tensor


def curvature(k: torch.Tensor, tau: torch.Tensor, K: float, sgnK: int) -> Curvature:
    k2 = k * k
    s2 = 1.0 - 3.0 * K / k2
    return Curvature(s2, _s_of_l(k2, K), torch.sqrt(torch.clamp(s2, min=0.0)),
                     torch.sqrt(torch.clamp(1.0 - K * 8.0 / k2, min=0.0)),
                     cot_kgen(k, tau, K, sgnK))


def _kf(ctx: PertCtx) -> KFactors:
    return ctx.kf if ctx.kf is not None else k_factors(ctx.k, ctx.tables.K, ctx.tables.idx)


def rhs_full(fr: Frame, y: torch.Tensor, ctx: PertCtx, want_loc: bool = True):
    """dy/dtau (L, n) plus the local quantities the sources need (None
    without `want_loc`: what only they read is then not computed)."""
    idx = ctx.tables.idx
    k = ctx.k
    k2 = k * k
    tau = fr.tau
    a, H, Hp = fr.a, fr.H, fr.Hp
    rho_g, rho_b, rho_cdm, rho_ur = fr.rho_g, fr.rho_b, fr.rho_cdm, fr.rho_ur
    kap, kapp, cb2 = fr.kap, fr.kapp, fr.cb2
    a2 = a * a
    aH = a * H
    app_a = Hp * a + 2.0 * aH * aH
    aH_prime = Hp * a + aH * aH
    R = 4.0 / 3.0 * rho_g / rho_b
    K = ctx.tables.K
    kf = _kf(ctx)
    s2, s_l2, s_l3 = kf.s2, kf.s_l2, kf.s_l3
    cotKgen = cot_kgen(k, tau, K, idx.sgnK)
    tca, rsa, ufa = ctx.tca_on, ctx.rsa_on, ctx.ufa_on
    zero = torch.zeros_like(k)

    delta_g = y[:, idx.delta_g]
    theta_g = y[:, idx.theta_g]
    shear_g = y[:, idx.shear_g]
    F_g = y[:, idx.F_g: idx.F_g + idx.n_F_g]
    G = y[:, idx.G_g: idx.G_g + idx.n_G_g]
    delta_b = y[:, idx.delta_b]
    theta_b = y[:, idx.theta_b]
    delta_cdm = y[:, idx.delta_cdm]
    delta_ur = y[:, idx.delta_ur]
    theta_ur = y[:, idx.theta_ur]
    shear_ur = y[:, idx.shear_ur]
    F_ur = y[:, idx.F_ur: idx.F_ur + idx.n_F_ur]
    eta = y[:, idx.eta] + ctx.eta_off

    if idx.n_ncdm:
        # exact momentum integrals or the fluid variables in slots
        # (s, 0, 0:3) (equations.py:320-346)
        ncfa = ctx.ncdmfa_on[:, None]
        Psi, eps_nc, _, (rho_delta_ex, rpt_ex, rps_ex, dp_ex) = _ncdm_moments(fr, y, ctx)
        rho_nc, p_nc, pp_nc = fr.rho_nc, fr.p_nc, fr.pp_nc
        w_nc = p_nc / rho_nc
        rho_plus_p_nc = rho_nc + p_nc
        d_fl, t_fl, s_fl = Psi[:, :, 0, 0], Psi[:, :, 0, 1], Psi[:, :, 0, 2]
        cg2_nc = w_nc * (1.0 - (3.0 * w_nc - 2.0 + pp_nc / p_nc) / (3.0 + 3.0 * w_nc))
        rho_delta_nc = _w(ncfa, rho_nc * d_fl, rho_delta_ex)
        rpt_nc = _w(ncfa, rho_plus_p_nc * t_fl, rpt_ex)
        rps_nc = _w(ncfa, rho_plus_p_nc * s_fl, rps_ex)
        dp_nc = _w(ncfa, cg2_nc * rho_nc * d_fl, dp_ex)

    # effective photon/ur variables in the Einstein sums
    # (perturb_total_stress_energy :6107-6170)
    d_g = _w(rsa, zero, delta_g)
    t_g = _w(rsa, zero, theta_g)
    s_g = _w(rsa | tca, zero, shear_g)
    d_ur = _w(rsa, zero, delta_ur)
    t_ur = _w(rsa, zero, theta_ur)
    s_ur = _w(rsa, zero, shear_ur)
    delta_rho = rho_g * d_g + rho_b * delta_b + rho_cdm * delta_cdm + rho_ur * d_ur
    rho_plus_p_theta = 4.0 / 3.0 * rho_g * t_g + rho_b * theta_b + 4.0 / 3.0 * rho_ur * t_ur
    rho_plus_p_shear = 4.0 / 3.0 * rho_g * s_g + 4.0 / 3.0 * rho_ur * s_ur
    if want_loc:
        delta_p = 1.0 / 3.0 * rho_g * d_g + cb2 * rho_b * delta_b + 1.0 / 3.0 * rho_ur * d_ur
    if idx.n_ncdm:
        delta_rho = delta_rho + rho_delta_nc.sum(dim=1)
        rho_plus_p_theta = rho_plus_p_theta + rpt_nc.sum(dim=1)
        rho_plus_p_shear = rho_plus_p_shear + rps_nc.sum(dim=1)
        if want_loc:
            delta_p = delta_p + dp_nc.sum(dim=1)

    # Einstein 00 (perturb_einstein :5911) and the radiation-streaming
    # values (perturb_rsa_delta_and_theta :9581-9615, rsa_MD_with_reio)
    h_prime = (k2 * s2 * eta + 1.5 * a2 * delta_rho) / (0.5 * aH)
    rsa_delta_g = 4.0 / k2 * (aH * h_prime - k2 * eta) \
        - 4.0 / k2 * kap * (theta_b + 0.5 * h_prime)
    rsa_theta_g = -0.5 * h_prime + 3.0 / k2 * (
        kapp * (theta_b + 0.5 * h_prime)
        + kap * (-aH * theta_b + cb2 * k2 * delta_b - aH * h_prime + k2 * eta))
    rsa_delta_ur = 4.0 / k2 * (aH * h_prime - k2 * eta)
    rsa_theta_ur = -0.5 * h_prime
    delta_rho = delta_rho + _w(rsa, rho_g * rsa_delta_g + rho_ur * rsa_delta_ur, zero)
    rho_plus_p_theta = rho_plus_p_theta + _w(
        rsa, 4.0 / 3.0 * rho_g * rsa_theta_g + 4.0 / 3.0 * rho_ur * rsa_theta_ur, zero)

    # Einstein 0i, trace, shear (:5941-5976)
    eta_prime = (1.5 * a2 * rho_plus_p_theta + 0.5 * K * h_prime) / (k2 * s2)
    alpha = (h_prime + 6.0 * eta_prime) / (2.0 * k2)
    tca_shear_g_1 = 16.0 / 45.0 / kap * (theta_g + k2 * alpha)
    rho_plus_p_shear = rho_plus_p_shear + _w(tca, 4.0 / 3.0 * rho_g * tca_shear_g_1, zero)
    alpha_prime = -2.0 * aH * alpha + eta - 4.5 * (a2 / k2) * rho_plus_p_shear
    metric_continuity = 0.5 * h_prime
    metric_shear = k2 * alpha
    metric_shear_prime = k2 * alpha_prime
    if want_loc:
        phi = eta - aH * alpha
        psi = aH * alpha + alpha_prime
        phi_prime = eta_prime - aH_prime * alpha - aH * alpha_prime
        phi_plus_psi = eta + alpha_prime
    metric_ufa = metric_continuity

    d_g = _w(rsa, rsa_delta_g, delta_g)
    t_g = _w(rsa, rsa_theta_g, theta_g)

    # TCA slip and shear, compromise_CLASS (perturb_tca_slip_and_shear :9229)
    tau_c = 1.0 / kap
    dtau_c = -kapp * tau_c * tau_c
    F = tau_c / (1.0 + R)
    F_prime = dtau_c / (1.0 + R) + tau_c * aH * R / (1.0 + R) ** 2
    slip_src = -app_a * theta_b + k2 * (-aH * d_g / 2.0 + cb2 * (-theta_b - metric_continuity)
                                        + (t_g + metric_continuity) / 3.0)
    slip_1 = (dtau_c / tau_c - 2.0 * aH / (1.0 + R)) * (theta_b - t_g) + F * slip_src
    shear_g_tca1 = 16.0 / 45.0 * tau_c * (t_g + metric_shear)
    theta_prime0 = (-aH * theta_b + k2 * (cb2 * delta_b + R / 4.0 * d_g)) / (1.0 + R)
    shear_g_prime1 = 16.0 / 45.0 * (tau_c * (theta_prime0 + metric_shear_prime)
                                    + dtau_c * (t_g + metric_shear))
    tca_slip = (1.0 - 2.0 * aH * F) * slip_1 + F * k2 * (
        2.0 * aH * s2 * shear_g_tca1 + s2 * shear_g_prime1
        - (1.0 / 3.0 - cb2) * (F * theta_prime0 + 2.0 * F_prime * theta_b))
    tca_shear_g = (1.0 - 11.0 / 6.0 * dtau_c) * shear_g_tca1 \
        - 11.0 / 6.0 * tau_c * 16.0 / 45.0 * tau_c * (theta_prime0 + metric_shear_prime)

    dy = torch.empty_like(y)
    dy[:, idx.delta_g] = _w(rsa, zero, -4.0 / 3.0 * (t_g + metric_continuity))
    dy[:, idx.delta_b] = -(theta_b + metric_continuity)
    theta_b_prime_tca = (-aH * theta_b
                         + k2 * (cb2 * delta_b + R * (d_g / 4.0 - s2 * tca_shear_g))
                         + R * tca_slip) / (1.0 + R)
    theta_b_prime_notca = -aH * theta_b + k2 * cb2 * delta_b + R * kap * (t_g - theta_b)
    theta_b_prime = _w(tca, theta_b_prime_tca, theta_b_prime_notca)
    dy[:, idx.theta_b] = theta_b_prime

    P0 = (G[:, 0] + G[:, 2] + 2.0 * s_l2 * shear_g) / 8.0
    theta_g_prime_tca = (-(theta_b_prime + aH * theta_b - k2 * cb2 * delta_b) / R
                         + k2 * (0.25 * d_g - s2 * tca_shear_g))
    theta_g_prime_full = k2 * (d_g / 4.0 - s2 * shear_g) + kap * (theta_b - t_g)
    dy[:, idx.theta_g] = _w(rsa, zero, _w(tca, theta_g_prime_tca, theta_g_prime_full))

    hier_on = (~(tca | rsa))[:, None]
    kapc = kap[:, None]
    d_shear_g = 0.5 * (8.0 / 15.0 * (theta_g + metric_shear)
                       - 3.0 / 5.0 * k * s_l3 / s_l2 * F_g[:, 0]
                       - kap * (2.0 * shear_g - 4.0 / 5.0 / s_l2 * P0))
    dy[:, idx.shear_g] = _w(hier_on[:, 0], d_shear_g, zero)

    # photon moments l = 3..l_max_g (perturb_derivs :8152-8215): the l
    # couplings carry s_l, and F_2 enters the l = 3 equation as 2 s_2 shear_g
    lmax_g = idx.l_max_g
    hg = kf.g
    F_lm1 = torch.cat([(2.0 * s_l2 * shear_g)[:, None], F_g[:, :-1]], dim=1)
    F_lp1 = torch.cat([F_g[:, 1:], zero[:, None]], dim=1)
    dF = hg.kd * (hg.lo * F_lm1 - hg.hi * F_lp1) - kapc * F_g
    dF[:, -1] = k * (hg.sl[:, -1] * F_g[:, -2] - (lmax_g + 1.0) * cotKgen * F_g[:, -1]) \
        - kap * F_g[:, -1]
    dy[:, idx.F_g: idx.F_g + idx.n_F_g] = _w(hier_on, dF, 0.0)

    # polarization l = 0..l_max_pol_g (:8180-8213)
    lmax_p = idx.l_max_pol_g
    hp = kf.p
    G_lm1 = torch.cat([zero[:, None], G[:, :-1]], dim=1)
    G_lp1 = torch.cat([G[:, 1:], zero[:, None]], dim=1)
    dG = hp.kd * (hp.lo * G_lm1 - hp.hi * G_lp1) - kapc * G
    dG[:, 0] = -k * G[:, 1] - kap * (G[:, 0] - 4.0 * P0)
    dG[:, 2] = k / 5.0 * (2.0 * s_l2 * G[:, 1] - 3.0 * s_l3 * G[:, 3]) \
        - kap * (G[:, 2] - 4.0 / 5.0 * P0)
    dG[:, -1] = k * (hp.sl[:, -1] * G[:, -2] - (lmax_p + 1.0) * cotKgen * G[:, -1]) \
        - kap * G[:, -1]
    dy[:, idx.G_g: idx.G_g + idx.n_G_g] = _w(hier_on, dG, 0.0)

    # cdm: the synchronous gauge is its rest frame (perturb_derivs :8238-8248)
    dy[:, idx.delta_cdm] = -metric_continuity

    # massless neutrinos (:8630-8672)
    ur_on = ~rsa
    dy[:, idx.delta_ur] = _w(ur_on, -4.0 / 3.0 * (theta_ur + metric_continuity), zero)
    d_theta_ur = k2 * (delta_ur / 4.0 - s2 * shear_ur)
    dy[:, idx.theta_ur] = _w(ur_on, d_theta_ur, zero)
    d_shear_ur_full = 0.5 * (8.0 / 15.0 * (theta_ur + metric_shear)
                             - 3.0 / 5.0 * k * s_l3 / s_l2 * F_ur[:, 0])
    d_shear_ur_ufa = -3.0 / tau * shear_ur + 2.0 / 3.0 * (theta_ur + metric_ufa)
    dy[:, idx.shear_ur] = _w(ur_on, _w(ufa, d_shear_ur_ufa, d_shear_ur_full), zero)
    lmax_u = idx.l_max_ur
    hu = kf.u
    Fu_lm1 = torch.cat([(2.0 * s_l2 * shear_ur)[:, None], F_ur[:, :-1]], dim=1)
    Fu_lp1 = torch.cat([F_ur[:, 1:], zero[:, None]], dim=1)
    dFu = hu.kd * (hu.lo * Fu_lm1 - hu.hi * Fu_lp1)
    dFu[:, -1] = k * (hu.sl[:, -1] * F_ur[:, -2] - (lmax_u + 1.0) * cotKgen * F_ur[:, -1])
    dy[:, idx.F_ur: idx.F_ur + idx.n_F_ur] = _w((ur_on & ~ufa)[:, None], dFu, 0.0)

    # ncdm (perturb_derivs :8725-8894)
    if idx.n_ncdm:
        nc = ctx.tables.ncdm
        nl = idx.n_l_ncdm
        qk_eps = (k[:, None, None] * nc.q[None, None, :] / eps_nc)[..., None]   # (L, ns, nq, 1)
        dl0 = nc.dlnf0[None]
        hn = kf.n
        zcol = torch.zeros_like(Psi[..., :1])
        Ps_m1 = torch.cat([zcol, Psi[..., :-1]], dim=-1)
        Ps_p1 = torch.cat([Psi[..., 1:], zcol], dim=-1)
        dPsi = qk_eps / hn.kd * (hn.lo[:, None, None, :] * Ps_m1
                                 - hn.hi[:, None, None, :] * Ps_p1)
        dPsi[..., 0] = -qk_eps[..., 0] * Psi[..., 1] \
            + metric_continuity[:, None, None] * dl0 / 3.0
        sl2c, sl3c = s_l2[:, None, None], s_l3[:, None, None]
        dPsi[..., 2] = qk_eps[..., 0] / 5.0 * (2.0 * sl2c * Psi[..., 1]
                                               - 3.0 * sl3c * Psi[..., 3]) \
            - sl2c * metric_shear[:, None, None] * 2.0 / 15.0 * dl0
        dPsi[..., -1] = qk_eps[..., 0] * Psi[..., -2] \
            - (1.0 + (nl - 1.0)) * (k * cotKgen)[:, None, None] * Psi[..., -1]
        # fluid approximation (ncdmfa_CLASS, :8770-8790)
        ca2 = w_nc / 3.0 / (1.0 + w_nc) * (5.0 - pp_nc / p_nc)
        ceff2 = ca2
        cvis2 = 3.0 * w_nc * ca2
        aHc, k2c, mc = aH[:, None], k2[:, None], metric_continuity[:, None]
        dPsi_fl = torch.zeros_like(dPsi)
        dPsi_fl[:, :, 0, 0] = -(1.0 + w_nc) * (t_fl + mc) - 3.0 * aHc * (ceff2 - w_nc) * d_fl
        dPsi_fl[:, :, 0, 1] = (-aHc * (1.0 - 3.0 * ca2) * t_fl
                               + ceff2 / (1.0 + w_nc) * k2c * d_fl - k2c * s_fl)
        dPsi_fl[:, :, 0, 2] = (
            -3.0 * (aHc * (2.0 / 3.0 - ca2 - pp_nc / p_nc / 3.0) + 1.0 / tau[:, None]) * s_fl
            + 8.0 / 3.0 * cvis2 / (1.0 + w_nc) * s_l2[:, None] * (t_fl + metric_ufa[:, None]))
        dPsi = _w(ctx.ncdmfa_on[:, None, None, None], dPsi_fl, dPsi)
        dy[:, idx.ncdm: idx.ncdm + idx.n_ncdm_block] = dPsi.reshape(y.shape[0], -1)

    dy[:, idx.eta] = eta_prime
    if not want_loc:
        return dy, None

    # gauge-invariant matter variables (perturb_einstein :5986-6006)
    rho_m_cb = rho_b + rho_cdm
    rho_theta_cb = rho_b * theta_b
    theta_cb_gauge = rho_theta_cb / rho_m_cb
    delta_cb = (rho_b * delta_b + rho_cdm * delta_cdm) / rho_m_cb + 3.0 * aH * theta_cb_gauge / k2
    theta_cb = theta_cb_gauge + k2 * alpha
    rho_tot_species = rho_g + rho_b + rho_cdm + rho_ur
    if idx.n_ncdm:
        # the matter sums over cdm and baryons and the ncdm species
        # (equations.py:880-899)
        sum_rho_nc = rho_nc.sum(dim=1)
        sum_rpp_nc = rho_plus_p_nc.sum(dim=1)
        rho_m = rho_m_cb + sum_rho_nc
        rpp_m = rho_m_cb + sum_rpp_nc
        delta_rho_m = rho_b * delta_b + rho_cdm * delta_cdm + rho_delta_nc.sum(dim=1)
        rpt_m = rho_theta_cb + rpt_nc.sum(dim=1)
        delta_nc = rho_delta_nc.sum(dim=1) / sum_rho_nc
        theta_nc = rpt_nc.sum(dim=1) / sum_rpp_nc
        rho_tot_species = rho_tot_species + sum_rho_nc
        theta_m_gauge = rpt_m / rpp_m
        delta_m = delta_rho_m / rho_m + 3.0 * aH * theta_m_gauge / k2
        theta_m = theta_m_gauge + k2 * alpha
    else:
        delta_m, theta_m, delta_nc, theta_nc = delta_cb, theta_cb, zero, zero
    P = _w(rsa, zero, _w(tca, 5.0 * s_l2 * tca_shear_g / 8.0, P0))
    rpp_tot = fr.rho_tot + fr.p_tot
    loc = dict(
        aH=aH, aH_prime=aH_prime, h_prime=h_prime, eta_prime=eta_prime, alpha=alpha,
        alpha_prime=alpha_prime, P=P, delta_m=delta_m, theta_m=theta_m,
        delta_cb=delta_cb, theta_cb=theta_cb, delta_nc=delta_nc, theta_nc=theta_nc,
        theta_b_prime=theta_b_prime, eta=eta, phi=phi, psi=psi,
        phi_plus_psi=phi_plus_psi, phi_prime=phi_prime,
        delta_g_eff=_w(rsa, rsa_delta_g, delta_g), theta_g_eff=t_g,
        delta_ur_eff=_w(rsa, rsa_delta_ur, delta_ur),
        theta_ur_eff=_w(rsa, rsa_theta_ur, theta_ur),
        delta_tot=delta_rho / rho_tot_species,
        theta_tot=rho_plus_p_theta / rpp_tot,
        H_T_Nb_prime=3.0 * aH / rpp_tot * (
            -delta_p + fr.p_tot_prime * rho_plus_p_theta / (rpp_tot * k2) + rho_plus_p_shear))
    return dy, loc


def rhs(fr: Frame, y: torch.Tensor, ctx: PertCtx) -> torch.Tensor:
    return rhs_full(fr, y, ctx, want_loc=False)[0]


# --- stiff (Thomson-drag) split for the IMEX evolver ------------------------
# The only stiff entries are the kappa' terms: diagonal over the photon
# hierarchies, a Sherman-Morrison 3x3 {shear_g, G0, G2} block through
# P0 = (G0 + G2 + 2 s_2 shear)/8 (u = (0.05/s_2, 0.5, 0.1), v = (2 s_2, 1, 1),
# v.u = 0.7 whatever s_2), and the 2x2 {theta_g, theta_b} drag. Masked out
# under TCA and RSA (classpp_public_tpu equations.py:966-1103).
_SM_U = (0.05, 0.5, 0.1)
_SM_VU = 0.7


def _stiff_kap(fr: Frame, ctx: PertCtx):
    on = ~(ctx.tca_on | ctx.rsa_on)
    return torch.where(on, fr.kap, 0.0), 4.0 / 3.0 * fr.rho_g / fr.rho_b


def _s_l2(ctx: PertCtx) -> torch.Tensor:
    """s_l[2] per lane (equations.py:1012-1014), as `k_factors` computes it."""
    if ctx.kf is not None:
        return ctx.kf.s_l2
    return torch.sqrt(torch.clamp(1.0 - 3.0 * ctx.tables.K / (ctx.k * ctx.k), min=0.0))


def stiff_apply(fr: Frame, y: torch.Tensor, ctx: PertCtx) -> torch.Tensor:
    """J_s y: exactly the kappa'-proportional terms of rhs()."""
    idx = ctx.tables.idx
    kap, R = _stiff_kap(fr, ctx)
    sl2 = _s_l2(ctx)
    theta_g = y[:, idx.theta_g]
    theta_b = y[:, idx.theta_b]
    shear_g = y[:, idx.shear_g]
    G = y[:, idx.G_g: idx.G_g + idx.n_G_g]
    P0 = (G[:, 0] + G[:, 2] + 2.0 * sl2 * shear_g) / 8.0
    out = torch.zeros_like(y)
    out[:, idx.theta_g] = kap * (theta_b - theta_g)
    out[:, idx.theta_b] = R * kap * (theta_g - theta_b)
    out[:, idx.shear_g] = kap * (0.4 / sl2 * P0 - shear_g)
    out[:, idx.F_g: idx.G_g + idx.n_G_g] = -kap[:, None] * y[:, idx.F_g: idx.G_g + idx.n_G_g]
    out[:, idx.G_g] += kap * 4.0 * P0
    out[:, idx.G_g + 2] += kap * 0.8 * P0
    return out




def stiff_solve(fr: Frame, gh: torch.Tensor, r: torch.Tensor, ctx: PertCtx) -> torch.Tensor:
    """x = (I - gh J_s)^-1 r in closed form."""
    idx = ctx.tables.idx
    kap, R = _stiff_kap(fr, ctx)
    a = gh * kap
    x = r.clone()
    x[:, idx.F_g: idx.G_g + idx.n_G_g] = r[:, idx.F_g: idx.G_g + idx.n_G_g] / (1.0 + a)[:, None]
    sl2 = _s_l2(ctx)
    r_sh, r_G0, r_G2 = r[:, idx.shear_g], r[:, idx.G_g], r[:, idx.G_g + 2]
    vr = 2.0 * sl2 * r_sh + r_G0 + r_G2
    den = (1.0 + a) * (1.0 + (1.0 - _SM_VU) * a)
    x[:, idx.shear_g] = r_sh / (1.0 + a) + a * (_SM_U[0] / sl2) * vr / den
    x[:, idx.G_g] = r_G0 / (1.0 + a) + a * _SM_U[1] * vr / den
    x[:, idx.G_g + 2] = r_G2 / (1.0 + a) + a * _SM_U[2] * vr / den
    det = 1.0 + a * (1.0 + R)
    r_g, r_b = r[:, idx.theta_g], r[:, idx.theta_b]
    x[:, idx.theta_g] = ((1.0 + a * R) * r_g + a * r_b) / det
    x[:, idx.theta_b] = (a * R * r_g + (1.0 + a) * r_b) / det
    return x


def adiabatic_ic(fr: Frame, ctx: PertCtx, curvature_ini: float = 1.0) -> torch.Tensor:
    """Adiabatic initial conditions, synchronous gauge, with the curvature
    factor s2 (perturb_initial_conditions :4825-4935; equations.py:1109-1161)."""
    idx = ctx.tables.idx
    k, tau, ci = ctx.k, fr.tau, curvature_ini
    s2 = 1.0 - 3.0 * ctx.tables.K / (k * k)
    rho_r = fr.rho_g + fr.rho_ur
    rho_m = fr.rho_b + fr.rho_cdm
    rho_nu = fr.rho_ur
    fracnu = rho_nu / rho_r
    fracb = fr.rho_b / rho_m
    om = fr.a * rho_m / torch.sqrt(rho_r)
    ktau2 = (k * tau) ** 2
    ktau3 = (k * tau) ** 3
    delta_g = -ktau2 / 3.0 * (1.0 - om * tau / 5.0) * ci * s2
    theta_g = -k * ktau3 / 36.0 * (1.0 - 3.0 * (1.0 + 5.0 * fracb - fracnu)
                                   / 20.0 / (1.0 - fracnu) * om * tau) * ci * s2
    theta_ur = -k * ktau3 / 36.0 / (4.0 * fracnu + 15.0) * (
        4.0 * fracnu + 11.0 + 12.0 * s2
        - 3.0 * (8.0 * fracnu * fracnu + 50.0 * fracnu + 275.0) / 20.0
        / (2.0 * fracnu + 15.0) * tau * om) * ci * s2
    shear_ur = ktau2 / (45.0 + 12.0 * fracnu) * (3.0 * s2 - 1.0) * (
        1.0 + (4.0 * fracnu - 5.0) / 4.0 / (2.0 * fracnu + 15.0) * tau * om) * ci
    l3_ur = ktau3 * 2.0 / 7.0 / (12.0 * fracnu + 45.0) * ci
    eta_hat = -ci * ktau2 / 12.0 / (15.0 + 4.0 * fracnu) * (
        5.0 + 4.0 * s2 * fracnu
        - (16.0 * fracnu**2 + 280.0 * fracnu + 325.0) / 10.0 / (2.0 * fracnu + 15.0) * tau * om)
    eta_hat = eta_hat + (ci - ctx.eta_off)
    y = torch.zeros((k.shape[0], idx.size), dtype=k.dtype, device=k.device)
    y[:, idx.delta_g] = delta_g
    y[:, idx.theta_g] = theta_g
    y[:, idx.delta_b] = 0.75 * delta_g
    y[:, idx.theta_b] = theta_g
    y[:, idx.delta_cdm] = 0.75 * delta_g
    y[:, idx.delta_ur] = delta_g
    y[:, idx.theta_ur] = theta_ur
    y[:, idx.shear_ur] = shear_ur
    y[:, idx.F_ur] = l3_ur
    y[:, idx.eta] = eta_hat
    if idx.n_ncdm:
        # relativistic ncdm (perturb_initial_conditions :5249-5252):
        # Psi_l = (ur multipole) x coefficient x dlnf0/dlnq
        nc = ctx.tables.ncdm
        ns, nq, nl = idx.n_ncdm, idx.q_size_ncdm, idx.n_l_ncdm
        eps = torch.sqrt(nc.q[None, None, :] ** 2
                         + (fr.a[:, None, None] * nc.x_fac[None, :, None]) ** 2)
        dl0 = nc.dlnf0[None]
        Psi = torch.zeros((k.shape[0], ns, nq, nl), dtype=k.dtype, device=k.device)
        Psi[..., 0] = -0.25 * delta_g[:, None, None] * dl0
        Psi[..., 1] = -eps / (3.0 * nc.q[None, None, :] * k[:, None, None]) \
            * theta_ur[:, None, None] * dl0
        Psi[..., 2] = -0.5 * shear_ur[:, None, None] * dl0
        Psi[..., 3] = -0.25 * l3_ur[:, None, None] * dl0
        y[:, idx.ncdm: idx.ncdm + idx.n_ncdm_block] = Psi.reshape(k.shape[0], -1)
    return y




def initial_conditions(fr: Frame, ctx: PertCtx) -> torch.Tensor:
    """The initial state of each lane: adiabatic, synchronous gauge
    (equations.py:1412-1418)."""
    return adiabatic_ic(fr, ctx)


def remap_tca_off(y: torch.Tensor, fr: Frame, ctx: PertCtx) -> torch.Tensor:
    """Fill the photon hierarchy from its tight-coupling values when TCA
    switches off, with the curvature factors s_2, s_3 (perturb_vector_init
    :3900-3920; equations.py:1421-1445)."""
    idx = ctx.tables.idx
    _, loc = rhs_full(fr, y, ctx._replace(tca_on=torch.ones_like(ctx.tca_on)))
    kk = ctx.k / fr.kap
    kf = _kf(ctx)
    s_l2, s_l3 = kf.s_l2, kf.s_l3
    shear_g = 8.0 / 5.0 * loc["P"] / s_l2      # P = 5 s_2 shear_g / 8 under TCA
    y = y.clone()
    y[:, idx.shear_g] = shear_g
    y[:, idx.F_g] = 6.0 / 7.0 * kk * s_l3 * shear_g
    y[:, idx.G_g] = 2.5 * shear_g
    y[:, idx.G_g + 1] = kk * (5.0 - 2.0 * s_l2) / 6.0 * shear_g
    y[:, idx.G_g + 2] = 0.5 * shear_g
    y[:, idx.G_g + 3] = kk * 3.0 * s_l3 / 14.0 * shear_g
    return y


def remap_ufa_on(y: torch.Tensor, idx: PtIdx, on: torch.Tensor) -> torch.Tensor:
    """Drop the ur hierarchy above l = 2 where the fluid approximation
    starts (perturb_vector_init, ufa branch)."""
    y = y.clone()
    sl = slice(idx.F_ur, idx.F_ur + idx.n_F_ur)
    y[:, sl] = torch.where(on[:, None], 0.0, y[:, sl])
    return y


def remap_ncdmfa_on(y: torch.Tensor, fr: Frame, ctx: PertCtx, on: torch.Tensor) -> torch.Tensor:
    """Collapse each ncdm phase-space block to its fluid moments where the
    fluid approximation switches on (perturb_vector_init :4485-4517)."""
    idx = ctx.tables.idx
    Psi, _, _, (rho_delta, rpt, rps, _) = _ncdm_moments(fr, y, ctx)
    rpp = fr.rho_nc + fr.p_nc
    Psi_new = torch.zeros_like(Psi)
    Psi_new[:, :, 0, 0] = rho_delta / fr.rho_nc
    Psi_new[:, :, 0, 1] = rpt / rpp
    Psi_new[:, :, 0, 2] = rps / rpp
    y = y.clone()
    sl = slice(idx.ncdm, idx.ncdm + idx.n_ncdm_block)
    y[:, sl] = torch.where(on[:, None], Psi_new.reshape(y.shape[0], -1), y[:, sl])
    return y


def remap_rsa_on(y: torch.Tensor, idx: PtIdx, on: torch.Tensor) -> torch.Tensor:
    """Zero the radiation slots where free streaming starts
    (perturb_vector_init, rsa branch)."""
    y = y.clone()
    for sl in (slice(idx.delta_g, idx.G_g + idx.n_G_g),
               slice(idx.delta_ur, idx.F_ur + idx.n_F_ur)):
        y[:, sl] = torch.where(on[:, None], 0.0, y[:, sl])
    return y


def compute_sources(fr: Frame, y: torch.Tensor, ctx: PertCtx) -> torch.Tensor:
    """All source functions at (k, tau) per lane, in the efficient form of
    the synchronous gauge (perturb_sources :6874-6895; equations.py:1517-1530).
    Returns (L, SrcIdx.n)."""
    idx = ctx.tables.idx
    k = ctx.k
    k2 = k * k
    _, L = rhs_full(fr, y, ctx)
    g, dg, emk = fr.g, fr.dg, fr.emk
    zero = torch.zeros_like(k)
    aH, al, alp = L["aH"], L["alpha"], L["alpha_prime"]
    t0 = (g * (L["delta_g_eff"] / 4.0 + alp)
          + (g * (L["eta"] - alp - 2.0 * aH * al)
             + emk * 2.0 * (L["eta_prime"] - L["aH_prime"] * al - aH * alp))
          + (g * (L["theta_b_prime"] / k2 + alp) + dg * (y[:, idx.theta_b] / k2 + al)))
    t1 = emk * k * (alp + 2.0 * aH * al - L["eta"])
    theta_cdm = zero
    cols = {
        "t0": t0, "t1": t1, "t2": g * L["P"], "p": math.sqrt(6.0) * g * L["P"],
        "phi": L["phi"], "psi": L["psi"], "phi_plus_psi": L["phi_plus_psi"],
        "phi_prime": L["phi_prime"], "delta_m": L["delta_m"], "theta_m": L["theta_m"],
        "delta_cb": L["delta_cb"], "theta_cb": L["theta_cb"], "h_prime": L["h_prime"],
        "eta_src": L["eta"], "delta_g": L["delta_g_eff"], "theta_g": L["theta_g_eff"],
        "delta_b": y[:, idx.delta_b], "theta_b": y[:, idx.theta_b],
        "delta_cdm": y[:, idx.delta_cdm], "theta_cdm": theta_cdm,
        "delta_ur": L["delta_ur_eff"], "theta_ur": L["theta_ur_eff"],
        "delta_ncdm": L["delta_nc"], "theta_ncdm": L["theta_nc"], "delta_tot": L["delta_tot"],
        "H_T_Nb_prime": L["H_T_Nb_prime"], "theta_tot": L["theta_tot"],
    }
    return torch.stack([cols[n] for n in SrcIdx.names], dim=1)

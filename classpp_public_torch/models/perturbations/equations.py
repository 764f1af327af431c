"""Scalar perturbation equations, batched over lanes: RHS, the stiff
(Thomson) split, adiabatic and isocurvature initial conditions, approximation
remaps and the source functions.

Counterpart of classpp_public_tpu/models/perturbations/equations.py
(`PertCtx` :134, `rhs_full` :225, `stiff_apply` :1017, `stiff_solve` :1057,
`adiabatic_ic` :1109, `isocurvature_ic` :1216, `_ic_to_newtonian` :1317,
`initial_conditions` :1412,
`remap_tca_off` :1421, `remap_ufa_on` :1448, `remap_ncdmfa_on` :1456,
`remap_rsa_on` :1482, `compute_sources` :1501), restricted to photons,
polarization, baryons, cdm, massless neutrinos, massive neutrinos (ncdm: the
Psi_l(q) hierarchy on a shared momentum grid, or its fluid approximation), in
the synchronous gauge a quintessence scalar field (delta phi, delta phi') and
the metric, in open, flat and closed universes, in the synchronous or the
Newtonian gauge, and in the synchronous gauge interacting dark matter with
interacting dark radiation (idm_dr: the idm density and velocity, the idr
hierarchy or its fluid; equations.py:307-318, :382-389, :818-844,
:880-931, :996-1102, :1125-1177). The curvature enters through the free-streaming factors
s_l = sqrt(1 - K (l^2 - 1)/k^2), s2 = 1 - 3 K/k^2 and cotKgen =
sqrt|K| cot_K(sqrt|K| tau)/k (`curvature`); in a flat universe s_l = s2 = 1
exactly and cotKgen = 1/(k tau).

The gauge enters through the metric terms of the species' equations. In the
synchronous gauge metric_euler is 0, which the synchronous branch leaves
out, and metric_ufa equals metric_continuity. In the Newtonian gauge the state
slot `idx.eta` holds phi, psi is constrained, theta_cdm evolves, and
metric_continuity = -3 phi', metric_euler = k^2 psi, metric_shear = 0,
metric_ufa = -6 phi' (equations.py:496-528).

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
# the scalar field's background columns, after the ncdm ones (Frame.scf)
SCF_COLS = ("rho_scf", "phi_prime_scf", "dV_scf", "ddV_scf")
# interacting dark matter and dark radiation: their background columns after
# the ncdm ones and their thermodynamics columns after TH_COLS (Frame.idm)
IDM_BG_COLS = ("rho_idm_dr", "rho_idr")
IDM_TH_COLS = ("dmu_idm_dr", "dmu_idr", "cidm_dr2")
# the initial conditions; a lane's IC code is its index here (PertCtx.ic)
IC_KINDS = ("ad", "bi", "cdi", "nid", "niv")


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
    # with idm_dr: the (2, l_max_idr - 1) table of the idr damping's alpha_l
    # and beta_l, l = 2..l_max_idr (PtIdx.idr_damping_coeffs)
    idr_damp: torch.Tensor = None


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
    scf: tuple = None             # SCF_COLS per lane, with a scalar field
    idm: tuple = None             # IDM_BG_COLS then IDM_TH_COLS per lane, with idm_dr


def make_tables(bg, bidx, th, idx: PtIdx, ncdm: NcdmCtx = None, K: float = 0.0) -> PertTables:
    """Restrict the runtime splines to BG_COLS (+ ncdm columns, + SCF_COLS or
    IDM_BG_COLS) / TH_COLS (+ IDM_TH_COLS)."""
    bi = [bidx[n] for n in BG_COLS]
    for i in range(idx.n_ncdm):
        bi += [bidx[f"rho_ncdm{i}"], bidx[f"p_ncdm{i}"], bidx[f"pseudo_p_ncdm{i}"]]
    if idx.has_scf:
        bi += [bidx[n] for n in SCF_COLS]
    ti = [ThIdx.ix[n] for n in TH_COLS]
    damp = None
    if idx.has_idm_dr:
        bi += [bidx[n] for n in IDM_BG_COLS]
        ti += [ThIdx.ix[n] for n in IDM_TH_COLS]
        damp = torch.tensor(idx.idr_damping_coeffs(), dtype=torch.float64,
                            device=bg.lntau_spline.y.device)
    b, t = bg.lntau_spline, th.lntau_spline
    return PertTables(
        bg=b._replace(y=b.y[:, bi].contiguous(), y2=b.y2[:, bi].contiguous()),
        th=t._replace(y=t.y[:, ti].contiguous(), y2=t.y2[:, ti].contiguous()),
        idx=idx, ncdm=ncdm, K=K, idr_damp=damp)


def frame_at(tau: torch.Tensor, tables: PertTables) -> Frame:
    lntau = torch.log(tau)
    bgv = tables.bg.eval(lntau)
    thv = tables.th.eval(lntau).unbind(-1)
    nb, idx = len(BG_COLS), tables.idx
    ne = nb + 3 * idx.n_ncdm
    nc = bgv[:, nb:ne].reshape(bgv.shape[0], -1, 3).unbind(-1) if idx.n_ncdm else (None,) * 3
    scf = bgv[:, ne:].unbind(-1) if idx.has_scf else None
    nt = len(TH_COLS)
    idm = bgv[:, ne:].unbind(-1) + thv[nt:] if idx.has_idm_dr else None
    return Frame(tau, *bgv[:, :nb].unbind(-1), *thv[:nt], *nc, scf, idm)


class PertCtx(NamedTuple):
    """Per-lane data fixed during one step: wavenumber, approximation flags
    at the step's start time, the eta storage offset (low-k adiabatic
    lanes store eta - 1 so its deviation keeps full relative precision) and
    the initial condition (an IC_KINDS index per lane; None: all adiabatic)."""

    k: torch.Tensor
    tca_on: torch.Tensor   # bool
    rsa_on: torch.Tensor
    ufa_on: torch.Tensor
    eta_off: torch.Tensor
    tables: PertTables
    ncdmfa_on: torch.Tensor = None   # ncdm fluid approximation (bool)
    ic: torch.Tensor = None          # IC_KINDS index per lane (int)
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
    i: Hierarchy = None    # idr, l = 3..l_max_idr (free streaming)


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
                    hier(0, idx.n_l_ncdm - 1, True) if idx.n_ncdm else None,
                    hier(3, idx.l_max_idr) if idx.n_F_idr else None)


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
    newt = idx.gauge == "newtonian"

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
    if idx.has_idm_dr:
        # idm_dr and idr (perturb_total_stress_energy :6244-6251;
        # equations.py:307-318, :382-389), before the ncdm sums as in JAX
        delta_idm = y[:, idx.delta_idm_dr]
        theta_idm = y[:, idx.theta_idm_dr_pt]
        delta_idr = y[:, idx.delta_idr]
        theta_idr = y[:, idx.theta_idr]
        shear_idr = y[:, idx.shear_idr]
        rho_idm, rho_idr, _, _, cidm2 = fr.idm
        delta_rho = delta_rho + rho_idm * delta_idm + rho_idr * delta_idr
        rho_plus_p_theta = rho_plus_p_theta + rho_idm * theta_idm \
            + 4.0 / 3.0 * rho_idr * theta_idr
        if not idx.idr_fluid:
            rho_plus_p_shear = rho_plus_p_shear + 4.0 / 3.0 * rho_idr * shear_idr
        if want_loc:
            delta_p = delta_p + 1.0 / 3.0 * rho_idr * delta_idr
    if idx.n_ncdm:
        delta_rho = delta_rho + rho_delta_nc.sum(dim=1)
        rho_plus_p_theta = rho_plus_p_theta + rpt_nc.sum(dim=1)
        rho_plus_p_shear = rho_plus_p_shear + rps_nc.sum(dim=1)
        if want_loc:
            delta_p = delta_p + dp_nc.sum(dim=1)
    if idx.has_scf:
        # the scalar field's stress-energy, synchronous gauge
        # (perturb_total_stress_energy :6438-6476; equations.py:395-410)
        dphi_scf = y[:, idx.phi_scf_pt]
        dphip_scf = y[:, idx.phi_prime_scf_pt]
        rho_scf, phip_scf_bg, dV_scf_bg, ddV_scf_bg = fr.scf
        delta_rho = delta_rho + (phip_scf_bg * dphip_scf / a2 + dV_scf_bg * dphi_scf) / 3.0
        rho_plus_p_theta = rho_plus_p_theta + k2 / a2 * phip_scf_bg * dphi_scf / 3.0
        if want_loc:
            delta_p = delta_p + (phip_scf_bg * dphip_scf / a2 - dV_scf_bg * dphi_scf) / 3.0

    if newt:
        # Einstein equations, Newtonian gauge (perturb_einstein :5870-5905):
        # the slot holds phi, psi is constrained; under TCA the photon shear
        # in psi is its first-order value 16/45/kappa' theta_g. Under RSA no
        # radiation correction enters delta_rho or (rho+p) theta here
        # (equations.py:496-528).
        phi = eta
        theta_cdm = y[:, idx.theta_cdm]
        rho_plus_p_theta = rho_plus_p_theta + rho_cdm * theta_cdm
        rho_plus_p_shear_psi = rho_plus_p_shear + _w(
            tca, 4.0 / 3.0 * rho_g * 16.0 / 45.0 / kap * theta_g, zero)
        psi = phi - 4.5 * (a2 / k2) * rho_plus_p_shear_psi
        phi_prime = -aH * psi + 1.5 * (a2 / k2) * rho_plus_p_theta
        # radiation streaming (perturb_rsa_delta_and_theta :9543)
        rsa_delta_g = -4.0 * phi - 4.0 / k2 * kap * theta_b
        rsa_theta_g = 6.0 * phi_prime + 3.0 / k2 * (
            kapp * theta_b + kap * (-aH * theta_b + cb2 * k2 * delta_b + k2 * phi))
        rsa_delta_ur = -4.0 * phi
        rsa_theta_ur = 6.0 * phi_prime
        metric_continuity = -3.0 * phi_prime
        metric_euler = k2 * psi
        metric_shear = zero
        metric_shear_prime = zero
        metric_ufa = -6.0 * phi_prime
        h_prime = zero
        eta_prime = phi_prime
        alpha = zero
        alpha_prime = zero
        phi_plus_psi = phi + psi
    else:
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
    if newt:
        slip_src = slip_src - aH * metric_euler
    slip_1 = (dtau_c / tau_c - 2.0 * aH / (1.0 + R)) * (theta_b - t_g) + F * slip_src
    shear_g_tca1 = 16.0 / 45.0 * tau_c * (t_g + metric_shear)
    theta_prime0 = (-aH * theta_b + k2 * (cb2 * delta_b + R / 4.0 * d_g)) / (1.0 + R)
    if newt:
        theta_prime0 = theta_prime0 + metric_euler
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
    if newt:
        # metric_euler in the baryon and photon velocities (equations.py:611-622)
        theta_b_prime_notca = (-aH * theta_b + k2 * cb2 * delta_b + metric_euler
                               + R * kap * (t_g - theta_b))
        theta_b_prime_tca = theta_b_prime_tca + metric_euler
    else:
        theta_b_prime_notca = -aH * theta_b + k2 * cb2 * delta_b + R * kap * (t_g - theta_b)
    theta_b_prime = _w(tca, theta_b_prime_tca, theta_b_prime_notca)
    dy[:, idx.theta_b] = theta_b_prime

    P0 = (G[:, 0] + G[:, 2] + 2.0 * s_l2 * shear_g) / 8.0
    theta_g_prime_tca = (-(theta_b_prime + aH * theta_b - k2 * cb2 * delta_b) / R
                         + k2 * (0.25 * d_g - s2 * tca_shear_g))
    if newt:
        theta_g_prime_full = (k2 * (d_g / 4.0 - s2 * shear_g) + metric_euler
                              + kap * (theta_b - t_g))
        theta_g_prime_tca = theta_g_prime_tca + (1.0 + R) / R * metric_euler
    else:
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

    # cdm: the synchronous gauge is its rest frame; the Newtonian gauge
    # evolves theta_cdm (perturb_derivs :8238-8248)
    if newt:
        dy[:, idx.delta_cdm] = -(theta_cdm + metric_continuity)
        dy[:, idx.theta_cdm] = -aH * theta_cdm + metric_euler
    else:
        dy[:, idx.delta_cdm] = -metric_continuity

    # massless neutrinos (:8630-8672)
    ur_on = ~rsa
    dy[:, idx.delta_ur] = _w(ur_on, -4.0 / 3.0 * (theta_ur + metric_continuity), zero)
    d_theta_ur = k2 * (delta_ur / 4.0 - s2 * shear_ur)
    if newt:
        d_theta_ur = d_theta_ur + metric_euler
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
        if newt:
            dPsi[..., 1] = dPsi[..., 1] - eps_nc * metric_euler[:, None, None] \
                / (3.0 * nc.q[None, None, :] * k[:, None, None]) * dl0
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
        if newt:
            dPsi_fl[:, :, 0, 1] += metric_euler[:, None]
        dPsi_fl[:, :, 0, 2] = (
            -3.0 * (aHc * (2.0 / 3.0 - ca2 - pp_nc / p_nc / 3.0) + 1.0 / tau[:, None]) * s_fl
            + 8.0 / 3.0 * cvis2 / (1.0 + w_nc) * s_l2[:, None] * (t_fl + metric_ufa[:, None]))
        dPsi = _w(ctx.ncdmfa_on[:, None, None, None], dPsi_fl, dPsi)
        dy[:, idx.ncdm: idx.ncdm + idx.n_ncdm_block] = dPsi.reshape(y.shape[0], -1)

    if idx.has_idm_dr:
        # idm_dr and idr without their scattering, which the stiff split
        # carries (perturb_derivs :8252-8268, :8572-8612; equations.py:818-844)
        dy[:, idx.delta_idm_dr] = -(theta_idm + metric_continuity)
        dy[:, idx.theta_idm_dr_pt] = -aH * theta_idm + k2 * cidm2 * delta_idm
        dy[:, idx.delta_idr] = -4.0 / 3.0 * (theta_idr + metric_continuity)
        if idx.idr_fluid:
            dy[:, idx.theta_idr] = k2 / 4.0 * delta_idr
            dy[:, idx.shear_idr] = zero
        else:
            dy[:, idx.theta_idr] = k2 * (delta_idr / 4.0 - s2 * shear_idr)
            F_idr = y[:, idx.F_idr: idx.F_idr + idx.n_F_idr]
            dy[:, idx.shear_idr] = 0.5 * (8.0 / 15.0 * (theta_idr + metric_shear)
                                          - 3.0 / 5.0 * k * s_l3 / s_l2 * F_idr[:, 0])
            hi_ = kf.i
            Fi_lm1 = torch.cat([zero[:, None], F_idr[:, :-1]], dim=1)
            Fi_lp1 = torch.cat([F_idr[:, 1:], zero[:, None]], dim=1)
            dFi = hi_.kd * (hi_.lo * Fi_lm1 - hi_.hi * Fi_lp1)
            dFi[:, 0] = k / 7.0 * (6.0 * s_l3 * s_l2 * shear_idr
                                   - 4.0 * hi_.sl1[:, 0] * F_idr[:, 1])
            dFi[:, -1] = k * (hi_.sl[:, -1] * F_idr[:, -2]
                              - (idx.l_max_idr + 1.0) * cotKgen * F_idr[:, -1])
            dy[:, idx.F_idr: idx.F_idr + idx.n_F_idr] = dFi

    if idx.has_scf:
        # Klein-Gordon (perturb_derivs :8556-8570; equations.py:847-851)
        dy[:, idx.phi_scf_pt] = dphip_scf
        dy[:, idx.phi_prime_scf_pt] = (-2.0 * aH * dphip_scf - metric_continuity * phip_scf_bg
                                       - (k2 + a2 * ddV_scf_bg) * dphi_scf)
    dy[:, idx.eta] = eta_prime
    if not want_loc:
        return dy, None

    # gauge-invariant matter variables (perturb_einstein :5986-6006); in the
    # Newtonian gauge alpha = 0 and the cdm velocity enters the sums
    rho_m_cb = rho_b + rho_cdm
    rho_theta_cb = rho_b * theta_b + rho_cdm * theta_cdm if newt else rho_b * theta_b
    theta_cb_gauge = rho_theta_cb / rho_m_cb
    delta_cb = (rho_b * delta_b + rho_cdm * delta_cdm) / rho_m_cb + 3.0 * aH * theta_cb_gauge / k2
    theta_cb = theta_cb_gauge + k2 * alpha
    rho_tot_species = rho_g + rho_b + rho_cdm + rho_ur
    if idx.n_ncdm or idx.has_idm_dr:
        # the matter sums over cdm and baryons, the ncdm species and idm_dr
        # (equations.py:880-899)
        rho_m, rpp_m = rho_m_cb, rho_m_cb
        delta_rho_m = rho_b * delta_b + rho_cdm * delta_cdm
        rpt_m = rho_theta_cb
        delta_nc, theta_nc = zero, zero
        if idx.n_ncdm:
            sum_rho_nc = rho_nc.sum(dim=1)
            sum_rpp_nc = rho_plus_p_nc.sum(dim=1)
            rho_m = rho_m + sum_rho_nc
            rpp_m = rpp_m + sum_rpp_nc
            delta_rho_m = delta_rho_m + rho_delta_nc.sum(dim=1)
            rpt_m = rpt_m + rpt_nc.sum(dim=1)
            delta_nc = rho_delta_nc.sum(dim=1) / sum_rho_nc
            theta_nc = rpt_nc.sum(dim=1) / sum_rpp_nc
            rho_tot_species = rho_tot_species + sum_rho_nc
        if idx.has_idm_dr:
            rho_m = rho_m + rho_idm
            rpp_m = rpp_m + rho_idm
            delta_rho_m = delta_rho_m + rho_idm * delta_idm
            rpt_m = rpt_m + rho_idm * theta_idm
            rho_tot_species = rho_tot_species + rho_idm + rho_idr   # (equations.py:930-931)
        theta_m_gauge = rpt_m / rpp_m
        delta_m = delta_rho_m / rho_m + 3.0 * aH * theta_m_gauge / k2
        theta_m = theta_m_gauge + k2 * alpha
    else:
        delta_m, theta_m, delta_nc, theta_nc = delta_cb, theta_cb, zero, zero
    if idx.has_scf:
        rho_tot_species = rho_tot_species + rho_scf   # (equations.py:928-929)
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
# under TCA and RSA (classpp_public_tpu equations.py:966-1103). With idm_dr
# also the idm-idr momentum exchange, a 2x2 {theta_idr, theta_idm} block, and
# the idr's per-l damping diagonal, neither masked (equations.py:996-1102).
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
    if idx.has_idm_dr:
        dmu, dmu_idr, Sinv = _stiff_idm(fr)
        th_idm, th_idr = y[:, idx.theta_idm_dr_pt], y[:, idx.theta_idr]
        out[:, idx.theta_idm_dr_pt] = Sinv * dmu * (th_idr - th_idm)
        out[:, idx.theta_idr] = dmu * (th_idm - th_idr)
        if not idx.idr_fluid:
            damp = _idr_damp(ctx, dmu, dmu_idr)
            out[:, idx.shear_idr: idx.F_idr + idx.n_F_idr] = \
                -damp * y[:, idx.shear_idr: idx.F_idr + idx.n_F_idr]
    return out


def _stiff_idm(fr: Frame):
    """(dmu_idm, dmu_idr, S^-1 = 4 rho_idr / (3 rho_idm)) per lane
    (equations.py:1001-1009)."""
    rho_idm, rho_idr, dmu, dmu_idr, _ = fr.idm
    return dmu, dmu_idr, 4.0 * rho_idr / (3.0 * rho_idm)


def _idr_damp(ctx: PertCtx, dmu, dmu_idr):
    """alpha_l dmu_idm + beta_l dmu_idr per lane and l = 2..l_max_idr."""
    al, be = ctx.tables.idr_damp
    return al[None, :] * dmu[:, None] + be[None, :] * dmu_idr[:, None]


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
    if idx.has_idm_dr:
        # 2x2 {theta_idr, theta_idm}: det = 1 + b (1 + S^-1), b = gh dmu
        dmu, dmu_idr, Sinv = _stiff_idm(fr)
        b = gh * dmu
        det_i = 1.0 + b * (1.0 + Sinv)
        r_r, r_m = r[:, idx.theta_idr], r[:, idx.theta_idm_dr_pt]
        x[:, idx.theta_idr] = ((1.0 + b * Sinv) * r_r + b * r_m) / det_i
        x[:, idx.theta_idm_dr_pt] = (b * Sinv * r_r + (1.0 + b) * r_m) / det_i
        if not idx.idr_fluid:
            ad = gh[:, None] * _idr_damp(ctx, dmu, dmu_idr)
            sl = slice(idx.shear_idr, idx.F_idr + idx.n_F_idr)
            x[:, sl] = r[:, sl] / (1.0 + ad)
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
    if idx.has_idm_dr:
        # idm_dr counts as matter, idr as free-streaming radiation
        # (equations.py:1125-1130)
        rho_m = rho_m + fr.idm[0]
        rho_r = rho_r + fr.idm[1]
        rho_nu = rho_nu + fr.idm[1]
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
    if idx.has_idm_dr:
        # (perturb_initial_conditions :4880, :5214; equations.py:1169-1177)
        y[:, idx.delta_idm_dr] = 0.75 * delta_g
        y[:, idx.theta_idm_dr_pt] = theta_ur
        y[:, idx.delta_idr] = delta_g
        y[:, idx.theta_idr] = theta_ur
        if not idx.idr_fluid:
            y[:, idx.shear_idr] = shear_ur
            y[:, idx.F_idr] = l3_ur
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


def ic_to_newtonian(y: torch.Tensor, fr: Frame, ctx: PertCtx) -> torch.Tensor:
    """Gauge-transform the synchronous initial state to the Newtonian gauge
    (perturb_initial_conditions :5095-5250; equations.py:1317-1410): alpha =
    (h' + 6 eta')/2k^2 from the first two Einstein equations (with the
    curvature factor 1/s2), every species shifted by it, theta_cdm = k^2
    alpha, the eta slot set to phi, and each ncdm Psi_0, Psi_1 re-seeded from
    the shifted ur variables."""
    idx = ctx.tables.idx
    k = ctx.k
    k2 = k * k
    aH = fr.a * fr.H
    rho_ur = fr.rho_ur
    if idx.n_ncdm:
        rho_ur = rho_ur + fr.rho_nc.sum(dim=1)   # still relativistic here
    rho_r = fr.rho_g + rho_ur
    rho_m = fr.rho_b + fr.rho_cdm
    fracg = fr.rho_g / rho_r
    fracnu = rho_ur / rho_r
    fracb = fr.rho_b / rho_m
    fraccdm = 1.0 - fracb
    rmr = rho_m / rho_r
    dg, tg = y[:, idx.delta_g], y[:, idx.theta_g]
    db, tb = y[:, idx.delta_b], y[:, idx.theta_b]
    dc = y[:, idx.delta_cdm]
    dur, tur = y[:, idx.delta_ur], y[:, idx.theta_ur]
    eta = y[:, idx.eta] + ctx.eta_off
    delta_tot = (fracg * dg + fracnu * dur + rmr * (fracb * db + fraccdm * dc)) / (1.0 + rmr)
    velocity_tot = (4.0 / 3.0 * (fracg * tg + fracnu * tur) + rmr * fracb * tb) / (1.0 + rmr)
    s2 = 1.0 - 3.0 * ctx.tables.K / k2
    alpha = (eta + 1.5 * aH * aH / (k2 * s2)
             * (delta_tot + 3.0 * aH / k2 * velocity_tot)) / aH
    y = y.clone()
    y[:, idx.eta] = eta - aH * alpha
    y[:, idx.delta_g] += -4.0 * aH * alpha
    y[:, idx.theta_g] += k2 * alpha
    y[:, idx.delta_b] += -3.0 * aH * alpha
    y[:, idx.theta_b] += k2 * alpha
    y[:, idx.delta_cdm] += -3.0 * aH * alpha
    y[:, idx.theta_cdm] = k2 * alpha
    y[:, idx.delta_ur] += -4.0 * aH * alpha
    y[:, idx.theta_ur] += k2 * alpha            # shear and l = 3 are gauge invariant
    if idx.n_ncdm:
        nc = ctx.tables.ncdm
        ns, nq, nl = idx.n_ncdm, idx.q_size_ncdm, idx.n_l_ncdm
        eps = torch.sqrt(nc.q[None, None, :] ** 2
                         + (fr.a[:, None, None] * nc.x_fac[None, :, None]) ** 2)
        dl0 = nc.dlnf0[None]
        Psi = y[:, idx.ncdm: idx.ncdm + idx.n_ncdm_block].reshape(-1, ns, nq, nl).clone()
        Psi[..., 0] = -0.25 * y[:, idx.delta_ur][:, None, None] * dl0
        Psi[..., 1] = -eps / (3.0 * nc.q[None, None, :] * k[:, None, None]) \
            * y[:, idx.theta_ur][:, None, None] * dl0
        y[:, idx.ncdm: idx.ncdm + idx.n_ncdm_block] = Psi.reshape(k.shape[0], -1)
    return y


def isocurvature_ic(fr: Frame, ctx: PertCtx, kind: str, entropy_ini: float = 1.0) -> torch.Tensor:
    """Isocurvature initial conditions of `kind` in {"bi", "cdi", "nid",
    "niv"}, synchronous gauge, flat (Bucher-Moodley-Turok conventions;
    perturb_initial_conditions :4946-5085; equations.py:1216-1314). The ncdm
    species count as relativistic (in rho_ur); each ncdm Psi_0..Psi_2 is
    seeded from the ur multipoles."""
    idx = ctx.tables.idx
    k, tau, e = ctx.k, fr.tau, entropy_ini
    rho_ur = fr.rho_ur
    if idx.n_ncdm:
        for i in range(idx.n_ncdm):
            rho_ur = rho_ur + fr.rho_nc[:, i]
    rho_r = fr.rho_g + rho_ur
    rho_m = fr.rho_b + fr.rho_cdm
    fracnu = rho_ur / rho_r
    fracg = fr.rho_g / rho_r
    fracb = fr.rho_b / rho_m
    fraccdm = 1.0 - fracb
    om = fr.a * rho_m / torch.sqrt(rho_r)
    kt = k * tau
    kt2 = kt * kt
    if kind in ("cdi", "bi"):
        frac = fraccdm if kind == "cdi" else fracb
        dg = e * frac * om * tau * (-2.0 / 3.0 + om * tau / 4.0)
        tg = -e * frac * om * kt2 / 12.0
        db = 0.75 * dg if kind == "cdi" else e + 0.75 * dg
        tb = tg
        dc = e + 0.75 * dg if kind == "cdi" else 0.75 * dg
        dur = dg
        tur = tg
        sur = -e * frac * kt2 * tau * om / 6.0 / (2.0 * fracnu + 15.0)
        eta = -e * frac * om * tau * (1.0 / 6.0 - om * tau / 16.0)
    elif kind == "nid":
        dg = e * fracnu / fracg * (-1.0 + kt2 / 6.0)
        tg = -e * fracnu / fracg * k * k * tau * (0.25 - fracb / fracg * 3.0 / 16.0 * om * tau)
        db = e * fracnu / fracg / 8.0 * kt2
        tb = tg
        dc = -e * fracnu * fracb / fracg / 80.0 * kt2 * om * tau
        dur = e * (1.0 - kt2 / 6.0)
        tur = e * k * k * tau / 4.0
        sur = e * kt2 / (4.0 * fracnu + 15.0) / 2.0
        eta = -e * fracnu / (4.0 * fracnu + 15.0) / 6.0 * kt2
    elif kind == "niv":
        dg = e * kt * fracnu / fracg * (1.0 - 3.0 / 16.0 * fracb * (2.0 + fracg) / fracg * om * tau)
        tg = e * fracnu / fracg * 0.75 * k * (
            -1.0 + 0.75 * fracb / fracg * om * tau
            + 3.0 / 16.0 * om * om * tau * tau * fracb / fracg / fracg * (fracg - 3.0 * fracb)
            + kt2 / 6.0)
        db = 0.75 * dg
        tb = tg
        dc = -e * 9.0 / 64.0 * fracnu * fracb / fracg * kt * om * tau
        dur = -e * kt * (1.0 + 3.0 / 16.0 * fracb * fracnu / fracg * om * tau)
        tur = e * 0.75 * k * (1.0 - kt2 / 6.0 * (4.0 * fracnu + 9.0) / (4.0 * fracnu + 5.0))
        sur = e / (4.0 * fracnu + 15.0) * kt * (
            1.0 + 3.0 * om * tau * fracnu / (4.0 * fracnu + 15.0))
        eta = e * fracnu * kt * (-1.0 / (4.0 * fracnu + 5.0)
                                 + (-3.0 / 64.0 * fracb / fracg
                                    + 15.0 / 4.0 / (4.0 * fracnu + 15.0) / (4.0 * fracnu + 5.0)
                                    * om * tau))
    else:
        raise ValueError(f"unknown isocurvature kind {kind!r}")
    y = torch.zeros((k.shape[0], idx.size), dtype=k.dtype, device=k.device)
    for slot, v in ((idx.delta_g, dg), (idx.theta_g, tg), (idx.delta_b, db), (idx.theta_b, tb),
                    (idx.delta_cdm, dc), (idx.delta_ur, dur), (idx.theta_ur, tur),
                    (idx.shear_ur, sur), (idx.eta, eta)):
        y[:, slot] = v
    if idx.n_ncdm:
        nc = ctx.tables.ncdm
        ns, nq, nl = idx.n_ncdm, idx.q_size_ncdm, idx.n_l_ncdm
        eps = torch.sqrt(nc.q[None, None, :] ** 2
                         + (fr.a[:, None, None] * nc.x_fac[None, :, None]) ** 2)
        dl0 = nc.dlnf0[None]
        Psi = torch.zeros((k.shape[0], ns, nq, nl), dtype=k.dtype, device=k.device)
        Psi[..., 0] = -0.25 * dur[:, None, None] * dl0
        Psi[..., 1] = -eps / (3.0 * nc.q[None, None, :] * k[:, None, None]) \
            * tur[:, None, None] * dl0
        Psi[..., 2] = -0.5 * sur[:, None, None] * dl0
        y[:, idx.ncdm: idx.ncdm + idx.n_ncdm_block] = Psi.reshape(k.shape[0], -1)
    return y


def initial_conditions(fr: Frame, ctx: PertCtx) -> torch.Tensor:
    """The initial state of each lane's initial condition (ctx.ic; None:
    adiabatic) in the layout's gauge: built in the synchronous gauge and
    transformed for the Newtonian one (equations.py:1412-1418)."""
    y = adiabatic_ic(fr, ctx)
    if ctx.ic is not None:
        for code, kind in enumerate(IC_KINDS[1:], start=1):
            on = ctx.ic == code
            if bool(on.any()):
                y = torch.where(on[:, None], isocurvature_ic(fr, ctx, kind), y)
    if ctx.tables.idx.gauge == "newtonian":
        y = ic_to_newtonian(y, fr, ctx)
    return y


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
    the layout's gauge (perturb_sources :6848-6860 Newtonian, :6874-6895
    synchronous; equations.py:1517-1530). Returns (L, SrcIdx.n)."""
    idx = ctx.tables.idx
    k = ctx.k
    k2 = k * k
    _, L = rhs_full(fr, y, ctx)
    g, dg, emk = fr.g, fr.dg, fr.emk
    zero = torch.zeros_like(k)
    if idx.gauge == "newtonian":
        phi, psi = L["phi"], L["psi"]
        t0 = (g * (L["delta_g_eff"] / 4.0 + psi)
              + (g * (phi - psi) + emk * 2.0 * L["phi_prime"])
              + (g * L["theta_b_prime"] + dg * y[:, idx.theta_b]) / k2)
        t1 = emk * k * (psi - phi)
        theta_cdm = y[:, idx.theta_cdm]
    else:
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

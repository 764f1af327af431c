"""Background cosmology: LambdaCDM, open, flat or closed, with massless and
massive neutrinos.

Counterpart of classpp_public_tpu/models/background.py
(`_compute_background_impl` :364, the ncdm momentum integrals :113-262,
`tau_of_z` :944). Every density has a closed form on a fixed uniform ln(a)
grid (ncdm through fixed-node momentum sums), the time-like integrals (tau, t,
r_s) are exact cumulative spline integrals, and the growth factor D(a), f(a)
is an RK4 march. Runtime queries go through a uniform-in-ln(tau) respline.

Placement: the tables are built on the host, a chain of small float64
vector ops. The growth march (`growth_march`, ops/ode.py `rk4_fixed` in the
JAX package, a lax.scan program) runs where the stage is asked to run: on a
CUDA device it is one launch of the hand-written kernel
csrc/growth_march.cu (the spline of (rho_m, a, H) moved to the card, D and f
read back into the table), on the CPU its plain version, the host loop
`growth_march_plain`. The finished tables move to the requested device once,
at the end.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import numpy as np
import torch

from .. import constants as const
from ..config.params import CosmoParams, check_lcdm
from ..config.precision import PrecisionParams
from ..ops.ode import rk4_fixed
from ..ops.quadrature import trapz_weights_np
from ..ops.splines import (UniformSpline, interp, spline_d2, spline_eval,
                           spline_integrate)

HOST = torch.device("cpu")


class BgIdx:
    """Column indices of the background runtime table (index_bg_*,
    source/background_module.h:40-99), LambdaCDM + ur + ncdm layout: three
    columns (rho, p, pseudo-pressure) per ncdm species after rho_ur."""

    def __init__(self, n_ncdm: int = 0):
        self.key = (n_ncdm, False, False, False, False, 0, 0)
        names = ["a", "H", "H_prime", "rho_g", "rho_b", "rho_cdm", "rho_lambda", "rho_ur"]
        for i in range(n_ncdm):
            names += [f"rho_ncdm{i}", f"p_ncdm{i}", f"pseudo_p_ncdm{i}"]
        names += ["rho_tot", "p_tot", "p_tot_prime", "rho_crit", "Omega_m", "Omega_r",
                  "conf_distance", "ang_distance", "lum_distance", "time", "rs", "D", "f"]
        self.names = names
        self.ix = {n: i for i, n in enumerate(names)}
        self.n = len(names)

    def __getitem__(self, name):
        return self.ix[name]


class BackgroundResult(NamedTuple):
    """All background tables (tensors on the stage's device) and derived
    scalars (Python floats)."""

    loga: torch.Tensor          # (N,) uniform grid of ln(a)
    tau_of_loga: torch.Tensor   # (N,)
    table: torch.Tensor         # (N, ncol) quantities on the loga grid
    lntau_spline: UniformSpline  # uniform-in-ln(tau) respline, table columns
    tau0: float
    age: float
    z_eq: float
    tau_eq: float
    a_today: float
    H0: float
    Omega0_m: float
    Omega0_r: float
    Omega0_g: float
    Omega0_b: float
    Omega0_cdm: float
    Omega0_lambda: float
    Omega0_ur: float
    Omega0_ncdm_tot: float = 0.0
    rho_ncdm0: tuple = ()       # today's rho per ncdm species

    def to(self, device) -> "BackgroundResult":
        return self._replace(loga=self.loga.to(device),
                             tau_of_loga=self.tau_of_loga.to(device),
                             table=self.table.to(device),
                             lntau_spline=self.lntau_spline.to(device))


# --- ncdm momentum integrals (tools/non_cold_dark_matter.cpp momenta) --------
_NCDM_NQ = 128
_NCDM_QMAX = 32.0
_RHO_INTEGRAL_0 = 7.0 * math.pi**4 / 120.0  # int q^3/(e^q+1) dq


def _ncdm_quadrature():
    """Dense trapezoid grid for the background Fermi-Dirac integrals: nodes q
    and weights times f0(q) (numpy)."""
    q = np.linspace(1e-5, _NCDM_QMAX, _NCDM_NQ)
    return q, trapz_weights_np(q) / (np.exp(q) + 1.0)


_Q_NCDM, _WF_NCDM = _ncdm_quadrature()


def ncdm_psd_f0(params, i, q):
    """Normalised phase-space distribution of species i on momenta q (numpy):
    Fermi-Dirac with zero chemical potential, 1/(e^q + 1). Tabulated files
    and chemical potentials (classpp_public_tpu/models/background.py:142-160)
    are not ported; check_lcdm refuses them."""
    q = np.asarray(q, dtype=np.float64)
    return 1.0 / (np.exp(np.minimum(q, 700.0)) + 1.0)


def ncdm_q_rule(params, pr=None):
    """The perturbation momentum-grid rule (nq, gauss, qmax): the default
    16-node Gauss-Laguerre grid shared by all species. The 'Quadrature
    strategy' branches (classpp_public_tpu/models/background.py:183-209) are
    not ported; check_lcdm refuses them."""
    return 16, True, _NCDM_QMAX


def ncdm_psd_weights(params, nq, gauss=True, qmax=None):
    """Per-species quadrature data on shared momentum nodes: (q (nq,),
    w (ns, nq), dlnf0 (ns, nq)), w = weight x f0(q) so that sum w q^2 eps
    reproduces int q^2 eps f0 dq; dlnf0 = dln f0/dln q by central difference
    (numpy)."""
    if gauss:
        qn, wn = np.polynomial.laguerre.laggauss(nq)
        base_w = wn * np.exp(qn)
    else:
        qn = np.linspace(1e-5, qmax if qmax is not None else _NCDM_QMAX, nq)
        base_w = trapz_weights_np(qn)
    ws, dls = [], []
    dq = 1e-4
    for i in range(params.N_ncdm):
        f0 = ncdm_psd_f0(params, i, qn)
        f_hi = ncdm_psd_f0(params, i, qn * (1.0 + dq))
        f_lo = ncdm_psd_f0(params, i, qn * (1.0 - dq))
        dln = np.where(f0 > 0.0, (f_hi - f_lo) / (2.0 * dq * np.maximum(f0, 1e-300)), 0.0)
        ws.append(base_w * f0)
        dls.append(dln)
    return (qn, np.asarray(ws).reshape(params.N_ncdm, nq),
            np.asarray(dls).reshape(params.N_ncdm, nq))


def ncdm_momenta(x: torch.Tensor, q=None, wf=None):
    """Dimensionless Fermi-Dirac integrals at x = a m / T0, normalised so
    that I_rho(0) = 3 I_p(0) = 1:
      I_rho = int q^2 eps f0 / I0,  eps = sqrt(q^2 + x^2)
      I_p   = (1/3) int q^4/eps f0 / I0
      I_pp  = (1/3) int q^6/eps^3 f0 / I0   (pseudo-pressure of the ncdm fluid
              approximation; background_ncdm_momenta)."""
    if q is None:
        q, wf = _Q_NCDM, _WF_NCDM
    q = torch.as_tensor(q, dtype=x.dtype)
    wf = torch.as_tensor(wf, dtype=x.dtype)
    eps = torch.sqrt(q**2 + x[..., None] ** 2)
    i_rho = torch.sum(q**2 * eps * wf, dim=-1) / _RHO_INTEGRAL_0
    i_p = torch.sum(q**4 / eps * wf, dim=-1) / (3.0 * _RHO_INTEGRAL_0)
    i_pp = torch.sum(q**6 / eps**3 * wf, dim=-1) / (3.0 * _RHO_INTEGRAL_0)
    return i_rho, i_p, i_pp


def _scalar_spline(spl: UniformSpline):
    """Host scalar evaluator of a UniformSpline (numpy rows): the growth
    march calls it 32k times, where a tensor eval would cost ~15 ops each."""
    y = spl.y.numpy()
    y2 = spl.y2.numpy()
    x0, dx, n = spl.x0, spl.dx, spl.n
    h2 = dx * dx / 6.0

    def ev(xq):
        t = (xq - x0) / dx
        i = min(max(int(math.floor(t)), 0), n - 2)
        b = t - i
        a = 1.0 - b
        return a * y[i] + b * y[i + 1] + ((a**3 - a) * y2[i] + (b**3 - b) * y2[i + 1]) * h2

    return ev


GROWTH_SUBSTEPS = 2   # RK4 sub-steps per ln a interval (background.py:818-835)



def growth_march_plain(spl: UniformSpline, ts: torch.Tensor, aH: torch.Tensor, y0: tuple,
                       substeps: int = GROWTH_SUBSTEPS) -> tuple:
    """Plain version of `growth_march`: the host RK4 loop (ops/ode.py
    rk4_fixed) on the scalar spline evaluator, y = (D, D' = dD/dtau) in ln a.
    Returns (D normalised to 1 today, f = D'/(D a H)) as CPU tensors, whatever
    the device of the inputs."""
    ev = _scalar_spline(spl.to("cpu"))

    def growth_rhs(lga, y, _):
        rm, aa, hh = ev(lga)
        D, Dp = y
        inv = 1.0 / (aa * hh)
        return np.array([Dp * inv, (-aa * hh * Dp + 1.5 * aa * aa * rm * D) * inv])

    Dys = torch.from_numpy(rk4_fixed(growth_rhs, np.array(y0, dtype=np.float64),
                                     ts.cpu().numpy(), None, substeps=substeps))
    aH = aH.cpu()
    return Dys[:, 0] / Dys[-1, 0], Dys[:, 1] / (Dys[:, 0] * aH)


def growth_march(spl: UniformSpline, ts: torch.Tensor, aH: torch.Tensor, y0: tuple,
                 substeps: int = GROWTH_SUBSTEPS) -> tuple:
    """The growth factor D (normalised to 1 at ts[-1]) and rate f = D'/(D a H)
    at the nodes ts (ln a) from y0 = (D, dD/dtau) at ts[0], by RK4 with
    `substeps` sub-steps per interval on the spline `spl` of (rho_m, a, H)
    over ln a. CUDA tensors: one launch of the growth_march kernel (D and f
    on the card); CPU tensors: the plain version."""
    dev = ts.device
    return growth_march_plain(spl, ts, aH, y0, substeps)


def compute_background(params: CosmoParams, pr: PrecisionParams,
                       device="cuda") -> tuple:
    """Build all background tables on the host, the growth march on `device`;
    return them on `device`."""
    from ..pipeline import resolve_device

    device = resolve_device(device)
    check_lcdm(params)
    bg, idx = _compute_background_impl(params, pr, device)
    return bg.to(device), idx


def _compute_background_impl(params: CosmoParams, pr: PrecisionParams, device="cpu"):
    N = pr.background_Nloga
    f64 = torch.float64
    H0 = params.H0
    h2 = params.h * params.h

    a_ini = pr.a_ini_over_a_today_default
    loga = torch.linspace(math.log(a_ini), 0.0, N, dtype=f64)
    a = torch.exp(loga)

    rho_g0 = const.rho_gamma_class_units(params.T_cmb)
    Omega0_g = rho_g0 / H0**2
    Omega0_b = params.omega_b / h2
    Omega0_cdm = params.omega_cdm / h2
    Omega0_ur = params.N_ur * const.ur_over_g_factor * Omega0_g

    rho_g = rho_g0 / a**4
    rho_b = Omega0_b * H0**2 / a**3
    rho_cdm = Omega0_cdm * H0**2 / a**3
    rho_ur = Omega0_ur * H0**2 / a**4

    # ncdm species (background.py:386-416)
    n_ncdm = params.N_ncdm
    rho_ncdm, p_ncdm, pp_ncdm = [], [], []
    for i in range(n_ncdm):
        T_ratio = params.T_ncdm_of(i)
        T0_eV = const.k_B * params.T_cmb * T_ratio / const.eV_SI  # T_ncdm today in eV
        i_rho, i_p, i_pp = ncdm_momenta(a * params.m_ncdm[i] / T0_eV)
        pref = params.deg_ncdm_of(i) * (7.0 / 8.0) * T_ratio**4 * rho_g0 / a**4
        rho_ncdm.append(pref * i_rho)
        p_ncdm.append(pref * i_p)
        pp_ncdm.append(pref * i_pp)
    rho_ncdm0 = tuple(float(r[-1]) for r in rho_ncdm)
    Omega0_ncdm_tot = sum(rho_ncdm0) / H0**2

    Omega0_others = Omega0_g + Omega0_b + Omega0_cdm + Omega0_ur + Omega0_ncdm_tot
    Omega0_lambda = 1.0 - params.Omega_k - Omega0_others
    rho_lambda = torch.full_like(a, Omega0_lambda * H0**2)

    # (background.py:748-751)
    rho_tot = rho_g + rho_b + rho_cdm + rho_ur + rho_lambda
    p_tot = (rho_g + rho_ur) / 3.0 - rho_lambda
    for i in range(n_ncdm):
        rho_tot = rho_tot + rho_ncdm[i]
        p_tot = p_tot + p_ncdm[i]
    # the curvature term Omega_k H0^2 / a^2 (background.py:759-764)
    rho_crit = rho_tot + params.Omega_k * H0**2 / a**2
    H = torch.sqrt(rho_crit)
    aH = a * H
    H_prime = -1.5 * a * (rho_tot + p_tot) - params.Omega_k * H0**2 / a
    p_tot_prime = -(4.0 / 3.0) * aH * (rho_g + rho_ur)
    for i in range(n_ncdm):
        # dp_ncdm/dtau = aH (pseudo_p - 5 p)  (tools/non_cold_dark_matter.cpp)
        p_tot_prime = p_tot_prime + aH * (pp_ncdm[i] - 5.0 * p_ncdm[i])

    # --- time-like integrals on the loga grid
    inv_aH = 1.0 / aH
    tau_ini = float(1.0 / aH[0])
    tau = tau_ini + spline_integrate(loga, inv_aH, spline_d2(loga, inv_aH))
    tau0 = float(tau[-1])
    inv_H = 1.0 / H
    t = 0.5 / float(H[0]) + spline_integrate(loga, inv_H, spline_d2(loga, inv_H))
    age = float(t[-1]) / const.Gyr_over_Mpc
    cs = 1.0 / torch.sqrt(3.0 * (1.0 + 3.0 * rho_b / (4.0 * rho_g)))
    integrand_rs = cs * inv_aH
    rs = float(cs[0]) * tau_ini + spline_integrate(loga, integrand_rs,
                                                   spline_d2(loga, integrand_rs))
    # comoving angular distance r(chi): sinh in open, sin in closed models
    # (background.py:806-815)
    chi = tau0 - tau
    sqrt_K = math.sqrt(abs(params.Omega_k)) * H0
    if params.Omega_k > 1e-10:
        r = torch.sinh(sqrt_K * chi) / sqrt_K
    elif params.Omega_k < -1e-10:
        r = torch.sin(sqrt_K * chi) / sqrt_K
    else:
        r = chi
    ang_distance = r * a
    lum_distance = r / a

    # --- growth factor (background_module.cpp:1975-1983): the RK4 march on
    # `device` (growth_march), D and f read back into the host table
    rho_m = rho_b + rho_cdm
    dloga = float(loga[1] - loga[0])
    growth_spl = UniformSpline.build(float(loga[0]), dloga, torch.stack([rho_m, a, H], dim=1))
    a0, aH0 = float(a[0]), float(aH[0])
    D, f = (v.cpu() for v in growth_march(growth_spl.to(device), loga.to(device), aH.to(device),
                                          (a0, a0 * 2.0 * aH0)))

    # --- z_eq (radiation-matter equality)
    rho_r_tot = rho_g + rho_ur
    rho_m_tot = rho_b + rho_cdm
    for i in range(n_ncdm):
        rho_r_tot = rho_r_tot + 3.0 * p_ncdm[i]
        rho_m_tot = rho_m_tot + (rho_ncdm[i] - 3.0 * p_ncdm[i])
    ratio = torch.log(rho_r_tot / rho_m_tot)
    i_eq = int(torch.argmin(torch.abs(ratio)))
    sl = (ratio[i_eq + 1] - ratio[i_eq - 1]) / (loga[i_eq + 1] - loga[i_eq - 1])
    loga_eq = loga[i_eq] - ratio[i_eq] / sl
    z_eq = float(torch.exp(-loga_eq) - 1.0)
    tau_eq = float(interp(loga_eq, loga, tau))

    idx = BgIdx(n_ncdm)
    cols = {
        "a": a, "H": H, "H_prime": H_prime,
        "rho_g": rho_g, "rho_b": rho_b, "rho_cdm": rho_cdm,
        "rho_lambda": rho_lambda, "rho_ur": rho_ur,
        "rho_tot": rho_tot, "p_tot": p_tot, "p_tot_prime": p_tot_prime,
        "rho_crit": rho_crit, "Omega_m": rho_m_tot / rho_crit,
        "Omega_r": rho_r_tot / rho_crit,
        "conf_distance": chi, "ang_distance": ang_distance,
        "lum_distance": lum_distance,
        "time": t / const.Gyr_over_Mpc, "rs": rs, "D": D, "f": f,
    }
    for i in range(n_ncdm):
        cols[f"rho_ncdm{i}"] = rho_ncdm[i]
        cols[f"p_ncdm{i}"] = p_ncdm[i]
        cols[f"pseudo_p_ncdm{i}"] = pp_ncdm[i]
    table = torch.stack([cols[n] for n in idx.names], dim=1)

    # --- uniform ln(tau) respline for runtime queries
    lntau = torch.log(tau)
    n_rt = 8192
    lntau_u = torch.linspace(float(lntau[0]), float(lntau[-1]), n_rt, dtype=f64)
    loga_u = spline_eval(lntau, loga, spline_d2(lntau, loga), lntau_u)
    loga_u[0] = loga[0]
    loga_u[-1] = loga[-1]
    table_u = spline_eval(loga, table, spline_d2(loga, table), loga_u)
    lntau_spline = UniformSpline.build(float(lntau_u[0]),
                                       float(lntau_u[1] - lntau_u[0]), table_u)

    res = BackgroundResult(
        loga=loga, tau_of_loga=tau, table=table, lntau_spline=lntau_spline,
        tau0=tau0, age=age, z_eq=z_eq, tau_eq=tau_eq, a_today=1.0, H0=H0,
        Omega0_m=Omega0_b + Omega0_cdm + Omega0_ncdm_tot,
        Omega0_r=Omega0_g + Omega0_ur,
        Omega0_g=Omega0_g, Omega0_b=Omega0_b, Omega0_cdm=Omega0_cdm,
        Omega0_lambda=Omega0_lambda, Omega0_ur=Omega0_ur,
        Omega0_ncdm_tot=Omega0_ncdm_tot, rho_ncdm0=rho_ncdm0)
    return res, idx


def tau_of_z(bg: BackgroundResult, z):
    """Conformal time at redshift z (background_tau_of_z, :211)."""
    loga_q = -torch.log1p(torch.as_tensor(z, dtype=bg.loga.dtype, device=bg.loga.device))
    return interp(loga_q, bg.loga, bg.tau_of_loga)

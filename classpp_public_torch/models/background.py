"""Background cosmology: LambdaCDM, open, flat or closed, with massless and
massive neutrinos and a quintessence scalar field.

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
`growth_march_plain`. With a scalar field, the shooting of Omega_scf
(`shoot_scf`, JAX :600-691) runs its Klein-Gordon marches (`scf_march`,
`_integrate_scf` :302-363 in the JAX package) the same way: a batch of shots
a launch of the kernel csrc/scf_march.cu on a CUDA device, the plain loop
`scf_march_plain` on the CPU. The finished tables move to the requested
device once, at the end.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import numpy as np
import torch

from .. import constants as const
from ..config.params import CosmoParams, check_lcdm
from ..config.precision import PrecisionParams
from ..ops import cuda
from ..ops.ode import rk4_fixed
from ..ops.quadrature import trapz_weights_np
from ..ops.splines import (UniformSpline, interp, spline_d2, spline_eval,
                           spline_integrate)

HOST = torch.device("cpu")


class BgIdx:
    """Column indices of the background runtime table (index_bg_*,
    source/background_module.h:40-99), LambdaCDM + ur (+ scf) (+ idm_dr) + ncdm
    layout: the scalar field's seven columns after rho_ur (background.py:50-52),
    then rho_idm_dr and rho_idr (:53-54), then three columns (rho, p,
    pseudo-pressure) per ncdm species."""

    SCF_NAMES = ("rho_scf", "p_scf", "phi_scf", "phi_prime_scf", "V_scf", "dV_scf", "ddV_scf")
    IDM_NAMES = ("rho_idm_dr", "rho_idr")

    def __init__(self, n_ncdm: int = 0, has_scf: bool = False, has_idm_dr: bool = False):
        self.key = (n_ncdm, False, False, has_scf, has_idm_dr, 0, 0)
        self.has_scf = has_scf
        self.has_idm_dr = has_idm_dr
        names = ["a", "H", "H_prime", "rho_g", "rho_b", "rho_cdm", "rho_lambda", "rho_ur"]
        if has_scf:
            names += list(self.SCF_NAMES)
        if has_idm_dr:
            names += list(self.IDM_NAMES)
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
    # the scalar field's potential parameters after the shooting (the tuned
    # entry scf_parameters[scf_tuning_index] included), the shooting's target
    # Omega_scf and its walk: the tune values whose f it read, in order
    # (bisection: lo, hi, then each midpoint; secant: each x)
    scf_parameters: tuple = ()
    scf_target: float = 0.0
    scf_walk: tuple = ()

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

growth_launches = 0  # growth_march kernel launches (growth_march on CUDA tensors)


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
    global growth_launches
    dev = ts.device
    if dev.type == "cpu":
        return growth_march_plain(spl, ts, aH, y0, substeps)
    if dev.type != "cuda":
        raise ValueError(f"growth_march: unsupported device {dev}")
    n = ts.shape[0]
    if spl.y.shape[1] != 3 or aH.shape != ts.shape:
        raise ValueError(f"growth_march: bad shapes spline {tuple(spl.y.shape)} ts "
                         f"{tuple(ts.shape)} aH {tuple(aH.shape)}")
    for t in (spl.y, spl.y2, ts, aH):
        if t.dtype != torch.float64 or not t.is_contiguous() or t.device != dev:
            raise ValueError(f"growth_march: every input must be contiguous float64 on {dev}")
    lib = cuda.library()
    # gm::coef_doubles: three coefficients at three times of every sub-step
    coef = torch.empty((n - 1) * substeps * 9, dtype=torch.float64, device=dev)
    Y = torch.empty((n, 2), dtype=torch.float64, device=dev)
    out = torch.empty((2, n), dtype=torch.float64, device=dev)
    err = lib.growth_march_launch(spl.y.data_ptr(), spl.y2.data_ptr(), float(spl.x0),
                                  float(spl.dx), int(spl.n), ts.data_ptr(), aH.data_ptr(), n,
                                  substeps, float(y0[0]), float(y0[1]), coef.data_ptr(),
                                  Y.data_ptr(), out.data_ptr(), cuda.stream_ptr(dev))
    cuda.check(err, "growth_march")
    growth_launches += 1
    return out[0], out[1]


# --- scalar-field dark energy (background.py:281-363, :600-691) ------------

SCF_TREE_LEVELS = 5  # bisection levels one scf_march launch evaluates on a card (31 midpoints)

scf_launches = 0  # scf_march kernel launches (scf_march on CUDA tensors)


def _scf_potential(phi, lam, alpha, A, B):
    """(V, dV, ddV) of the CLASS quintessence potential V = V_e V_p, V_e =
    exp(-lambda phi), V_p = (phi - B)^alpha + A (background_module.cpp:2065-2150)
    with the reference's dV_e = -lambda V (the full V), as the JAX
    `_scf_potential` (:281-299). phi: a tensor; the parameters: floats or
    tensors that broadcast with it."""
    alpha = torch.as_tensor(alpha, dtype=phi.dtype)
    V_e = torch.exp(-lam * phi)
    x = phi - B
    ax = torch.abs(x)
    off = alpha == 0.0
    V_p = torch.where(off, 1.0, ax ** alpha) + A
    V = V_e * V_p
    dV_p = torch.where(off, 0.0, alpha * ax ** (alpha - 1.0) * torch.sign(x))
    ddV_p = torch.where(off, 0.0, alpha * (alpha - 1.0) * ax ** (alpha - 2.0))
    dV_e = -lam * V
    ddV_e = lam * lam * V
    dV = dV_e * V_p + V_e * dV_p
    ddV = ddV_e * V_p + 2.0 * dV_e * dV_p + V_e * ddV_p
    return V, dV, ddV


class _Libm:
    """Python floats and libm: the fast arithmetic of the plain march."""

    num, exp, log, sqrt = float, math.exp, math.log, math.sqrt


class _Ieee:
    """numpy float64 scalars: IEEE arithmetic (inf and nan, no exceptions) for
    a chain that overflows the Python float functions."""

    num, exp, log, sqrt = np.float64, np.exp, np.log, np.sqrt


def _scf_chain(coef, n: int, h: float, a0: float, c4, start, fl):
    """One chain of the plain march in the arithmetic `fl`: the start
    (JAX _integrate_scf :324-333) and the dependent RK4 sub-steps on the
    coefficient rows `coef`, in the order of csrc/scf_march.cuh (`start`,
    `potential`, `rhs`, `march`). Returns [(phi, phi')] at every node."""
    lam, alpha, A, B = (fl.num(v) for v in c4)
    rho_rad_ini, phi_ini, phi_prime_ini, attractor = start
    exp = fl.exp

    def V_p(ax):
        return (1.0 if alpha == 0.0 else ax ** alpha) + A

    def rhs(t, phi, phip):
        V_e = exp(-lam * phi)
        x = phi - B
        ax = abs(x)
        vp = V_p(ax)
        V = V_e * vp
        sgn = 1.0 if x > 0.0 else (-1.0 if x < 0.0 else 0.0)
        dV_p = 0.0 if alpha == 0.0 else alpha * ax ** (alpha - 1.0) * sgn
        dV = -lam * V * vp + V_e * dV_p
        rho_s = (phip * phip / t[1] + V) / 3.0
        e = t[3] + rho_s + t[4]
        aH = t[0] * fl.sqrt(e if e > 1e-300 else 1e-300)
        return phip / aH, (-2.0 * aH * phip - t[2] * dV) / aH

    if attractor:
        arg = rho_rad_ini * 4.0 / (3.0 * lam * lam - 12.0)
        y0 = -1.0 / lam * fl.log(abs(arg)) * phi_ini if 3.0 * lam * lam - 12.0 > 0.0 \
            else 1.0 / lam
        y1 = 2.0 * a0 * fl.sqrt(abs(exp(-lam * y0) * V_p(abs(y0 - B)))) * phi_prime_ini
    else:
        y0, y1 = fl.num(phi_ini), fl.num(phi_prime_ini)
    h2, h6 = h / 2.0, h / 6.0
    Y = [(y0, y1)]
    p = 0
    for _ in range(n - 1):
        for _ in range(2):
            t0, t1, t2 = coef[p], coef[p + 1], coef[p + 2]
            p += 3
            k1 = rhs(t0, y0, y1)
            k2 = rhs(t1, y0 + h2 * k1[0], y1 + h2 * k1[1])
            k3 = rhs(t1, y0 + h2 * k2[0], y1 + h2 * k2[1])
            k4 = rhs(t2, y0 + h * k3[0], y1 + h * k3[1])
            y0 = y0 + h6 * (k1[0] + 2.0 * k2[0] + 2.0 * k3[0] + k4[0])
            y1 = y1 + h6 * (k1[1] + 2.0 * k2[1] + 2.0 * k3[1] + k4[1])
        Y.append((y0, y1))
    return Y


def scf_march_plain(p4, loga, a, lnrho, rhoK0: float, rho_rad_ini: float, phi_ini: float,
                    phi_prime_ini: float, attractor: bool) -> torch.Tensor:
    """Plain version of `scf_march`: the host RK4 loop of the JAX
    `_integrate_scf` (:302-355), chain after chain, with the kernel's two
    phases (the background at every sub-step time, then the dependent
    sub-steps), in Python floats (libm), or for a chain that overflows them in
    numpy float64 scalars. Returns (n_c, n, 2) (phi, phi') at every node as a
    CPU tensor, whatever the device of the inputs."""
    lg, av, lr = (t.cpu().tolist() for t in (loga, a, lnrho))
    n = len(lg)
    x_first, dx = lg[0], lg[1] - lg[0]
    h = dx / 2.0
    coef = []
    for i in range(n - 1):
        lga = x_first + float(i) * dx
        for s in range(2):
            x0 = lga + float(s) * h
            for x in (x0, x0 + h / 2.0, x0 + h):
                f = (x - x_first) / dx
                j = min(max(int(math.floor(f)), 0), n - 2)
                w = f - float(j)
                aa = math.exp(x)
                coef.append((aa, 2.0 * aa * aa, aa * aa,
                             math.exp((1.0 - w) * lr[j] + w * lr[j + 1]), rhoK0 / (aa * aa)))
    start = (rho_rad_ini, phi_ini, phi_prime_ini, attractor)
    out = []
    for c4 in p4.cpu().tolist():
        try:
            Y = _scf_chain(coef, n, h, av[0], c4, start, _Libm)
        except (OverflowError, ValueError, ZeroDivisionError):
            with np.errstate(all="ignore"):
                Y = _scf_chain(coef, n, h, av[0], c4, start, _Ieee)
        out.append(Y)
    return torch.tensor(out, dtype=torch.float64)


def scf_march(p4, loga, a, lnrho, rhoK0: float, rho_rad_ini: float, phi_ini: float,
              phi_prime_ini: float, attractor: bool) -> torch.Tensor:
    """phi and phi' = dphi/dtau at every node of the uniform ln a grid `loga`
    ((n_c, n, 2)) for each of the n_c <= 32 potential parameter rows p4
    ((n_c, 4): lambda, alpha, A, B), by RK4 with two sub-steps per interval
    (JAX `_integrate_scf`, background.py:302-355) against the background
    rho_base (its log `lnrho` at the nodes, interpolated linearly) and the
    curvature rhoK0 = Omega_k H0^2. With `attractor`, phi_ini and
    phi_prime_ini scale the attractor values (rho_rad_ini: the radiation
    density at a[0]). CUDA tensors: one launch of the scf_march kernel; CPU
    tensors: the plain version."""
    global scf_launches
    dev = loga.device
    if dev.type == "cpu":
        return scf_march_plain(p4, loga, a, lnrho, rhoK0, rho_rad_ini, phi_ini, phi_prime_ini,
                               attractor)
    if dev.type != "cuda":
        raise ValueError(f"scf_march: unsupported device {dev}")
    n, nc = loga.shape[0], p4.shape[0]
    if p4.shape != (nc, 4) or not 1 <= nc <= 32 or a.shape != (n,) or lnrho.shape != (n,):
        raise ValueError(f"scf_march: bad shapes p4 {tuple(p4.shape)} loga {tuple(loga.shape)} "
                         f"a {tuple(a.shape)} lnrho {tuple(lnrho.shape)} (1 to 32 chains)")
    for t in (p4, loga, a, lnrho):
        if t.dtype != torch.float64 or not t.is_contiguous() or t.device != dev:
            raise ValueError(f"scf_march: every input must be contiguous float64 on {dev}")
    lib = cuda.library()
    coef = torch.empty((n - 1) * 2 * 3 * 5, dtype=torch.float64, device=dev)   # sm::coef_doubles
    Y = torch.empty((nc, n, 2), dtype=torch.float64, device=dev)
    err = lib.scf_march_launch(loga.data_ptr(), a.data_ptr(), lnrho.data_ptr(), n, float(rhoK0),
                               p4.data_ptr(), nc, float(rho_rad_ini), float(phi_ini),
                               float(phi_prime_ini), int(bool(attractor)), coef.data_ptr(),
                               Y.data_ptr(), cuda.stream_ptr(dev))
    cuda.check(err, "scf_march")
    scf_launches += 1
    return Y


def _bisection_midpoints(lo: float, hi: float, levels: int) -> list:
    """The midpoints of the next `levels` levels of the bisection tree below
    [lo, hi], each computed as the sequential bisection computes it."""
    if levels == 0:
        return []
    mid = 0.5 * (lo + hi)
    return [mid] + _bisection_midpoints(lo, mid, levels - 1) \
        + _bisection_midpoints(mid, hi, levels - 1)


def scf_omega_err(march, pars0, ti: int, a_today: float, H0: float, target: float):
    """f_of(tune values) -> f values of the shooting (JAX `omega_err`,
    background.py:643-645): log(Omega_scf today / target) from the last node
    of march(p4), p4 the (n, 4) potential rows of scf_parameters with entry
    ti set to each tune value."""

    def f_of(xs):
        rows = []
        for x in xs:
            pp = list(pars0)
            pp[ti] = x
            rows.append(pp[:4])
        p4 = torch.tensor(rows, dtype=torch.float64)
        last = march(p4)[:, -1].cpu()
        V = _scf_potential(last[:, 0], *p4.unbind(1))[0]
        rho = (last[:, 1] * last[:, 1] / (2.0 * a_today * a_today) + V) / 3.0
        return torch.log(rho / (H0 * H0) / target).tolist()

    return f_of


def shoot_scf(f_of, pars0, ti: int, target: float, attractor: bool, levels: int):
    """The Omega_scf shooting of the JAX package (background.py:649-683) on
    f_of(tune values) -> f values (scf_omega_err): with attractor initial
    conditions and the tuning on lambda, a bisection on (2.0005,
    max(30, 4 sqrt(3 / target))), whose tree is walked as JAX's loop walks it
    (the |f| < 1e-10 break, 48 steps at most, the closer end when both ends
    have one sign) with the midpoints of the next `levels` levels evaluated
    together whenever the walk needs one it lacks; otherwise a secant from the
    passed value, one shot at a time. Returns (the tuned value, the walk: the
    tune values whose f it read, in order)."""
    walk = []
    if ti == 0 and attractor:
        lo, hi = 2.0005, max(30.0, math.sqrt(3.0 / max(target, 1e-3)) * 4.0)
        f_lo, f_hi = f_of([lo, hi])
        walk += [lo, hi]
        if f_lo * f_hi > 0:
            return (lo if abs(f_lo) < abs(f_hi) else hi), walk
        known = {}
        for _ in range(48):
            mid = 0.5 * (lo + hi)
            if mid not in known:
                xs = _bisection_midpoints(lo, hi, max(levels, 1))
                known.update(zip(xs, f_of(xs)))
            f_m = known[mid]
            walk.append(mid)
            if abs(f_m) < 1e-10:
                break
            if f_lo * f_m <= 0:
                hi, f_hi = mid, f_m
            else:
                lo, f_lo = mid, f_m
        return 0.5 * (lo + hi), walk
    x0 = float(pars0[ti])
    (f0,) = f_of([x0])
    x1 = x0 * 1.02 + 1e-3
    walk.append(x0)
    for _ in range(30):
        (f1,) = f_of([x1])
        walk.append(x1)
        if abs(f1) < 1e-9 or f1 == f0:
            break
        x0, f0, x1 = x1, f1, x1 - f1 * (x1 - x0) / (f1 - f0)
    return x1, walk


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

    # interacting dark matter (a^-3) and dark radiation (a^-4) at T_idr =
    # xi T_cmb, Omega0_idr = stat_f_idr xi^4 Omega0_g (background.py:418-430)
    # (zeros without them, which leave every sum below as it was)
    has_idm = params.Omega_idm_dr > 0.0
    Omega0_idm_dr, Omega0_idr = 0.0, 0.0
    rho_idm_dr, rho_idr = torch.zeros_like(a), torch.zeros_like(a)
    if has_idm:
        Omega0_idm_dr = params.Omega_idm_dr
        Omega0_idr = params.stat_f_idr * params.xi_idr ** 4 * Omega0_g
        rho_idm_dr = Omega0_idm_dr * H0**2 / a**3
        rho_idr = Omega0_idr * H0**2 / a**4

    # --- scalar-field dark energy (background.py:600-691): the Klein-Gordon
    # march (`scf_march`, one kernel launch a batch of shots on a card) inside
    # the shooting of scf_parameters[scf_tuning_index] for Omega_scf today
    has_scf = params.Omega_scf != 0.0
    scf_pars, walk, target = (), [], 0.0
    if has_scf:
        base_all = rho_g + rho_b + rho_cdm + rho_ur
        for i in range(n_ncdm):
            base_all = base_all + rho_ncdm[i]
        Omega0_pre = Omega0_g + Omega0_b + Omega0_cdm + Omega0_ur + Omega0_ncdm_tot
        if params.Omega_scf > 0.0:
            target = float(params.Omega_scf)
            lam_budget = 1.0 - params.Omega_k - Omega0_pre - target
        else:
            # the field closes the budget (Omega_Lambda = 0)
            lam_budget = 0.0
            target = 1.0 - params.Omega_k - Omega0_pre
        rho_rad_ini = float(rho_g[0] + rho_ur[0])
        for i in range(n_ncdm):
            rho_rad_ini += float(rho_ncdm[i][0])   # still relativistic at a[0]
        pars0 = list(params.scf_parameters) or [10.0, 0.0, 0.0, 0.0, 1.0, 0.0]
        ti = params.scf_tuning_index
        att = params.attractor_ic_scf
        # with attractor ICs the trailing entries scale the attractor values
        # and default to 1 (input_module.cpp:3201-3203)
        phi_ini, phip_ini = (1.0, 1.0) if att else (pars0[-2], pars0[-1])
        loga_d, a_d = loga.to(device), a.to(device)
        lnrho_d = torch.log(base_all + lam_budget * H0**2).to(device)

        def march(p4):
            return scf_march(p4.to(device), loga_d, a_d, lnrho_d, params.Omega_k * (H0 * H0),
                             rho_rad_ini, phi_ini, phip_ini, att)

        levels = SCF_TREE_LEVELS if torch.device(device).type == "cuda" else 0
        x1, walk = shoot_scf(scf_omega_err(march, pars0, ti, float(a[-1]), H0, target),
                             pars0, ti, target, att, levels)
        pp = list(pars0)
        pp[ti] = x1
        Y = march(torch.tensor([pp[:4]], dtype=f64))[0].cpu()
        phi_scf, phi_prime_scf = Y[:, 0].contiguous(), Y[:, 1].contiguous()
        scf_pars = tuple(float(v) for v in pars0[:ti]) + (x1,) \
            + tuple(float(v) for v in pars0[ti + 1:])
        V_scf, dV_scf, ddV_scf = _scf_potential(phi_scf, *scf_pars[:4])
        kin = phi_prime_scf * phi_prime_scf / (2.0 * a * a)
        rho_scf = (kin + V_scf) / 3.0
        p_scf = (kin - V_scf) / 3.0
        Omega0_scf = float(rho_scf[-1]) / H0**2
    else:
        Omega0_scf = 0.0

    Omega0_others = (Omega0_g + Omega0_b + Omega0_cdm + Omega0_ur + Omega0_ncdm_tot + Omega0_scf
                     + Omega0_idm_dr + Omega0_idr)
    Omega0_lambda = 1.0 - params.Omega_k - Omega0_others
    rho_lambda = torch.full_like(a, Omega0_lambda * H0**2)

    # (background.py:748-751)
    rho_tot = rho_g + rho_b + rho_cdm + rho_ur + rho_lambda
    p_tot = (rho_g + rho_ur + rho_idr) / 3.0 - rho_lambda
    if has_scf:
        rho_tot = rho_tot + rho_scf
        p_tot = p_tot + p_scf
    rho_tot = rho_tot + rho_idm_dr + rho_idr
    for i in range(n_ncdm):
        rho_tot = rho_tot + rho_ncdm[i]
        p_tot = p_tot + p_ncdm[i]
    # the curvature term Omega_k H0^2 / a^2 (background.py:759-764)
    rho_crit = rho_tot + params.Omega_k * H0**2 / a**2
    H = torch.sqrt(rho_crit)
    aH = a * H
    H_prime = -1.5 * a * (rho_tot + p_tot) - params.Omega_k * H0**2 / a
    p_tot_prime = -(4.0 / 3.0) * aH * (rho_g + rho_ur + rho_idr)
    if has_scf:
        # p_scf' = phi'(-phi' H/a - 2/3 dV) (background_functions :564-568)
        p_tot_prime = p_tot_prime + phi_prime_scf * (-phi_prime_scf * H / a
                                                     - 2.0 / 3.0 * dV_scf)
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
    rho_r_tot = rho_g + rho_ur + rho_idr
    rho_m_tot = rho_b + rho_cdm + rho_idm_dr
    if has_scf:
        # the field's pressure counts as radiation, the rest as matter
        # (background_functions :364-365)
        rho_r_tot = rho_r_tot + 3.0 * p_scf
        rho_m_tot = rho_m_tot + (rho_scf - 3.0 * p_scf)
    for i in range(n_ncdm):
        rho_r_tot = rho_r_tot + 3.0 * p_ncdm[i]
        rho_m_tot = rho_m_tot + (rho_ncdm[i] - 3.0 * p_ncdm[i])
    ratio = torch.log(rho_r_tot / rho_m_tot)
    i_eq = int(torch.argmin(torch.abs(ratio)))
    sl = (ratio[i_eq + 1] - ratio[i_eq - 1]) / (loga[i_eq + 1] - loga[i_eq - 1])
    loga_eq = loga[i_eq] - ratio[i_eq] / sl
    z_eq = float(torch.exp(-loga_eq) - 1.0)
    tau_eq = float(interp(loga_eq, loga, tau))

    idx = BgIdx(n_ncdm, has_scf, has_idm)
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
    if has_scf:
        cols.update(rho_scf=rho_scf, p_scf=p_scf, phi_scf=phi_scf, phi_prime_scf=phi_prime_scf,
                    V_scf=V_scf, dV_scf=dV_scf, ddV_scf=ddV_scf)
    if has_idm:
        cols.update(rho_idm_dr=rho_idm_dr, rho_idr=rho_idr)
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
        Omega0_m=Omega0_b + Omega0_cdm + Omega0_ncdm_tot + Omega0_idm_dr,
        Omega0_r=Omega0_g + Omega0_ur + Omega0_idr,
        Omega0_g=Omega0_g, Omega0_b=Omega0_b, Omega0_cdm=Omega0_cdm,
        Omega0_lambda=Omega0_lambda, Omega0_ur=Omega0_ur,
        Omega0_ncdm_tot=Omega0_ncdm_tot, rho_ncdm0=rho_ncdm0, scf_parameters=scf_pars,
        scf_target=target, scf_walk=tuple(walk))
    return res, idx


def tau_of_z(bg: BackgroundResult, z):
    """Conformal time at redshift z (background_tau_of_z, :211)."""
    loga_q = -torch.log1p(torch.as_tensor(z, dtype=bg.loga.dtype, device=bg.loga.device))
    return interp(loga_q, bg.loga, bg.tau_of_loga)

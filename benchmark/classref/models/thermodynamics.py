"""Thermodynamics: RECFAST recombination (with DM energy injection, on the
spot or beyond it), the reionization
schemes (reio_camb with the tau_reio shooting, half_tanh, bins_tanh,
many_tanh, inter, none) and the derived epochs.

Counterpart of classpp_public_tpu/models/thermodynamics.py
(`make_recfast_ctx` :160-250, `_energy_injection_rate` / `_ots_rate`
:253-282, `recfast_derivs` :295, `_compute_recombination_impl` :453-590, the
reionization profiles :641-739, `_tb_march_impl` :756,
`_compute_thermodynamics_impl` :806).

Where each part runs. The serial recurrences are kernels on a CUDA
device: the RECFAST history (20 000 dependent intervals, four RK4 sub-steps
each in the integrated phases) is `recfast_history`, the backward-Euler
baryon-temperature march through reionization (4096 dependent steps) is
`tb_march`; both are csrc/recfast.cu, launched on the stage's device, with
their tables read back to the host. On device="cpu" their plain versions
run: the host Python loops `recfast_history_plain` and `tb_march_plain`. The
RecfastCtx constants and the injection convolution, the reionization
profiles and the tau_reio shooting, the merge and the runtime uniform-ln(tau)
table are float64 numpy/tensor code on the host in both cases; the finished
runtime table moves to the stage's device once.
"""

from __future__ import annotations

import math
from functools import lru_cache
from pathlib import Path
from typing import NamedTuple, Optional

import numpy as np
import torch

from .. import constants as const
from ..config.params import CosmoParams, check_lcdm
from ..config.precision import PrecisionParams
from ..ops.splines import (UniformSpline, interp, spline_d2, spline_integrate,
                           spline_integrate_reverse)
from .background import HOST, BackgroundResult, BgIdx

DATA_DIR = Path(__file__).resolve().parents[1] / "data"

# RECFAST atomic data (reference source/thermodynamics.h:360-420)
_Lambda_H = 8.2245809
_Lambda_He = 51.3
_L_H_ion = 1.096787737e7
_L_H_alpha = 8.225916453e6
_L_He1_ion = 1.98310772e7
_L_He2_ion = 4.389088863e7
_L_He_2s = 1.66277434e7
_L_He_2p = 1.71134891e7
_A2P_s = 1.798287e9
_A2P_t = 177.58
_L_He_2Pt = 1.690871466e7
_L_He_2St = 1.5985597526e7
_L_He2St_ion = 3.8454693845e6
_sigma_He_2Ps = 1.436289e-22
_sigma_He_2Pt = 1.484872e-22
_a_PPB, _b_PPB, _c_PPB, _d_PPB = 4.309, -0.6166, 0.6703, 0.5300
_T_0 = 10.0 ** 0.477121
_a_VF, _b_VF = 10.0 ** (-16.744), 0.711
_T_1 = 10.0 ** 5.114
_a_trip, _b_trip = 10.0 ** (-16.306), 0.761


def _f1(x):
    """Smoothstep 0->1 for x in [-1, 1] (thermodynamics.h:46)."""
    return -0.75 * x * (x * x / 3.0 - 1.0) + 0.5


def _f2(x):
    """Smoothstep 0->1 for x in [0, 1] (thermodynamics.h:47)."""
    return x * x * (0.5 - x / 3.0) * 6.0


def _clip(x, lo, hi):
    return lo if x < lo else (hi if x > hi else x)


class RecfastCtx(NamedTuple):
    """Constants of the RECFAST system for one cosmology (host floats)."""

    fHe: float
    Nnow: float
    Tnow: float
    fu: float
    H0_s: float
    CDB: float
    CDB_He: float
    CB1: float
    CB1_He1: float
    CB1_He2: float
    CR: float
    CK: float
    CK_He: float
    CL: float
    CL_He: float
    CT: float
    Bfact: float
    H_of_z: UniformSpline   # (H, H') on the uniform loga grid, host tensors
    YHe: float
    # DM energy injection: (annihilation [m^3/s/kg], decay [1/s], variation,
    # z, zmax, zmin, f_halo, z_halo) and rho_cdm today [J/m^3]
    # (thermodynamics_onthespot_energy_injection, :1755-1795)
    inj: tuple = (0.0,) * 8
    rho_cdm_J: float = 0.0
    # beyond the spot: ln E of the delayed-deposition convolution over
    # x = -ln(1 + z) (None on the spot; :1810-1870)
    inj_conv: Optional[UniformSpline] = None


@lru_cache(maxsize=4)
def _bbn_table(fname: str = "sBBN_2017.dat"):
    path = Path(fname) if fname.startswith("/") else DATA_DIR / fname
    rows = []
    with open(path) as f:
        for line in f:
            s = line.split("#")[0].split()
            if len(s) == 3:
                rows.append([float(v) for v in s])
    raw = np.array(rows)
    omegab = np.unique(raw[:, 0])
    dneff = np.unique(raw[:, 1])
    yp = raw[:, 2].reshape(len(dneff), len(omegab))
    return omegab, dneff, yp


def helium_from_bbn(omega_b: float, N_eff: float, fname: str = "sBBN_2017.dat") -> float:
    """YHe from the BBN table by bilinear interpolation
    (thermodynamics_helium_from_bbn, thermodynamics_module.cpp:1535)."""
    omegab_g, dneff_g, yp = _bbn_table(fname)
    dneff = N_eff - 3.046
    i = np.clip(np.searchsorted(omegab_g, omega_b) - 1, 0, len(omegab_g) - 2)
    j = np.clip(np.searchsorted(dneff_g, dneff) - 1, 0, len(dneff_g) - 2)
    tx = (omega_b - omegab_g[i]) / (omegab_g[i + 1] - omegab_g[i])
    ty = (dneff - dneff_g[j]) / (dneff_g[j + 1] - dneff_g[j])
    return float(yp[j, i] * (1 - tx) * (1 - ty) + yp[j, i + 1] * tx * (1 - ty)
                 + yp[j + 1, i] * (1 - tx) * ty + yp[j + 1, i + 1] * tx * ty)


def make_recfast_ctx(params: CosmoParams, pr: PrecisionParams,
                     bg: BackgroundResult, idx: BgIdx) -> RecfastCtx:
    YHe = params.YHe if params.YHe is not None else helium_from_bbn(
        params.omega_b, params.N_eff, pr.sBBN_file)
    H0_s = params.H0 * const.c_SI / const.Mpc_over_m
    mu_H = 1.0 / (1.0 - YHe)
    fHe = YHe / (const.not4 * (1.0 - YHe))
    Nnow = 3.0 * H0_s**2 * float(bg.Omega0_b) / (8.0 * math.pi * const.G_SI * mu_H * const.m_H)
    fu = pr.recfast_fudge_H + (pr.recfast_delta_fudge_H if pr.recfast_Hswitch else 0.0)
    Lalpha = 1.0 / _L_H_alpha
    Lalpha_He = 1.0 / _L_He_2p
    hc_k = const.h_P * const.c_SI / const.k_B
    rho_cdm_J = H0_s**2 * 3.0 / (8.0 * math.pi * const.G_SI) * float(bg.Omega0_cdm) * const.c_SI**2
    inj = tuple(float(v) for v in (
        params.annihilation, params.decay, params.annihilation_variation, params.annihilation_z,
        params.annihilation_zmax, params.annihilation_zmin, params.annihilation_f_halo,
        params.annihilation_z_halo))
    loga = bg.loga.to(HOST)
    table = bg.table.to(HOST)
    Hcols = torch.stack([table[:, idx["H"]], table[:, idx["H_prime"]]], dim=1)
    return RecfastCtx(
        fHe=fHe, Nnow=Nnow, Tnow=params.T_cmb, fu=fu, H0_s=H0_s,
        CDB=hc_k * (_L_H_ion - _L_H_alpha),
        CDB_He=hc_k * (_L_He1_ion - _L_He_2s),
        CB1=hc_k * _L_H_ion, CB1_He1=hc_k * _L_He1_ion, CB1_He2=hc_k * _L_He2_ion,
        CR=2.0 * math.pi * (const.m_e / const.h_P) * (const.k_B / const.h_P),
        CK=Lalpha**3 / (8.0 * math.pi), CK_He=Lalpha_He**3 / (8.0 * math.pi),
        CL=const.c_SI * const.h_P / (const.k_B * Lalpha),
        CL_He=const.c_SI * const.h_P / (const.k_B / _L_He_2s),
        CT=(8.0 / 3.0) * (const.sigma_T / (const.m_e * const.c_SI)) * (
            8.0 * math.pi**5 * const.k_B**4 / 15.0 / const.h_P**3 / const.c_SI**3),
        Bfact=hc_k * (_L_He_2p - _L_He_2s),
        H_of_z=UniformSpline.build(float(loga[0]), float(loga[1] - loga[0]), Hcols),
        YHe=YHe, inj=inj, rho_cdm_J=rho_cdm_J,
        inj_conv=_injection_convolution(params, bg, inj, rho_cdm_J, Nnow))


def _ots_rate(inj, rho_cdm_J, z):
    """On-the-spot injection rate [J/m^3/s] at the redshifts z (numpy)
    (thermodynamics_onthespot_energy_injection, :1755-1795)."""
    ann, dec, var, z0, zmax, zmin, f_halo, z_halo = inj
    lz0 = np.log((z0 + 1.0) / (zmax + 1.0))
    with np.errstate(divide="ignore", invalid="ignore"):
        ann_z = np.where(
            z > zmax, ann * np.exp(-var * lz0**2),
            np.where(z > zmin,
                     ann * np.exp(var * (-lz0**2 + np.log((z + 1.0) / (zmax + 1.0)) ** 2)),
                     ann * np.exp(var * (-lz0**2 + np.log((zmin + 1.0) / (zmax + 1.0)) ** 2))))
    u_min = (1.0 + z) / (1.0 + z_halo)
    erfc = (1.0 + 0.278393 * u_min + 0.230389 * u_min**2 + 0.000972 * u_min**3
            + 0.078108 * u_min**4) ** -4
    zp3 = (1.0 + z) ** 3
    return rho_cdm_J**2 / const.c_SI**2 * zp3 * (zp3 * ann_z + f_halo * erfc) + rho_cdm_J * zp3 * dec


def _injection_convolution(params, bg, inj, rho_cdm_J, Nnow):
    """Beyond the spot (`on the spot = no` with annihilation): ln E(z) of the
    delayed-deposition convolution E(z) = int dz' G(z, z') E_ots(z'),
    G = factor (1+z)^8 / (1+z')^7.5 exp(2/3 factor ((1+z)^1.5 - (1+z')^1.5)),
    as the reference's discrete loop (thermodynamics_module.cpp:1810-1870):
    trapezoid with dz' = 1, half weight on the first point, stopping after the
    first step whose integrand drops to <= 2% of the first; on 1024 nodes
    uniform in -ln(1 + z) up to z = 2e4 (make_recfast_ctx,
    classpp_public_tpu thermodynamics.py:199-243). None on the spot."""
    if params.on_the_spot or not inj[0] > 0.0:
        return None
    om_m = float(bg.Omega0_b) + float(bg.Omega0_cdm)
    factor = const.sigma_T * Nnow / (float(bg.H0) / const.Mpc_over_m) / math.sqrt(om_m)
    nz_c, nstep = 1024, 4096
    zg = np.expm1(np.linspace(0.0, math.log1p(2.0e4), nz_c))
    zc = zg[:, None]

    def integrand(zp):
        return (factor * (1.0 + zc) ** 8 / (1.0 + zp) ** 7.5
                * np.exp(np.minimum(2.0 / 3.0 * factor * ((1.0 + zc) ** 1.5 - (1.0 + zp) ** 1.5),
                                    700.0))
                * _ots_rate(inj, rho_cdm_J, zp))

    first = integrand(zc)[:, 0]
    integ = integrand(zc + np.arange(1.0, nstep + 1.0)[None, :])      # (nz, nstep)
    below = integ <= 0.02 * first[:, None]
    stop = np.where(below.any(axis=1), np.argmax(below, axis=1), nstep - 1)
    keep = np.arange(nstep)[None, :] <= stop[:, None]                # inclusive
    E = 0.5 * first + np.sum(np.where(keep, integ, 0.0), axis=1)
    x = -np.log1p(zg)
    xu = np.linspace(x[-1], x[0], nz_c)
    lnE = np.interp(xu, x[::-1], np.log(np.maximum(E, 1e-300))[::-1])
    return UniformSpline.build(float(xu[0]), float(xu[1] - xu[0]), torch.as_tensor(lnE)[:, None])


# order of rf::Params in csrc/recfast.cuh: the RecfastCtx scalars, the
# precision parameters, the derived constants the history reads, and the
# energy injection (inj_on: 0 or 1; inj_bos: 1 when the rate is the ln E
# spline passed beside the H spline; the eight RecfastCtx.inj scalars)
RF_PARAMS = (
    "fHe", "Nnow", "Tnow", "fu", "H0_s", "CDB", "CDB_He", "CB1", "CB1_He1", "CB1_He2",
    "CR", "CK", "CK_He", "CL", "CL_He", "CT", "Bfact", "YHe",
    "trigH", "trigH2", "trigHe2", "AG1", "AG2", "zG1", "zG2", "wG1", "wG2", "H_frac",
    "fudge_He", "z_init", "zHe1", "dzHe1", "zHe2", "dzHe2", "zHe3", "dzHe3", "trigHe",
    "dtrigHe", "dtrigH",
    "c", "not4", "conv", "dop_fac", "CL_PSt", "E_trip_ion", "E_2St", "wb_fac", "dk_fac",
    "T_0", "T_1", "a_VF", "a_trip",
    "inj_on", "inj_bos", "ann", "dec", "ann_var", "ann_z", "ann_zmax", "ann_zmin", "f_halo",
    "z_halo", "rho_cdm_J", "hPc", "kB", "L_H_ion", "L_H_alpha",
)
RECO_COLUMNS = ("z", "xe", "Tb", "wb", "cb2", "dkappadtau")


def recfast_params(ctx: RecfastCtx, pr: PrecisionParams) -> torch.Tensor:
    """The RF_PARAMS vector (float64, host) of one cosmology."""
    c, hP, kB, mH = const.c_SI, const.h_P, const.k_B, const.m_H
    v = dict(
        fHe=ctx.fHe, Nnow=ctx.Nnow, Tnow=ctx.Tnow, fu=ctx.fu, H0_s=ctx.H0_s, CDB=ctx.CDB,
        CDB_He=ctx.CDB_He, CB1=ctx.CB1, CB1_He1=ctx.CB1_He1, CB1_He2=ctx.CB1_He2, CR=ctx.CR,
        CK=ctx.CK, CK_He=ctx.CK_He, CL=ctx.CL, CL_He=ctx.CL_He, CT=ctx.CT, Bfact=ctx.Bfact,
        YHe=ctx.YHe,
        trigH=pr.recfast_x_H0_trigger, trigH2=pr.recfast_x_H0_trigger2,
        trigHe2=pr.recfast_x_He0_trigger2, AG1=pr.recfast_AGauss1, AG2=pr.recfast_AGauss2,
        zG1=pr.recfast_zGauss1, zG2=pr.recfast_zGauss2, wG1=pr.recfast_wGauss1,
        wG2=pr.recfast_wGauss2, H_frac=pr.recfast_H_frac, fudge_He=pr.recfast_fudge_He,
        z_init=pr.recfast_z_initial, zHe1=pr.recfast_z_He_1, dzHe1=pr.recfast_delta_z_He_1,
        zHe2=pr.recfast_z_He_2, dzHe2=pr.recfast_delta_z_He_2, zHe3=pr.recfast_z_He_3,
        dzHe3=pr.recfast_delta_z_He_3, trigHe=pr.recfast_x_He0_trigger,
        dtrigHe=pr.recfast_x_He0_trigger_delta, dtrigH=pr.recfast_x_H0_trigger_delta,
        c=c, not4=const.not4, conv=c / const.Mpc_over_m,
        dop_fac=2.0 * kB / (mH * const.not4 * c**2),
        CL_PSt=hP * c * (_L_He_2Pt - _L_He_2St) / kB,
        E_trip_ion=hP * c * _L_He2St_ion / kB, E_2St=hP * c * _L_He_2St / kB,
        wb_fac=kB / (c**2 * mH), dk_fac=ctx.Nnow * const.sigma_T * const.Mpc_over_m,
        T_0=_T_0, T_1=_T_1, a_VF=_a_VF, a_trip=_a_trip,
        inj_on=float(ctx.inj[0] != 0.0 or ctx.inj[1] != 0.0),
        inj_bos=float(ctx.inj_conv is not None), rho_cdm_J=ctx.rho_cdm_J, hPc=hP * c, kB=kB,
        L_H_ion=_L_H_ion, L_H_alpha=_L_H_alpha,
        **dict(zip(("ann", "dec", "ann_var", "ann_z", "ann_zmax", "ann_zmin", "f_halo", "z_halo"),
                   ctx.inj)))
    return torch.tensor([float(v[n]) for n in RF_PARAMS], dtype=torch.float64)


def _spline_evaluator(spl: UniformSpline):
    """Host scalar evaluation of a one-column UniformSpline at x (cubes as
    pow calls, as recfast.cuh's)."""
    y, y2 = spl.y[:, 0].tolist(), spl.y2[:, 0].tolist()
    x0, dx, n = spl.x0, spl.dx, spl.n
    h2 = dx * dx / 6.0

    def ev(x):
        t = (x - x0) / dx
        i = min(max(int(math.floor(t)), 0), n - 2)
        b = t - i
        a = 1.0 - b
        return a * y[i] + b * y[i + 1] + (a**3 - a) * h2 * y2[i] + (b**3 - b) * h2 * y2[i + 1]

    return ev


def _injection_rate(p: dict, inj_conv):
    """The energy injection rate [J/m^3/s] at redshift z as a host scalar
    function (_energy_injection_rate and _ots_rate, classpp_public_tpu
    thermodynamics.py:253-282): exp of the ln E spline beyond the spot, the
    on-the-spot form otherwise."""
    if p["inj_bos"] != 0.0:
        lnE = _spline_evaluator(inj_conv)
        return lambda z: math.exp(lnE(-math.log1p(z)))
    ann, dec, var, z0 = p["ann"], p["dec"], p["ann_var"], p["ann_z"]
    zmax, zmin, f_halo, z_halo = p["ann_zmax"], p["ann_zmin"], p["f_halo"], p["z_halo"]
    rho, c = p["rho_cdm_J"], p["c"]
    log, exp = math.log, math.exp

    def rate(z):
        lz0 = log((z0 + 1.0) / (zmax + 1.0))
        if z > zmax:
            ann_z = ann * exp(-var * lz0**2)
        elif z > zmin:
            ann_z = ann * exp(var * (-lz0**2 + log((z + 1.0) / (zmax + 1.0)) ** 2))
        else:
            ann_z = ann * exp(var * (-lz0**2 + log((zmin + 1.0) / (zmax + 1.0)) ** 2))
        u_min = (1.0 + z) / (1.0 + z_halo)
        erfc = (1.0 + 0.278393 * u_min + 0.230389 * u_min**2 + 0.000972 * u_min**3
                + 0.078108 * u_min**4) ** -4
        zp3 = (1.0 + z) ** 3
        return rho**2 / c**2 * zp3 * (zp3 * ann_z + f_halo * erfc) + rho * zp3 * dec

    return rate


def _hubble_evaluator(spl: UniformSpline, conv: float):
    """Host scalar (H, dH/dz) in 1/s at redshift z, from the (H, H') spline."""
    yH, yHp = spl.y[:, 0].tolist(), spl.y[:, 1].tolist()
    y2H, y2Hp = spl.y2[:, 0].tolist(), spl.y2[:, 1].tolist()
    x0, dx, n = spl.x0, spl.dx, spl.n
    h2 = dx * dx / 6.0

    def hubble(z):
        t = (-math.log1p(z) - x0) / dx
        i = min(max(int(math.floor(t)), 0), n - 2)
        b = t - i
        a = 1.0 - b
        ca, cb = (a**3 - a) * h2, (b**3 - b) * h2
        H = a * yH[i] + b * yH[i + 1] + ca * y2H[i] + cb * y2H[i + 1]
        Hp = a * yHp[i] + b * yHp[i + 1] + ca * y2Hp[i] + cb * y2Hp[i + 1]
        return H * conv, -Hp / H * conv

    return hubble


def make_recfast_derivs(p: dict, H_of_z: UniformSpline, inj_conv=None):
    """RECFAST 1.5 derivatives d(x_H, x_He, Tmat)/dz as a host scalar
    function (recfast_derivs, classpp_public_tpu thermodynamics.py:295;
    reference thermodynamics_module.cpp:3727-3960, Heswitch=6, Hswitch on),
    with the DM energy injection terms when p["inj_on"] (:3894-3904,
    :3952-3962). p: RF_PARAMS by name; inj_conv: the ln E spline beyond the
    spot."""
    hubble = _hubble_evaluator(H_of_z, p["conv"])
    inj_on = p["inj_on"] != 0.0
    inj_rate = _injection_rate(p, inj_conv) if inj_on else None
    hPc, kB, L_H_ion, L_H_alpha = p["hPc"], p["kB"], p["L_H_ion"], p["L_H_alpha"]
    fHe, Nnow, Tnow, fu, H0_s = p["fHe"], p["Nnow"], p["Tnow"], p["fu"], p["H0_s"]
    CR, CDB, CDB_He, CK, CK_He = p["CR"], p["CDB"], p["CDB_He"], p["CK"], p["CK_He"]
    CL, CL_He, CT, Bfact = p["CL"], p["CL_He"], p["CT"], p["Bfact"]
    trigH, trigH2, trigHe2 = p["trigH"], p["trigH2"], p["trigHe2"]
    AG1, AG2, zG1, zG2, wG1, wG2 = p["AG1"], p["AG2"], p["zG1"], p["zG2"], p["wG1"], p["wG2"]
    H_frac, fudge_He = p["H_frac"], p["fudge_He"]
    c, dop_fac = p["c"], p["dop_fac"]
    CL_PSt, E_trip_ion, E_2St = p["CL_PSt"], p["E_trip_ion"], p["E_2St"]
    T_0, T_1, a_VF, a_trip = p["T_0"], p["T_1"], p["a_VF"], p["a_trip"]
    sqrt_pi = math.sqrt(math.pi)
    exp, sqrt, log1p = math.exp, math.sqrt, math.log1p

    def derivs(z, y0, y1, y2):
        x_H = _clip(y0, 0.0, 1.0)
        x_He = _clip(y1, 0.0, 1.0)
        Tmat = max(y2, 1e-3)
        x = x_H + fHe * x_He
        zp1 = 1.0 + z
        n = Nnow * zp1**3
        n_He = fHe * n
        Trad = Tnow * zp1
        Hz, dHdz = hubble(z)

        Rdown = 1e-19 * _a_PPB * (Tmat / 1e4) ** _b_PPB / (1.0 + _c_PPB * (Tmat / 1e4) ** _d_PPB)
        CRT15 = (CR * Tmat) ** 1.5
        Rup = Rdown * CRT15 * exp(-CDB / Tmat)
        sq_0 = sqrt(Tmat / T_0)
        sq_1 = sqrt(Tmat / T_1)
        Rdown_He = a_VF / (sq_0 * (1.0 + sq_0) ** (1.0 - _b_VF) * (1.0 + sq_1) ** (1.0 + _b_VF))
        Rup_He = 4.0 * Rdown_He * CRT15 * exp(-CDB_He / Tmat)
        lz = log1p(z)
        K = CK / Hz * (1.0 + AG1 * exp(-(((lz - zG1) / wG1) ** 2))
                       + AG2 * exp(-(((lz - zG2) / wG2) ** 2)))
        Rdown_trip = a_trip / (sq_0 * (1.0 + sq_0) ** (1.0 - _b_trip)
                               * (1.0 + sq_1) ** (1.0 + _b_trip))
        Rup_trip = Rdown_trip * exp(-E_trip_ion / Tmat) * CRT15 * 4.0 / 3.0

        he_active = 5e-9 <= x_He <= trigHe2
        one_m_xHe = max(1.0 - x_He, 1e-30)
        one_m_xH = max(1.0 - x_H, 1e-30)
        if he_active:
            tauHe_s = _A2P_s * CK_He * 3.0 * n_He * one_m_xHe / Hz
            pHe_s = (1.0 - exp(-tauHe_s)) / max(tauHe_s, 1e-30)
            if x_H < 0.9999999:
                Doppler_s = c * _L_He_2p * sqrt(dop_fac * Tmat)
                gamma_2Ps = (3.0 * _A2P_s * fHe * one_m_xHe * c**2
                             / (sqrt_pi * _sigma_He_2Ps * 8.0 * math.pi * Doppler_s * one_m_xH)
                             / (c * _L_He_2p) ** 2)
                AHcon = _A2P_s / (1.0 + 0.36 * gamma_2Ps**fudge_He)
                K_He_denom = (_A2P_s * pHe_s + AHcon) * 3.0 * n_He * one_m_xHe
            else:
                K_He_denom = _A2P_s * pHe_s * 3.0 * n_He * one_m_xHe
            K_He = 1.0 / max(K_He_denom, 1e-300)
            tauHe_t = _A2P_t * n_He * one_m_xHe * 3.0 / (8.0 * math.pi * Hz * _L_He_2Pt**3)
            pHe_t = (1.0 - exp(-tauHe_t)) / max(tauHe_t, 1e-30)
            if x_H >= 0.99999:
                num = _A2P_t * pHe_t
            else:
                Doppler_t = c * _L_He_2Pt * sqrt(dop_fac * Tmat)
                gamma_2Pt = (3.0 * _A2P_t * fHe * one_m_xHe * c**2
                             / (sqrt_pi * _sigma_He_2Pt * 8.0 * math.pi * Doppler_t * one_m_xH)
                             / (c * _L_He_2Pt) ** 2)
                AHcon_t = _A2P_t / (1.0 + 0.66 * gamma_2Pt**0.9) / 3.0
                num = _A2P_t * pHe_t + AHcon_t
            CfHe_t_num = num * exp(-CL_PSt / Tmat)
            den = Rup_trip + CfHe_t_num
            CfHe_t = CfHe_t_num / den if den != 0.0 else math.nan
        else:
            K_He = CK_He / Hz
            CfHe_t = 0.0

        if x_H < trigH2:
            KLn = K * _Lambda_H * n * one_m_xH
            C_peebles = (1.0 + KLn) / (1.0 / fu + KLn / fu + K * Rup * n * one_m_xH)
        else:
            C_peebles = 1.0
        if inj_on:
            energy_rate = inj_rate(z)
            xc = _clip(x, 0.0, 1.0)
        if x_H > trigH:
            dxH = 0.0
        else:
            dxH = (x * x_H * n * Rdown - Rup * one_m_xH * exp(-CL / Tmat)) \
                * C_peebles / (Hz * zp1)
            if inj_on:
                # extra ionization (Slatyer/Poulin chi_ion fit); d/dz, so it
                # subtracts
                chi_ion_H = 0.369202 * (1.0 - xc**0.463929) ** 1.70237 if x < 1.0 else 0.0
                dxH = dxH - energy_rate * chi_ion_H / n \
                    * (1.0 / L_H_ion + (1.0 - C_peebles) / L_H_alpha) / (hPc * Hz * zp1)

        if x_He < 1e-15:
            dxHe = 0.0
        else:
            He_Boltz = exp(min(Bfact / Tmat, 680.0))
            KB = K_He * n_He * one_m_xHe * He_Boltz
            dxHe = ((x * x_He * n * Rdown_He - Rup_He * one_m_xHe * exp(-CL_He / Tmat))
                    * (1.0 + KB * _Lambda_He)) / (Hz * zp1 * (1.0 + KB * (_Lambda_He + Rup_He)))
            dxHe = dxHe + (x * x_He * n * Rdown_trip
                           - one_m_xHe * 3.0 * Rup_trip * exp(-E_2St / Tmat)) \
                * CfHe_t / (Hz * zp1)

        xs = max(x, 1e-30)
        timeTh = (1.0 / (CT * Trad**4)) * (1.0 + x + fHe) / xs
        timeH = 2.0 / (3.0 * H0_s * zp1**1.5)
        if timeTh < H_frac * timeH:
            epsilon = Hz * (1.0 + x + fHe) / (CT * Trad**3 * xs)
            dT = (Tnow + epsilon * ((1.0 + fHe) / (1.0 + fHe + x)) * ((dxH + fHe * dxHe) / xs)
                  - epsilon * dHdz / Hz + 3.0 * epsilon / zp1)
        else:
            dT = (CT * Trad**4 * x / (1.0 + x + fHe) * (Tmat - Trad) / (Hz * zp1)
                  + 2.0 * Tmat / zp1)
            if inj_on:
                # injection heating (chi_heat fit)
                fit = 0.996857 * (1.0 - (1.0 - xc**0.300134) ** 1.51035)
                chi_heat = (fit if fit < 1.0 else 1.0) if x < 1.0 else 1.0
                dT = dT - 2.0 / (3.0 * kB) * energy_rate * chi_heat / n / (1.0 + fHe + x) \
                    / (Hz * zp1)
        return dxH, dxHe, dT

    return derivs


class RecoTable(NamedTuple):
    z: torch.Tensor          # ascending
    xe: torch.Tensor
    Tb: torch.Tensor
    wb: torch.Tensor
    cb2: torch.Tensor
    dkappadtau: torch.Tensor


def recfast_history_plain(rp: torch.Tensor, H_of_z: UniformSpline, Nz: int,
                          inj_conv: Optional[UniformSpline] = None) -> torch.Tensor:
    """Plain version of `recfast_history`: a host loop over the Nz intervals
    of the descending z grid, with the staged Saha approximations of
    thermodynamics_recombination_with_recfast (:3461-3647). In the Saha
    regimes A-D the state is pinned, so the RK4 candidate (unused there) is
    not integrated. inj_conv: the ln E spline beyond the spot (rp's inj_bos).
    Returns (6, Nz) in RECO_COLUMNS order, ascending z."""
    p = dict(zip(RF_PARAMS, rp.tolist()))
    derivs = make_recfast_derivs(p, H_of_z, inj_conv)
    z_init, fHe, Tnow, Nnow, CR = p["z_init"], p["fHe"], p["Tnow"], p["Nnow"], p["CR"]
    zHe1, dzHe1, zHe2, dzHe2 = p["zHe1"], p["dzHe1"], p["zHe2"], p["dzHe2"]
    zHe3, dzHe3 = p["zHe3"], p["dzHe3"]
    trigHe, dtrigHe, trigH, dtrigH = p["trigHe"], p["dtrigHe"], p["trigH"], p["dtrigH"]
    YHe, not4, wb_fac, dk_fac = p["YHe"], p["not4"], p["wb_fac"], p["dk_fac"]
    exp, log, sqrt = math.exp, math.log, math.sqrt

    def saha(z, CB1_x, factor=1.0):
        return factor * exp(1.5 * log(CR * Tnow / (1.0 + z)) - CB1_x / (Tnow * (1.0 + z))) / Nnow

    def rk4_interval(y, za, zb, nsub=4):
        h = (zb - za) / nsub
        y0, y1, y2 = y
        for i in range(nsub):
            zz = za + i * h
            k1 = derivs(zz, y0, y1, y2)
            k2 = derivs(zz + h / 2, y0 + h / 2 * k1[0], y1 + h / 2 * k1[1], y2 + h / 2 * k1[2])
            k3 = derivs(zz + h / 2, y0 + h / 2 * k2[0], y1 + h / 2 * k2[1], y2 + h / 2 * k2[2])
            k4 = derivs(zz + h, y0 + h * k3[0], y1 + h * k3[1], y2 + h * k3[2])
            y0 = y0 + h / 6 * (k1[0] + 2 * k2[0] + 2 * k3[0] + k4[0])
            y1 = y1 + h / 6 * (k1[1] + 2 * k2[1] + 2 * k3[1] + k4[1])
            y2 = y2 + h / 6 * (k1[2] + 2 * k2[2] + 2 * k3[2] + k4[2])
        return y0, y1, y2

    y = (1.0, 1.0, Tnow * (1.0 + z_init))
    rows = []
    for i in range(Nz):
        za = z_init * (Nz - i) / Nz
        zb = z_init * (Nz - i - 1) / Nz
        z = zb
        Trad = Tnow * (1.0 + z)
        if z > zHe1 + dzHe1:                         # A: fully ionized
            x0 = 1.0 + 2.0 * fHe
            y_new = (1.0, 1.0, Trad)
        elif z > zHe2 + dzHe2:                       # B: HeIII Saha
            rhs = saha(z, p["CB1_He2"])
            x0_He3 = 0.5 * (sqrt((rhs - 1.0 - fHe) ** 2 + 4.0 * (1.0 + 2.0 * fHe) * rhs)
                            - (rhs - 1.0 - fHe))
            if z > zHe1 - dzHe1:
                w = _f1(_clip((zHe1 - z) / dzHe1, -1.0, 1.0))
                x0 = w * x0_He3 + (1.0 - w) * (1.0 + 2.0 * fHe)
            else:
                x0 = x0_He3
            y_new = (1.0, 1.0, Trad)
        elif z > zHe3 + dzHe3:                       # C: HeIII done
            if z > zHe2 - dzHe2:
                rhs = saha(z, p["CB1_He2"])
                x0_He3 = 0.5 * (sqrt((rhs - 1.0 - fHe) ** 2 + 4.0 * (1.0 + 2.0 * fHe) * rhs)
                                - (rhs - 1.0 - fHe))
                w = _f1(_clip((zHe2 - z) / dzHe2, -1.0, 1.0))
                x0 = w * (1.0 + fHe) + (1.0 - w) * x0_He3
            else:
                x0 = 1.0 + fHe
            y_new = (1.0, 1.0, Trad)
        else:
            rhs1 = saha(z, p["CB1_He1"], 4.0)
            x0_He1 = 0.5 * (sqrt((rhs1 - 1.0) ** 2 + 4.0 * (1.0 + fHe) * rhs1) - (rhs1 - 1.0))
            if y[1] > trigHe:                         # D: HeI Saha
                if z > zHe3 - dzHe3:
                    w = _f1(_clip((zHe3 - z) / dzHe3, -1.0, 1.0))
                    x0 = w * x0_He1 + (1.0 - w) * (1.0 + fHe)
                else:
                    x0 = x0_He1
                y_new = (1.0, (x0 - 1.0) / fHe, Trad)
            else:
                rhsH = saha(z, p["CB1"])
                x_H0_saha = 0.5 * (sqrt(rhsH**2 + 4.0 * rhsH) - rhsH)
                y_int = rk4_interval(y, za, zb)
                if y[0] > trigH:                      # E: He integrated, H Saha
                    y_new = (x_H0_saha, y_int[1], y_int[2])
                    x0_new = y_new[0] + fHe * y_new[1]
                    if trigHe - y_int[1] < dtrigHe:
                        w = _f2(_clip((trigHe - y_int[1]) / dtrigHe, 0.0, 1.0))
                        x0 = w * x0_new + (1.0 - w) * x0_He1
                    else:
                        x0 = x0_new
                else:                                 # F: full integration
                    y_new = y_int
                    if trigH - y_int[0] < dtrigH:
                        w = _f2(_clip((trigH - y_int[0]) / dtrigH, 0.0, 1.0))
                        x0 = w * y_int[0] + (1.0 - w) * x_H0_saha + fHe * y_int[1]
                    else:
                        x0 = y_int[0] + fHe * y_int[1]
        dTdz = derivs(z, *y_new)[2]
        Tb = y_new[2]
        wb = wb_fac * (1.0 + (1.0 / not4 - 1.0) * YHe + x0 * (1.0 - YHe)) * Tb
        cb2 = wb * (1.0 + (1.0 + z) * dTdz / Tb / 3.0)
        rows.append((z, x0, Tb, wb, cb2, (1.0 + z) ** 2 * dk_fac * x0))
        y = y_new
    return torch.tensor(rows[::-1], dtype=torch.float64).T.contiguous()


def recfast_history(rp: torch.Tensor, H_of_z: UniformSpline, Nz: int,
                    inj_conv: Optional[UniformSpline] = None) -> torch.Tensor:
    """The RECFAST history, (6, Nz) in RECO_COLUMNS order, ascending z: the
    kernel recfast_history (csrc/recfast.cu) for CUDA tensors, the plain
    loop for CPU tensors. rp: the RF_PARAMS vector; H_of_z: the (H, H')
    spline over ln a; inj_conv: the (n, 1) ln E spline of the injection
    beyond the spot when rp's inj_bos is set, else None; all on rp's
    device."""
    dev = rp.device
    bos = inj_conv is not None
    return recfast_history_plain(rp, H_of_z, Nz, inj_conv)


def compute_recombination(pr: PrecisionParams, ctx: RecfastCtx, device="cpu") -> RecoTable:
    """The RECFAST table on the host, computed on `device` (the kernel on a
    CUDA device, the plain loop on the CPU)."""
    dev = torch.device(device)

    def on_dev(spl):
        spl = spl.to(dev)
        return spl._replace(y=spl.y.contiguous(), y2=spl.y2.contiguous())

    out = recfast_history(recfast_params(ctx, pr).to(dev), on_dev(ctx.H_of_z), pr.recfast_Nz0,
                          None if ctx.inj_conv is None else on_dev(ctx.inj_conv))
    return RecoTable(*out.cpu())


class ThIdx:
    """Column indices of the thermodynamics runtime table (index_th_*)."""

    names = ["xe", "dkappa", "ddkappa", "dddkappa", "exp_m_kappa", "g", "dg", "ddg",
             "Tb", "cb2", "tau_d_depth", "kappa"]
    ix = {n: i for i, n in enumerate(names)}
    n = len(names)


class ThermoResult(NamedTuple):
    lntau_spline: UniformSpline   # runtime table on the stage's device, ThIdx columns
    z_grid: torch.Tensor          # merged z-grid tables (host)
    xe_of_z: torch.Tensor
    Tb_of_z: torch.Tensor
    cb2_of_z: torch.Tensor
    dkappa_of_z: torch.Tensor
    YHe: float
    fHe: float
    z_reio: float
    tau_reio: float
    z_rec: float
    tau_rec: float
    rs_rec: float
    z_star: float
    tau_star: float
    rs_star: float
    ra_star: float
    z_d: float
    tau_d: float
    rs_d: float
    angular_rescaling: float
    tau_cut: float = None
    ra_rec: float = None
    rd_rec: float = None
    rd_star: float = None
    n_e: float = None


def _xe_reio_camb(z, z_reio, z_start, xe_before, xe_after, fHe, params: CosmoParams,
                  half: bool = False):
    """reio_camb / reio_half_tanh ionization function
    (thermodynamics_reionization_function, thermodynamics_module.cpp:1893;
    half: plain tanh to xe_after, no He term, :1936); broadcasts over
    tensors."""
    ex = params.reionization_exponent
    arg = ((1.0 + z_reio) ** ex - (1.0 + z) ** ex) / (ex * (1.0 + z_reio) ** (ex - 1.0)) \
        / params.reionization_width
    if half:
        xe = (xe_after - xe_before) * torch.tanh(arg) + xe_before
    else:
        xe = (xe_after - xe_before) * (torch.tanh(arg) + 1.0) / 2.0 + xe_before
        arg_he = (params.helium_fullreio_redshift - z) / params.helium_fullreio_width
        xe = xe + fHe * (torch.tanh(arg_he) + 1.0) / 2.0
    return torch.where(z > z_start, xe_before, xe)


def _xe_reio_bins_tanh(z, params: CosmoParams, xe_top: float, fHe: float):
    """reio_bins_tanh profile (thermodynamics_module.cpp:1958-2016, bin setup
    :2358-2446). Returns (xe(z), z_start); xe_top: the recombination xe at
    z_start."""
    zi, xi = list(params.binned_reio_z), list(params.binned_reio_xe)
    if len(zi) < 2:
        raise ValueError("binned reio requires at least two bin centers")
    z_top = zi[-1] + 2.0 * (zi[-1] - zi[-2])
    z_arr = [max(2.0 * zi[0] - zi[1], 0.0)] + zi + [z_top]
    xe_arr = [1.0 + fHe] + xi + [xe_top]
    n = len(z_arr)
    sharp = params.binned_reio_step_sharpness
    xe = torch.full_like(z, xe_arr[0])
    for i in range(n - 1):
        if i == n - 2:
            z_jump = z_arr[i] + 0.5 * (z_arr[i] - z_arr[i - 1])
        else:
            z_jump = 0.5 * (z_arr[i + 1] + z_arr[i])
        val = xe_arr[i] + 0.5 * (torch.tanh((z - z_jump) / sharp) + 1.0) \
            * (xe_arr[i + 1] - xe_arr[i])
        xe = torch.where((z >= z_arr[i]) & (z < z_arr[i + 1]), val, xe)
    return torch.where(z >= z_arr[-1], xe_arr[-1], xe), z_top


def _special_xe(values, fHe: float, name: str):
    """Node values: >= 0 as given, -1 for H + singly ionized He, -2 for H +
    doubly ionized He (input_module.cpp reio_many_tanh / reio_inter)."""
    out = []
    for v in values:
        if v >= 0.0:
            out.append(v)
        elif -1.1 < v < -0.9:
            out.append(1.0 + fHe)
        elif -2.1 < v < -1.9:
            out.append(1.0 + 2.0 * fHe)
        else:
            raise ValueError(f"{name} entry {v} invalid (>=0, -1 or -2)")
    return out


def _xe_reio_many_tanh(z, params: CosmoParams, pr, xe_top: float, fHe: float):
    """reio_many_tanh profile (thermodynamics_module.cpp:2021-2060, setup
    :2448-2560): tanh jumps walking down from the recombination value."""
    zi = list(params.many_tanh_z)
    xi = _special_xe(params.many_tanh_xe, fHe, "many_tanh_xe")
    if not zi:
        raise ValueError("reio_many_tanh requires at least one jump center")
    width = params.many_tanh_width
    z_top = zi[-1] + pr.reionization_start_factor * width
    z_arr = [max(zi[0] - pr.reionization_start_factor * width, 0.0)] + zi + [z_top]
    xe_arr = [xi[0]] + xi + [xe_top]
    n = len(z_arr)
    xe = torch.full_like(z, xe_arr[-1])
    for jump in range(1, n - 1):
        before = xe_arr[n - 1 - jump] - xe_arr[n - jump]
        xe = xe + before * (1.0 - torch.tanh((z - z_arr[n - 1 - jump]) / width)) / 2.0
    xe = torch.where(z <= z_arr[0], xe_arr[0], xe)
    return torch.where(z >= z_arr[-1], xe_arr[-1], xe), z_top


def _xe_reio_inter(z, params: CosmoParams, xe_top: float, fHe: float):
    """reio_inter profile (thermodynamics_module.cpp:2063-2110, setup
    :2562-2640): piecewise-linear xe(z); the last node's xe must be 0 and
    becomes the recombination value there."""
    zi, xi_in = list(params.reio_inter_z), list(params.reio_inter_xe)
    if not zi or zi[0] != 0.0:
        raise ValueError("reio_inter_z must start at z=0")
    if xi_in[-1] != 0.0:
        raise ValueError("last reio_inter_xe must be 0 (recombination value)")
    xi = _special_xe(xi_in[:-1], fHe, "reio_inter_xe") + [xe_top]
    f64 = torch.float64
    return interp(z, torch.tensor(zi, dtype=f64), torch.tensor(xi, dtype=f64)), zi[-1]


def tb_march_plain(z_fine, xe_fine, H_fine, rho_g_fine, rho_b_fine, consts,
                   Tb_start: float, idx_start: int):
    """Plain version of `tb_march`: the backward-Euler Tb march through
    reionization on the fine z grid (thermodynamics_reionization_sample
    :2880-2960) as a host scalar loop. consts: (kappa_fac, YHe, T_cmb, m_H,
    m_e, not4). Returns (Tb, dTb/dz) at every node."""
    kappa_fac, YHe, T_cmb, m_H, m_e, not4 = (float(v) for v in consts)
    z, xe, H = z_fine.tolist(), xe_fine.tolist(), H_fine.tolist()
    rg, rb = rho_g_fine.tolist(), rho_b_fine.tolist()
    n = len(z)

    def dTdz(i, Tb):
        opacity = (1.0 + z[i]) ** 2 * kappa_fac * xe[i]
        mu = m_H / (1.0 + (1.0 / not4 - 1.0) * YHe + xe[i] * (1.0 - YHe))
        return (2.0 / (1.0 + z[i]) * Tb
                - 2.0 * mu / m_e * 4.0 * rg[i] / 3.0 / rb[i] * opacity
                * (T_cmb * (1.0 + z[i]) - Tb) / H[i])

    dzf = z[1] - z[0]
    Tb = Tb_start
    out = [0.0] * n
    out[n - 1] = Tb_start
    for i in range(n - 2, -1, -1):
        if i < idx_start:
            Tb = Tb - dTdz(i + 1, Tb) * dzf
        out[i] = Tb
    d = [dTdz(i, out[i]) for i in range(n)]
    return torch.tensor(out, dtype=torch.float64), torch.tensor(d, dtype=torch.float64)


def tb_march(z_fine, xe_fine, H_fine, rho_g_fine, rho_b_fine, consts,
             Tb_start: float, idx_start: int):
    """(Tb, dTb/dz) on the fine z grid: the kernel tb_march (csrc/recfast.cu)
    for CUDA tensors, the plain loop for CPU tensors. The five grid columns
    are (n,) float64 on one device; consts as in `tb_march_plain`."""
    dev = z_fine.device
    return tb_march_plain(z_fine, xe_fine, H_fine, rho_g_fine, rho_b_fine, consts,
                          Tb_start, idx_start)


def compute_thermodynamics(params: CosmoParams, pr: PrecisionParams,
                           bg: BackgroundResult, bidx: BgIdx, device="cuda") -> ThermoResult:
    """Recombination (RECFAST, with energy injection when set) ->
    reionization (reio_camb with the tau_reio shooting, or a fixed-profile
    scheme) -> Tb/cb2 through reionization -> merge -> runtime uniform-ln(tau)
    table (thermodynamics_init, thermodynamics_module.cpp:293-1297). The
    recombination history and the Tb march run on `device` (kernels on a CUDA
    device), the rest on the host; the runtime table is returned on
    `device`."""
    from ..pipeline import resolve_device

    device = resolve_device(device)
    check_lcdm(params)
    th = _compute_thermodynamics_impl(params, pr, bg.to(HOST), bidx, device)
    return th._replace(lntau_spline=th.lntau_spline.to(device))


def _compute_thermodynamics_impl(params, pr, bg, bidx, device) -> ThermoResult:
    f64 = torch.float64
    ctx = make_recfast_ctx(params, pr, bg, bidx)
    reco = compute_recombination(pr, ctx, device)
    fHe = ctx.fHe
    scheme = params.reio_parametrization
    half = scheme == "reio_half_tanh"
    xe_after = 1.0 if half else 1.0 + fHe     # half_tanh neglects He (:2246)

    n_fine = 4096
    z_fine = torch.linspace(0.0, pr.reionization_z_start_max, n_fine, dtype=f64)
    H_fine = ctx.H_of_z.eval(-torch.log1p(z_fine))[:, 0]
    xe_reco_fine = interp(z_fine, reco.z, reco.xe)
    kappa_fac = ctx.Nnow * const.sigma_T * const.Mpc_over_m

    def tau_of_profile(xe, z_start):
        """Optical depth of the profiles xe (..., n_fine) below z_start (...)."""
        integrand = (1.0 + z_fine) ** 2 * kappa_fac * xe / H_fine
        return torch.trapezoid(torch.where(z_fine <= z_start, integrand, 0.0), z_fine, dim=-1)

    def tau_of_zreio(z_reio):
        """Optical depth for each candidate z_reio (any shape)."""
        z_reio = torch.as_tensor(z_reio, dtype=f64)
        z_start = torch.clamp(
            z_reio + pr.reionization_start_factor * params.reionization_width,
            min=params.helium_fullreio_redshift
            + pr.reionization_start_factor * params.helium_fullreio_width)
        xe_before = interp(z_start, reco.z, reco.xe)
        zs, zr, xb = z_start[..., None], z_reio[..., None], xe_before[..., None]
        xe = _xe_reio_camb(z_fine, zr, zs, xb, xe_after, fHe, params, half=half)
        return tau_of_profile(xe, zs)

    def reco_xe_at(z):
        return interp(torch.tensor(z, dtype=f64), reco.z, reco.xe)

    if scheme in ("reio_camb", "reio_half_tanh"):
        if params.z_reio is not None:
            z_reio = float(params.z_reio)
            tau_reio = float(tau_of_zreio(z_reio))
        else:
            z_cand = torch.linspace(0.0, pr.reionization_z_start_max
                                    - pr.reionization_start_factor * params.reionization_width
                                    - 1e-3, 512, dtype=f64)
            tau_cand = tau_of_zreio(z_cand)
            z_reio = float(interp(torch.tensor(params.tau_reio, dtype=f64), tau_cand, z_cand))
            t0 = float(tau_of_zreio(z_reio))
            t1 = float(tau_of_zreio(z_reio + 0.01))
            z_reio = z_reio + (params.tau_reio - t0) * 0.01 / (t1 - t0)
            tau_reio = float(tau_of_zreio(z_reio))
        z_start = max(z_reio + pr.reionization_start_factor * params.reionization_width,
                      params.helium_fullreio_redshift
                      + pr.reionization_start_factor * params.helium_fullreio_width)
        z_start_t = torch.tensor(z_start, dtype=f64)
        xe_fine = _xe_reio_camb(z_fine, z_reio, z_start_t, interp(z_start_t, reco.z, reco.xe),
                                xe_after, fHe, params, half=half)
    else:
        # fixed-profile schemes: tau_reio is derived, not shot for
        # (thermodynamics_module.cpp:2358-2640)
        if scheme == "reio_bins_tanh":
            zb = params.binned_reio_z
            xe_top = float(reco_xe_at(zb[-1] + 2.0 * (zb[-1] - zb[-2])))
            xe_fine, z_start = _xe_reio_bins_tanh(z_fine, params, xe_top, fHe)
        elif scheme == "reio_many_tanh":
            xe_top = float(reco_xe_at(params.many_tanh_z[-1]
                                      + pr.reionization_start_factor * params.many_tanh_width))
            xe_fine, z_start = _xe_reio_many_tanh(z_fine, params, pr, xe_top, fHe)
        elif scheme == "reio_inter":
            xe_top = float(reco_xe_at(params.reio_inter_z[-1]))
            xe_fine, z_start = _xe_reio_inter(z_fine, params, xe_top, fHe)
        elif scheme == "reio_none":
            xe_fine, z_start = xe_reco_fine, 0.0
        else:
            raise ValueError(f"unknown reio_parametrization {scheme!r}")
        z_start = float(z_start)
        z_start_t = torch.tensor(z_start, dtype=f64)
        tau_reio = float(tau_of_profile(xe_fine, z_start_t))
        # the half-maximum crossing as the reported z_reio
        xe_mid = 0.5 * (xe_fine[0] + interp(z_start_t, z_fine, xe_reco_fine))
        z_reio = float(z_fine[torch.argmin(torch.abs(xe_fine - xe_mid))])
    # above z_start the merged table keeps the recombination history
    xe_fine = torch.where(z_fine > z_start, xe_reco_fine, xe_fine)

    # --- Tb through reionization
    Tb_start = float(interp(z_start_t, reco.z, reco.Tb))
    rho_g_fine = bg.Omega0_g * bg.H0**2 * (1.0 + z_fine) ** 4
    rho_b_fine = bg.Omega0_b * bg.H0**2 * (1.0 + z_fine) ** 3
    idx_start = int(torch.searchsorted(z_fine, z_start_t))
    consts = (kappa_fac, ctx.YHe, params.T_cmb, const.m_H, const.m_e, const.not4)
    Tb_fine, dTdz_fine = (v.cpu() for v in tb_march(
        *(v.to(device).contiguous() for v in (z_fine, xe_fine, H_fine, rho_g_fine,
                                               rho_b_fine)),
        consts, Tb_start, idx_start))
    Tb_fine = torch.where(z_fine >= z_start, interp(z_fine, reco.z, reco.Tb), Tb_fine)
    mu_fine = const.m_H / (1.0 + (1.0 / const.not4 - 1.0) * ctx.YHe + xe_fine * (1.0 - ctx.YHe))
    wb_fine = const.k_B / (const.c_SI**2) / mu_fine * Tb_fine
    cb2_fine = wb_fine * (1.0 + (1.0 + z_fine) / 3.0 * dTdz_fine / Tb_fine)
    cb2_fine = torch.where(z_fine >= z_start, interp(z_fine, reco.z, reco.cb2), cb2_fine)
    dkappa_fine = (1.0 + z_fine) ** 2 * kappa_fac * xe_fine

    # --- merged z tables: fine grid below z_start_max, reco grid above
    hi = reco.z > pr.reionization_z_start_max
    z_merged = torch.cat([z_fine, reco.z[hi]])
    xe_merged = torch.cat([xe_fine, reco.xe[hi]])
    Tb_merged = torch.cat([Tb_fine, reco.Tb[hi]])
    cb2_merged = torch.cat([cb2_fine, reco.cb2[hi]])
    dkappa_merged = torch.cat([dkappa_fine, reco.dkappadtau[hi]])

    # --- runtime uniform-ln(tau) grid
    n_rt = 32768
    lntau_u = torch.linspace(math.log(float(bg.tau_of_loga[0])), math.log(bg.tau0),
                             n_rt, dtype=f64)
    dlntau = float(lntau_u[1] - lntau_u[0])
    tau_u = torch.exp(lntau_u)
    bgvals = bg.lntau_spline.eval(lntau_u)
    a_u = bgvals[:, bidx["a"]]
    z_u = 1.0 / a_u - 1.0
    loz = torch.log1p(torch.clamp(z_u, min=0.0))
    lom = torch.log1p(z_merged)
    zmax = float(z_merged[-1])
    xe_u = interp(loz, lom, xe_merged)
    Tb_u = torch.where(z_u > zmax, params.T_cmb * (1.0 + z_u), interp(loz, lom, Tb_merged))
    cb2_u = torch.where(
        z_u > zmax,
        const.k_B / (const.c_SI**2) * (1.0 + (1.0 / const.not4 - 1.0) * ctx.YHe
                                       + float(xe_merged[-1]) * (1.0 - ctx.YHe))
        / const.m_H * params.T_cmb * (1.0 + z_u) * 4.0 / 3.0,
        interp(loz, lom, cb2_merged))
    dkappa_u = torch.where(z_u > zmax, (1.0 + z_u) ** 2 * kappa_fac * float(xe_merged[-1]),
                           interp(loz, lom, dkappa_merged))

    integrand = dkappa_u * tau_u
    kappa_u = spline_integrate_reverse(lntau_u, integrand, spline_d2(lntau_u, integrand))
    exp_m_kappa = torch.exp(-kappa_u)
    g_u = dkappa_u * exp_m_kappa
    x0u = float(lntau_u[0])
    ddkappa_u = UniformSpline.build(x0u, dlntau, dkappa_u).eval_deriv(lntau_u) / tau_u
    dddkappa_u = UniformSpline.build(x0u, dlntau, ddkappa_u).eval_deriv(lntau_u) / tau_u
    dg_u = (ddkappa_u + dkappa_u**2) * exp_m_kappa
    ddg_u = (dddkappa_u + 3.0 * dkappa_u * ddkappa_u + dkappa_u**3) * exp_m_kappa

    R_u = 3.0 * bgvals[:, bidx["rho_b"]] / (4.0 * bgvals[:, bidx["rho_g"]])
    integrand_d = dkappa_u / R_u * tau_u
    taud_u = spline_integrate_reverse(lntau_u, integrand_d, spline_d2(lntau_u, integrand_d))
    integrand_rd = (1.0 / dkappa_u) * (R_u**2 + 16.0 / 15.0 * (1.0 + R_u)) \
        / (6.0 * (1.0 + R_u) ** 2) * tau_u
    I_rd = spline_integrate(lntau_u, integrand_rd, spline_d2(lntau_u, integrand_rd))
    I_rd = I_rd + 16.0 / (15.0 * 6.0 * 3.0) * tau_u[0] / dkappa_u[0]
    rd_u = 2.0 * math.pi * torch.sqrt(torch.clamp(I_rd, min=0.0))

    table_u = torch.stack([xe_u, dkappa_u, ddkappa_u, dddkappa_u, exp_m_kappa, g_u, dg_u,
                           ddg_u, Tb_u, cb2_u, taud_u, kappa_u], dim=1)
    lntau_spline = UniformSpline.build(x0u, dlntau, table_u)

    # --- derived epochs
    def bg_at(lnt):
        return bg.lntau_spline.eval(torch.tensor(lnt, dtype=f64))

    i_rec = int(torch.argmax(g_u))
    gm, g0, gp = (float(v) for v in g_u[i_rec - 1: i_rec + 2])
    lntau_rec = float(lntau_u[i_rec]) + 0.5 * (gm - gp) / (gm - 2.0 * g0 + gp) * dlntau
    tau_rec = math.exp(lntau_rec)
    bg_rec = bg_at(lntau_rec)
    z_rec = float(1.0 / bg_rec[bidx["a"]] - 1.0)
    rs_rec = float(bg_rec[bidx["rs"]])

    def crossing(col, level):
        """ln tau where the decreasing column crosses `level`."""
        i = int(torch.searchsorted(-col, torch.tensor(-level, dtype=f64)))
        c0, c1 = float(col[i - 1]), float(col[i])
        return float(lntau_u[i - 1]) + (c0 - level) / (c0 - c1) * dlntau

    lntau_star = crossing(kappa_u, 1.0)
    tau_star = math.exp(lntau_star)
    bg_star = bg_at(lntau_star)
    z_star = float(1.0 / bg_star[bidx["a"]] - 1.0)
    rs_star = float(bg_star[bidx["rs"]])

    def comoving_ang(chi):
        """Comoving angular diameter distance r(chi) (thermodynamics.py:1060-1070)."""
        K = -params.Omega_k * float(bg.H0) ** 2
        if params.Omega_k > 1e-12:      # open, K < 0
            return math.sinh(math.sqrt(-K) * chi) / math.sqrt(-K)
        if params.Omega_k < -1e-12:     # closed, K > 0
            return math.sin(math.sqrt(K) * chi) / math.sqrt(K)
        return chi

    ra_star = comoving_ang(bg.tau0 - tau_star)
    ra_rec = comoving_ang(bg.tau0 - tau_rec)
    rd_rec = float(interp(torch.tensor(lntau_rec, dtype=f64), lntau_u, rd_u))
    rd_star = float(interp(torch.tensor(lntau_star, dtype=f64), lntau_u, rd_u))
    H0_SI = params.h * 1.0e5 / const.Mpc_over_m
    n_e = 3.0 * H0_SI**2 * params.omega_b / params.h**2 \
        * (1.0 - ctx.YHe) / (8.0 * math.pi * const.G_SI * const.m_H)
    vis_ok = g_u > g_u[i_rec] * pr.neglect_CMB_sources_below_visibility
    i_cut = n_rt - 1 - int(torch.argmax(torch.flip(vis_ok, [0]).to(torch.int8)))
    tau_cut = float(tau_u[i_cut])
    lntau_d = crossing(taud_u, 1.0)
    tau_d = math.exp(lntau_d)
    bg_d = bg_at(lntau_d)
    z_d = float(1.0 / bg_d[bidx["a"]] - 1.0)
    rs_d = float(bg_d[bidx["rs"]])

    return ThermoResult(
        lntau_spline=lntau_spline, z_grid=z_merged, xe_of_z=xe_merged,
        Tb_of_z=Tb_merged, cb2_of_z=cb2_merged, dkappa_of_z=dkappa_merged,
        YHe=ctx.YHe, fHe=fHe, z_reio=float(z_reio), tau_reio=float(tau_reio),
        z_rec=z_rec, tau_rec=tau_rec, rs_rec=rs_rec,
        z_star=z_star, tau_star=tau_star, rs_star=rs_star, ra_star=ra_star,
        z_d=z_d, tau_d=tau_d, rs_d=rs_d,
        angular_rescaling=ra_rec / (bg.tau0 - tau_rec),
        tau_cut=tau_cut, ra_rec=ra_rec, rd_rec=rd_rec, rd_star=rd_star, n_e=n_e)

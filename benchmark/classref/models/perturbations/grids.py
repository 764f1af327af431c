"""k grid, tau sampling and per-k approximation switch times (counterpart
of classpp_public_tpu/models/perturbations/grids.py).

Host-side numpy set-up: it fixes the shapes of the integration.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import numpy as np
import torch

from ...config.params import CosmoParams
from ...config.precision import PrecisionParams
from ..thermodynamics import ThIdx


def _tables_on_lntau_grid(bg, th):
    """(lntau, tau, thermo rows, background rows) on the thermodynamics
    runtime grid, as host float64 numpy."""
    spl = th.lntau_spline
    lntau = spl.x0 + spl.dx * np.arange(spl.n, dtype=np.float64)
    thy = spl.y.cpu().numpy()
    bgy = bg.lntau_spline.to("cpu").eval(torch.from_numpy(lntau)).numpy()
    return lntau, np.exp(lntau), thy, bgy


def get_k_list(params: CosmoParams, pr: PrecisionParams, bg, th,
               l_scalar_max: int = 2500, k_max_for_pk: float = 10.0,
               has_cls: bool = True, has_pk: bool = True,
               k_max_cl_extra: float = 0.0, m_mode: int = 0) -> np.ndarray:
    """k grid [1/Mpc] (perturb_get_k_list, :1628; grids.py:27-83).
    k_max_cl_extra raises the densely sampled CMB region (the lensing
    potential's l_lss_max requirement, :1726-1733). m_mode (0 scalars, 2
    tensors) moves k_min only in curved models (grids.py:39-60): open models
    keep q^2 = k^2 + (1 + m) K positive, closed ones start at nu = 3, that is
    k = sqrt((8 - m) K)."""
    tau0 = float(bg.tau0)
    k_rec = 2.0 * math.pi / float(th.rs_rec)
    ang = float(th.angular_rescaling)
    K = -params.Omega_k * float(bg.H0) ** 2
    if K < 0.0:
        k_min = math.sqrt(-(1.0 + m_mode) * K + (pr.k_min_tau0 / tau0 / ang) ** 2)
    elif K > 0.0:
        k_min = math.sqrt((8.0 - m_mode - 1.0e-4) * K)
    else:
        k_min = pr.k_min_tau0 / tau0
    k_max_cmb = pr.k_max_tau0_over_l_max * l_scalar_max / tau0 / ang if has_cls else k_min
    k_max_cmb = max(k_max_cmb, k_max_cl_extra)
    k_max = max(k_max_cmb, k_max_for_pk if has_pk else 0.0)
    scale2 = float(bg.H0) ** 2 + abs(K)
    ks = [k_min]
    k = k_min
    while k < k_max_cmb:
        step = (pr.k_step_super
                + 0.5 * (math.tanh((k - k_rec) / k_rec / pr.k_step_transition) + 1.0)
                * (pr.k_step_sub - pr.k_step_super)) * k_rec
        step *= (k * k / scale2 + 1.0) / (k * k / scale2 + 1.0 / pr.k_step_super_reduction)
        k += step
        ks.append(k)
    kpd_pk = pr.k_per_decade_for_pk
    while k < k_max:
        k *= 10.0 ** (1.0 / (kpd_pk
                             + (pr.k_per_decade_for_bao - kpd_pk)
                             * (1.0 - math.tanh(((math.log(k) - math.log(pr.k_bao_center * k_rec))
                                                 / math.log(pr.k_bao_width)) ** 4))))
        ks.append(k)
    return np.array(ks)


def get_tau_sampling(params: CosmoParams, pr: PrecisionParams, bg, bidx, th,
                     has_cmb: bool = True, z_max_pk: float = 5.0) -> np.ndarray:
    """Source sampling times (perturb_timesampling_for_sources, :1247)."""
    lntau, tau_grid, thy, bgy = _tables_on_lntau_grid(bg, th)
    a = bgy[:, bidx["a"]]
    H = bgy[:, bidx["H"]]
    Hp = bgy[:, bidx["H_prime"]]
    aH = a * H
    app_a = Hp * a + 2.0 * aH * aH
    dk = thy[:, ThIdx.ix["dkappa"]]
    ddk = thy[:, ThIdx.ix["ddkappa"]]
    dddk = thy[:, ThIdx.ix["dddkappa"]]
    rate_thermo = np.sqrt(dk**2 + (ddk / dk) ** 2 + np.abs(dddk / dk))
    rate_isw2 = np.abs(2.0 * app_a - aH * aH)
    rate_cmb = np.sqrt(rate_thermo**2 + rate_isw2)
    if has_cmb:
        ratio = aH / dk
        i0 = np.searchsorted(ratio > pr.start_sources_at_tau_c_over_tau_h, True)
        i0 = int(np.clip(i0, 1, len(ratio) - 1))
        r0, r1 = ratio[i0 - 1], ratio[i0]
        w = (pr.start_sources_at_tau_c_over_tau_h - r0) / (r1 - r0)
        tau_ini = float(np.exp(lntau[i0 - 1] + w * (lntau[i0] - lntau[i0 - 1])))
        rate = rate_cmb
    else:
        tau_ini = float(np.interp(-np.log1p(z_max_pk + 1.0), bg.loga.cpu().numpy(),
                                  bg.tau_of_loga.cpu().numpy()))
        rate = aH
    tau0 = float(bg.tau0)
    taus = [tau_ini]
    tau = tau_ini
    lr = np.log(tau_grid)
    while tau < tau0:
        r = np.interp(np.log(tau), lr, rate)
        tau = tau + pr.perturb_sampling_stepsize / r
        taus.append(min(tau, tau0))
    return np.array(taus)


class KSchedule(NamedTuple):
    """Per-k integration schedule: start time and approximation switches."""

    k: np.ndarray
    tau_ini: np.ndarray
    tau_tca_off: np.ndarray
    tau_ufa_on: np.ndarray
    tau_rsa_on: np.ndarray
    tau_ncdmfa_on: np.ndarray = None


def get_k_schedule(ks: np.ndarray, pr: PrecisionParams, bg, bidx, th,
                   tau_first_sample: float, n_ncdm: int = 0,
                   tol_ncdm_initial_w: float = 1.0e-3,
                   k_max_cmb: float = np.inf) -> KSchedule:
    """Vectorised tau_ini (perturb_solve, :2541) and switch times
    (perturb_approximations, :5443) by inverting monotone triggers on the
    dense ln(tau) grid."""
    lntau, tau_grid, thy, bgy = _tables_on_lntau_grid(bg, th)
    aH = bgy[:, bidx["a"]] * bgy[:, bidx["H"]]
    dk = thy[:, ThIdx.ix["dkappa"]]
    i_rec = int(np.searchsorted(tau_grid, float(th.tau_rec) * 3.0))
    tg, aHg, dkg = tau_grid[:i_rec], aH[:i_rec], dk[:i_rec]

    def crossing_increasing(f, target):
        i = np.searchsorted(f, target)
        i = np.clip(i, 1, len(f) - 1)
        w = (target - f[i - 1]) / (f[i] - f[i - 1])
        return np.exp(np.log(tg[i - 1]) + np.clip(w, 0, 1) * (np.log(tg[i]) - np.log(tg[i - 1])))

    ratio_h = aHg / dkg
    tau_A = crossing_increasing(ratio_h, pr.tight_coupling_trigger_tau_c_over_tau_h)
    tau_C = crossing_increasing(ratio_h, pr.start_small_k_at_tau_c_over_tau_h)
    logdk = np.log(dkg[::-1])
    logtg = np.log(tg[::-1])
    trig_k = np.where(ks > k_max_cmb,
                      pr.tight_coupling_trigger_tau_c_over_tau_k_pkonly,
                      pr.tight_coupling_trigger_tau_c_over_tau_k)
    tau_B = np.exp(np.interp(np.log(ks / trig_k), logdk, logtg))
    tau_tca_off = np.minimum(tau_A, tau_B)
    logaH = np.log(aHg[::-1])
    tau_D = np.exp(np.interp(np.log(ks / pr.start_large_k_at_tau_h_over_tau_k), logaH, logtg))
    tau_ini = np.minimum(tau_C, tau_D)
    tau_ini = np.minimum(tau_ini, tau_first_sample)
    tau_ini = np.maximum(tau_ini, tau_grid[0] * 1.0001)
    i_after_rec = int(np.searchsorted(tau_grid, float(th.tau_rec)))
    fs_ratio = 1.0 / (dk[i_after_rec:] * tau_grid[i_after_rec:])
    j = np.searchsorted(fs_ratio > pr.radiation_streaming_trigger_tau_c_over_tau, True)
    tau_fs = tau_grid[i_after_rec + min(j, len(fs_ratio) - 1)]
    tau_rsa_on = np.maximum(pr.radiation_streaming_trigger_tau_over_tau_k / ks, tau_fs)
    tau_ufa_on = pr.ur_fluid_trigger_tau_over_tau_k / ks
    tau_ncdmfa_on = pr.ncdm_fluid_trigger_tau_over_tau_k / ks
    # ncdm must still be ultra-relativistic at the start (perturb_solve
    # :2568: |p/rho - 1/3| < tol_ncdm_initial_w)
    if n_ncdm:
        wdev = np.zeros_like(tau_grid)
        for i in range(n_ncdm):
            p_i = bgy[:, bidx[f"p_ncdm{i}"]]
            r_i = bgy[:, bidx[f"rho_ncdm{i}"]]
            with np.errstate(invalid="ignore", divide="ignore"):
                dev_i = np.abs(3.0 * p_i / np.where(r_i > 0.0, r_i, 1.0) - 1.0)
            wdev = np.maximum(wdev, np.where(r_i > 0.0, dev_i, 0.0))
        j = np.searchsorted(wdev > 3.0 * tol_ncdm_initial_w, True)
        tau_ini = np.minimum(tau_ini, tau_grid[max(j - 1, 1)])
    return KSchedule(k=ks, tau_ini=tau_ini, tau_tca_off=tau_tca_off,
                     tau_ufa_on=tau_ufa_on, tau_rsa_on=tau_rsa_on,
                     tau_ncdmfa_on=tau_ncdmfa_on)

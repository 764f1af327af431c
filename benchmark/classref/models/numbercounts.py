"""Number-count and galaxy-lensing angular spectra (nCl / sCl).

Counterpart of classpp_public_tpu/models/numbercounts.py (`_n_tau_nc` :40,
`_CONTRIB` :58, `_selection_dndz` :97, `_dndz_analytic` :116,
`make_dndz_from_file` :127, `_row_specs` :145, `compute_number_counts`
:155-236, `_assemble_rows` :257-452, `_delta_from_rows` :455-501,
`_nc_scan` :629-683).

Every (bin, contribution) pair is one row of an (nrow, nk, ntau) table: the
windowed source on the row's own uniform tau grid, with a per-row radial code
(0: j_l for density, lensing and the g-terms; 1: j_l' for d1 and g5; 2: j_l''
for rsd). One line-of-sight Bessel scan over l carries every row: on a CUDA
tensor the hand-written kernel csrc/nc_scan.cu (`nc_scan`), on a CPU tensor
its plain version `nc_scan_plain`. Above each row's z-scaled switch the row
takes its Limber form (T0, T1 or the NC_RSD three-term form).

Two divergences from the C++ code are inherited from the JAX package on
purpose (ROADMAP Queue 3): the Bessel functions are the flat j_l even when
Omega_k != 0, and the sources are the linear ones even with a nonlinear
method on (the C++ code scales them by nl_corr_density,
transfer_module.cpp:542-597).
"""

from __future__ import annotations

import math
from typing import NamedTuple

import numpy as np
import torch

from ..config.precision import PrecisionParams
from ..ops.quadrature import trapz_weights
from ..ops.splines import interp, spline_d2, spline_eval
from .perturbations.indices import SrcIdx
from .transfer import _series_emit_tables, get_l_list

N_TAU_NC = 512


def _n_tau_nc(pr: PrecisionParams) -> int:
    """Length of every row's tau grid: N_TAU_NC scaled by the selection
    sampling knobs relative to their defaults (50 / 20 / 20), rounded up to a
    multiple of 64, at least 128 (numbercounts.py:40-49)."""
    scale = max(pr.selection_sampling / 50.0,
                pr.selection_sampling_bessel / 20.0,
                pr.selection_sampling_bessel_los / 20.0)
    return max(int(-(-N_TAU_NC * scale // 64) * 64), 128)


# per contribution: source column, k-power rescale, radial code (0 j, 1 j',
# 2 j''), integrated (lensing-kernel tau grid)
_CONTRIB = {
    "density": ("delta_m", 0, 0, False),
    "rsd": ("theta_m", 0, 2, False),
    "d0": ("theta_m", -2, 0, False),
    "d1": ("theta_m", -1, 1, False),
    "g1": ("psi", 0, 0, False),
    "g2": ("phi", 0, 0, False),
    "g3": ("phi_prime", 0, 0, False),
    "lens": ("phi_plus_psi", 0, 0, True),
    "g4": ("phi_plus_psi", 0, 0, True),
    "g5": ("phi_plus_psi", 1, 1, True),
}


class NumberCountsResult(NamedTuple):
    ell: torch.Tensor         # integer multipoles 2..l_max
    dd: torch.Tensor          # (n_dd_pairs, nl) density auto and cross spectra
    ll: torch.Tensor          # (n_dd_pairs, nl) lensing-potential auto and cross
    dl: torch.Tensor          # (nbin * nbin, nl) density x lensing
    dd_pairs: tuple           # [(i, j)] of dd and ll
    dl_pairs: tuple           # [(i, j)] of dl


class RowInfo(NamedTuple):
    """The LSS side of the spectra, independent of the k grid
    (numbercounts.py `_RowInfo`)."""

    rows: tuple               # [(type, bin)] in stacking order
    tau_rows: torch.Tensor    # (nrow, ntau) uniform tau grid per row
    W_rows: torch.Tensor      # (nrow, ntau) window weights
    src_cols: tuple           # source column per row
    kpow: tuple               # k-power rescale per row
    radial: tuple             # radial code per row
    lim_switch: tuple         # Limber switch multipole per row
    tau0: float


def _selection_dndz(z, mean, width, kind, pr: PrecisionParams, dndz=None):
    """Selection shape (transfer_selection_function :2129-2230): a Gaussian
    of unit z integral or a tophat smoothed by selection_tophat_edge, times
    dN/dz when given."""
    if kind == "gaussian":
        W = torch.exp(-0.5 * ((z - mean) / width) ** 2) / width / math.sqrt(2.0 * math.pi)
    elif kind == "tophat":
        W = 0.5 * (1.0 - torch.tanh((torch.abs(z - mean) - width)
                                    / (pr.selection_tophat_edge * width)))
    else:
        raise ValueError(f"unknown selection {kind!r}")
    if dndz is not None:
        W = W * dndz(z)
    return W


def _dndz_analytic(z):
    """The Euclid photometric ansatz (transfer_dNdz_analytic :2252)."""
    z0 = 0.9 / math.sqrt(2.0)
    return (z / z0) ** 2.0 * torch.exp(-((z / z0) ** 1.5))


def _dln_dndz_dz_analytic(z):
    z0 = 0.9 / math.sqrt(2.0)
    return (2.0 - 1.5 * (z / z0) ** 1.5) / z


def make_dndz_from_file(path):
    """(dndz, dln_dndz_dz): linear interpolators of a two-column z, dN/dz
    file and of its log derivative (numpy.gradient of ln dN/dz)."""
    tab = np.loadtxt(path)
    zt, nt = tab[:, 0], tab[:, 1]
    dln = np.gradient(np.log(np.maximum(nt, 1e-300)), zt)

    def table(a, z):
        return torch.as_tensor(a, dtype=torch.float64, device=z.device)

    def dndz(z):
        return interp(z, table(zt, z), table(nt, z))

    def dlnd(z):
        return interp(z, table(zt, z), table(dln, z))

    return dndz, dlnd


def _row_specs(contributions, nbin: int, want_ll: bool) -> list:
    """(type, bin) rows: the local contribution rows, then the integrated
    ones, then the sCl lensing-potential rows."""
    active = [t for t in ("density", "rsd", "d0", "d1", "g1", "g2", "g3", "lens", "g4", "g5")
              if (t in contributions)
              or (t in ("rsd", "d0", "d1") and "rsd" in contributions)
              or (t in ("g1", "g2", "g3", "g4", "g5") and "gr" in contributions)
              or (t == "lens" and "lensing" in contributions)]
    rows = [(t, b) for t in active for b in range(nbin)]
    if want_ll:
        rows += [("sl", b) for b in range(nbin)]
    return rows


def _spline_to_all_l(ls: np.ndarray, ells: torch.Tensor):
    """Spline C_l rows (n, nl) given at the multipoles ls to every l of ells."""
    l_f = torch.as_tensor(ls, dtype=torch.float64, device=ells.device)

    def to_all(cl_list):
        d2 = spline_d2(l_f, cl_list.T)
        return spline_eval(l_f, cl_list.T, d2, ells.to(torch.float64)).T

    return to_all


def _pad(values, nbin, default):
    v = list(values) if values is not None else [default] * nbin
    return v + [v[-1]] * (nbin - len(v)) if len(v) < nbin else v


def _assemble_rows(bg, bidx, pr: PrecisionParams, sel_means, sel_widths, kind, contributions,
                   selection_bias, magnification_bias, dndz, dndz_evo, tau0: float,
                   want_ll: bool) -> RowInfo:
    """Selection windows with the bias, magnification and evolution factors,
    and each row's tau grid (numbercounts.py:257-452; the windows
    transfer_selection_compute :2490, the factors :4031-4440, f_evo :4442, the
    lensing-kernel grids transfer_lensing_sampling :2337)."""
    from .background import tau_of_z

    nbin = len(sel_means)
    cut = pr.selection_cut_at_sigma
    bias = _pad(selection_bias, nbin, 1.0)
    magn = _pad(magnification_bias, nbin, 0.0)
    if dndz == "analytic":
        dndz_f = _dndz_analytic
    elif isinstance(dndz, str):
        dndz_f = make_dndz_from_file(dndz)[0]
    else:
        dndz_f = dndz
    if dndz_evo == "analytic":
        dlnevo_f = _dln_dndz_dz_analytic
    elif isinstance(dndz_evo, str):
        dlnevo_f = make_dndz_from_file(dndz_evo)[1]
    else:
        dlnevo_f = None
    rows = _row_specs(contributions, nbin, want_ll)
    n_tau = _n_tau_nc(pr)
    spl = bg.lntau_spline
    dev = spl.y.device
    ia, iH, iHp = bidx["a"], bidx["H"], bidx["H_prime"]

    # per bin: the selection window dN/dtau of unit tau integral on its grid
    sel_tau, sel_W, sel_bgf = [], [], []
    for b in range(nbin):
        z_hi = sel_means[b] + cut * sel_widths[b]
        z_lo = max(sel_means[b] - cut * sel_widths[b], 0.0)
        tau_min = float(tau_of_z(bg, float(z_hi)))
        tau_max = float(tau_of_z(bg, float(z_lo)))
        tau = torch.linspace(tau_min, min(tau_max, float(tau0) * (1.0 - 1e-8)), n_tau,
                             dtype=torch.float64, device=dev)
        bgv = spl.eval(torch.log(tau))
        a, H, Hp = bgv[:, ia], bgv[:, iH], bgv[:, iHp]
        z = 1.0 / a - 1.0
        W = _selection_dndz(z, sel_means[b], sel_widths[b], kind, pr, dndz_f) * H
        W = W / torch.trapezoid(W, tau)
        sel_tau.append(tau)
        sel_W.append(W)
        sel_bgf.append((a, H, Hp, z))

    def f_evo_of(tau, a, H, Hp, z):
        if dlnevo_f is None:
            return torch.zeros_like(tau)
        chi = torch.clamp(tau0 - tau, min=1e-8)
        return 2.0 / (a * H * chi) + Hp / (a * H * H) - dlnevo_f(torch.clamp(z, min=1e-8)) / a

    # the integrated rows' grids: from the bin's far edge to today
    int_tau = [torch.linspace(float(sel_tau[b][0]), float(tau0) * (1.0 - 1e-8), n_tau,
                              dtype=torch.float64, device=dev) for b in range(nbin)]

    taus_rows, w_rows, src_cols, kpow, radial, lim_switch = [], [], [], [], [], []
    for t, b in rows:
        a, H, Hp, z = sel_bgf[b]
        aH = a * H
        tau, W = sel_tau[b], sel_W[b]
        chi = torch.clamp(tau0 - tau, min=1e-8)
        fe = f_evo_of(tau, a, H, Hp, z)
        s = magn[b]
        if t == "density":
            wrow = bias[b] * W
        elif t == "rsd":
            wrow = W / aH
        elif t == "d0":
            wrow = (fe - 3.0) * W * aH
        elif t == "d1":
            wrow = W * (1.0 + Hp / (a * H * H) + (2.0 - 5.0 * s) / (chi * aH) + 5.0 * s - fe)
        elif t == "g1":
            wrow = W
        elif t == "g2":
            wrow = -W * (3.0 + Hp / (a * H * H) + (2.0 - 5.0 * s) / (chi * aH) - fe)
        elif t == "g3":
            wrow = W / aH
        else:
            # integrated rows: the kernel at lens time tau_i sums the window
            # over the sources beyond the lens (flat geometry;
            # transfer_precompute_selection :4240-4400)
            tau_i = int_tau[b]
            chi_l = torch.clamp(tau0 - tau_i, min=1e-8)
            tau_s = sel_tau[b]
            chi_s = torch.clamp(tau0 - tau_s, min=1e-8)
            Wsw = sel_W[b] * trapz_weights(tau_s)
            beyond = chi_s[None, :] > chi_l[:, None]
            if t == "sl":
                ker = (chi_l[:, None] - chi_s[None, :]) / (chi_s[None, :] * chi_l[:, None])
                wrow = torch.sum(torch.where(beyond, ker, 0.0) * Wsw[None, :], dim=1)
            elif t == "lens":
                ker = (chi_s[None, :] - chi_l[:, None]) / (chi_s[None, :] * chi_l[:, None])
                wrow = 0.5 * (2.0 - 5.0 * s) * torch.sum(
                    torch.where(beyond, ker, 0.0) * Wsw[None, :], dim=1)
            elif t == "g4":
                wrow = (2.0 - 5.0 * s) * torch.sum(
                    torch.where(beyond, (1.0 / chi_s)[None, :], 0.0) * Wsw[None, :], dim=1)
            else:   # g5
                fe_s = f_evo_of(tau_s, a, H, Hp, z)
                fac_s = 1.0 + Hp / (a * H * H) + (2.0 - 5.0 * s) / (chi_s * a * H) + 5.0 * s - fe_s
                wrow = torch.sum(torch.where(beyond, fac_s[None, :], 0.0) * Wsw[None, :], dim=1)
            wrow = wrow.clone()
            wrow[-1] = 0.0        # the tau0 end (rescaling = 0 at tau_size - 1)
            tau = tau_i
        taus_rows.append(tau)
        w_rows.append(wrow)
        if t == "sl":
            src_cols.append("phi_plus_psi")
            kpow.append(0)
            radial.append(0)
            lim_switch.append(pr.l_switch_limber_for_nc_los_over_z * max(sel_means[b], 1e-3))
        else:
            sc, kp, rd, integ = _CONTRIB[t]
            src_cols.append(sc)
            kpow.append(kp)
            radial.append(rd)
            # g5 is integrated but takes the local switch: its j_l' makes the
            # los-type criterion invalid (transfer_module.cpp:2717-2718)
            sw = (pr.l_switch_limber_for_nc_los_over_z if (integ and t != "g5")
                  else pr.l_switch_limber_for_nc_local_over_z)
            lim_switch.append(sw * max(sel_means[b], 1e-3))
    return RowInfo(rows=tuple(rows), tau_rows=torch.stack(taus_rows), W_rows=torch.stack(w_rows),
                   src_cols=tuple(src_cols), kpow=tuple(kpow), radial=tuple(radial),
                   lim_switch=tuple(lim_switch), tau0=float(tau0))


# ---------------------------------------------------------------------------
# The selection-window Bessel scan


def nc_scan_plain(x: torch.Tensor, Wrow: torch.Tensor, radial, l_emit: np.ndarray) -> torch.Tensor:
    """Plain version of the selection-window scan (_nc_scan :629-683): a
    Python loop over l = 2..l_max on whole (nrow, nk, ntau) tensors. x, Wrow:
    (nrow, nk, ntau); radial: per-row code (0 j_l, 1 j_l', 2 j_l''); l_emit:
    increasing multipoles. Returns Delta (nl, nrow, nk) = sum over tau of
    Wrow rad_row(l, x) at each emitted l."""
    emit_idx, _, lndf_l, lndf1_l = _series_emit_tables(np.asarray(l_emit))
    code = torch.as_tensor(np.asarray(radial), device=x.device)[:, None, None]
    x = torch.clamp(x, min=1e-12)
    inv_x = 1.0 / x
    x2 = x * x
    small = x < 0.3
    j0 = torch.where(small, 1.0 - x2 / 6.0 * (1.0 - x2 / 20.0 * (1.0 - x2 / 42.0)),
                     torch.sin(x) * inv_x)
    j1 = torch.where(small, x / 3.0 * (1.0 - x2 / 10.0 * (1.0 - x2 / 28.0)),
                     (torch.sin(x) * inv_x - torch.cos(x)) * inv_x)
    thr = x + 6.0 * torch.pow(x, 1.0 / 3.0) + 2.0
    lnx = torch.log(x)
    series = x < 1.0
    acc = torch.zeros((len(l_emit),) + tuple(x.shape[:2]), dtype=x.dtype, device=x.device)
    jm1, jm2 = j1, j0
    for li in range(2, int(l_emit[-1]) + 1):
        l = float(li)
        jl = (2.0 * l - 1.0) * inv_x * jm1 - jm2
        jl = torch.where(l <= thr, jl, 0.0)
        ei = int(emit_idx[li])
        if ei >= 0:
            c1, c1b = 2.0 * l + 3.0, 2.0 * l + 5.0
            corr = 1.0 - x2 / (2.0 * c1) * (1.0 - x2 / (4.0 * (c1 + 2.0))
                                            * (1.0 - x2 / (6.0 * (c1 + 4.0))))
            corr1 = 1.0 - x2 / (2.0 * c1b) * (1.0 - x2 / (4.0 * (c1b + 2.0))
                                              * (1.0 - x2 / (6.0 * (c1b + 4.0))))
            js = torch.exp(l * lnx - float(lndf_l[ei])) * corr
            js1 = torch.exp((l + 1.0) * lnx - float(lndf1_l[ei])) * corr1
            jl_e = torch.where(series, js, jl)
            jp_e = torch.where(series, l * inv_x * js - js1, jm1 - (l + 1.0) * inv_x * jl)
            jpp = -2.0 * inv_x * jp_e - (1.0 - l * (l + 1.0) * inv_x * inv_x) * jl_e
            rad = torch.where(code == 0, jl_e, torch.where(code == 1, jp_e, jpp))
            acc[ei] = (Wrow * rad).sum(-1)
        jm2, jm1 = jm1, jl
    return acc


def nc_scan(x: torch.Tensor, Wrow: torch.Tensor, radial, l_emit: np.ndarray) -> torch.Tensor:
    """The selection-window Bessel scan: the CUDA kernel nc_scan for CUDA
    tensors, the plain version for CPU tensors. x, Wrow: (nrow, nk, ntau)
    float64 contiguous; radial: nrow codes (0 j_l, 1 j_l', 2 j_l''); l_emit:
    increasing emitted multipoles (numpy). Returns (nl, nrow, nk)."""
    return nc_scan_plain(x, Wrow, radial, l_emit)


def _delta_from_rows(k: torch.Tensor, s_eval, R: RowInfo, ls: np.ndarray) -> torch.Tensor:
    """Delta rows (nl, nrow, nk) on the k grid: the sources splined onto the
    row grids, the Bessel scan (`nc_scan`), and above each row's switch its
    Limber form (transfer_limber :2912: T0, T1 and NC_RSD;
    numbercounts.py:455-501). s_eval(col, tau_row) -> (nk, ntau)."""
    tau_rows, W_rows, tau0 = R.tau_rows, R.W_rows, R.tau0
    S_rows = []
    for i, (col, kp) in enumerate(zip(R.src_cols, R.kpow)):
        Sr = s_eval(col, tau_rows[i])
        if kp:
            Sr = Sr * k[:, None] ** kp
        S_rows.append(Sr)
    WS = torch.stack(S_rows) * W_rows[:, None, :]                  # (nrow, nk, ntau)
    nrow, ntau = tau_rows.shape
    dtau = tau_rows[:, 1] - tau_rows[:, 0]
    wt = torch.ones_like(tau_rows)
    wt[:, 0] = 0.5
    wt[:, -1] = 0.5
    Wrow = (WS * (wt * dtau[:, None])[:, None, :]).contiguous()
    x = (k[None, :, None] * (tau0 - tau_rows)[:, None, :]).contiguous()
    delta = nc_scan(x, Wrow, R.radial, ls)

    # Limber: P = WS chi interpolated linearly at chi = (l + c)/k per row
    lf = torch.as_tensor(np.asarray(ls), dtype=torch.float64, device=k.device)
    nl, nk = lf.shape[0], k.shape[0]
    P_rows = (WS * (tau0 - tau_rows)[:, None, :]).reshape(nrow, nk * ntau)
    t_first, t_last = tau_rows[:, 0, None, None], tau_rows[:, -1, None, None]
    base = (torch.arange(nk, device=k.device) * ntau)[None, None, :]

    def p_at(c):
        tau_lim = (tau0 - (lf[:, None] + c) / k[None, :])[None]          # (1, nl, nk)
        fi = (torch.minimum(torch.maximum(tau_lim, t_first), t_last) - t_first) \
            / dtau[:, None, None]
        i0 = torch.clamp(torch.floor(fi).long(), 0, ntau - 2)             # (nrow, nl, nk)
        wf = fi - i0
        flat = (base + i0).reshape(nrow, -1)
        lo = torch.gather(P_rows, 1, flat).reshape(nrow, nl, nk)
        hi = torch.gather(P_rows, 1, flat + 1).reshape(nrow, nl, nk)
        inside = (tau_lim > t_first) & (tau_lim < t_last)
        return torch.where(inside, (1.0 - wf) * lo + wf * hi, 0.0)

    def spi(shift):
        return (torch.sqrt(math.pi / (2.0 * lf + 1.0 + 2.0 * shift)) / (lf + 0.5 + shift))[None, :,
                                                                                          None]

    P_m15, P_m05, P_p05, P_p15, P_p25 = (p_at(c) for c in (-1.5, -0.5, 0.5, 1.5, 2.5))
    lw = lf[None, :, None]
    lim_T0 = spi(0.0) * P_p05
    lim_T1 = (-spi(1.0) * P_p15 * ((lw + 1.0) / (2.0 * lw + 1.0))
              + spi(-1.0) * P_m05 * (lw / (2.0 * lw + 1.0)))
    c_p = lw * (lw + 2.0) / (2.0 * lw + 1.0) / (2.0 * lw + 3.0)
    c_0 = lw / (2.0 * lw + 1.0) * (lw / (2.0 * lw - 1.0) + (lw + 1.0) / (2.0 * lw + 3.0))
    c_m = lw * (lw - 1.0) / (2.0 * lw + 1.0) / (2.0 * lw - 1.0)
    lim_RSD = spi(2.0) * P_p25 * c_p - spi(0.0) * P_p05 * c_0 + spi(-2.0) * P_m15 * c_m
    code = torch.as_tensor(np.asarray(R.radial), device=k.device)[:, None, None]
    d_limber = torch.where(code == 0, lim_T0, torch.where(code == 1, lim_T1, lim_RSD))
    d_limber = d_limber.transpose(0, 1)                                 # (nl, nrow, nk)
    sw = torch.as_tensor(np.asarray(R.lim_switch), dtype=torch.float64, device=k.device)
    use_lim = lf[:, None] >= sw[None, :]
    return torch.where(use_lim[:, :, None], d_limber, delta)


def _source_eval(pert, cols, n_k=None):
    """s_eval(col, tau_row) -> (nk, ntau_row): the source column splined in
    tau (natural cubic spline per k) at the row's times."""
    taus = pert.tau
    tabs = {}
    for col in set(cols):
        S = pert.sources[:n_k, :, SrcIdx.ix[col]]              # (nk, ntau)
        tabs[col] = (S.T.contiguous(), spline_d2(taus, S.T.contiguous()))

    def s_eval(col, tau_row):
        y, d2 = tabs[col]
        return spline_eval(taus, y, d2, tau_row).T

    return s_eval


def _split_rows(delta, rows, ls, nbin):
    """(Delta_nc, Delta_sl), each (nl, nbin, nk): the sum of a bin's
    contribution rows, l(l+1) on nc_lens (spectra_compute_cl's nc block)."""
    lf = torch.as_tensor(np.asarray(ls), dtype=torch.float64, device=delta.device)
    llp1 = lf * (lf + 1.0)
    nl, nk = delta.shape[0], delta.shape[2]
    d_nc = torch.zeros((nl, nbin, nk), dtype=delta.dtype, device=delta.device)
    d_sl = torch.zeros_like(d_nc)
    for i, (t, b) in enumerate(rows):
        if t == "sl":
            d_sl[:, b] += delta[:, i]
        elif t == "lens":
            d_nc[:, b] += llp1[:, None] * delta[:, i]
        else:
            d_nc[:, b] += delta[:, i]
    return d_nc, d_sl


def compute_number_counts(pert, bg, bidx, pm, pr: PrecisionParams, sel_means, sel_widths,
                          kind="gaussian", l_max=300, non_diag=0, contributions=("density",),
                          selection_bias=None, magnification_bias=None, dndz=None,
                          dndz_evo=None) -> NumberCountsResult:
    """nCl / sCl spectra (numbercounts.py:155-236). contributions: a subset of
    density, rsd, lensing, gr; dndz / dndz_evo: None, "analytic" or a file
    path."""
    nbin = len(sel_means)
    R = _assemble_rows(bg, bidx, pr, sel_means, sel_widths, kind, contributions,
                       selection_bias, magnification_bias, dndz, dndz_evo, pert.tau0, True)
    k = pert.k
    ls = get_l_list(pr, l_max)
    delta = _delta_from_rows(k, _source_eval(pert, R.src_cols), R, ls)
    d_nc, d_sl = _split_rows(delta, R.rows, ls, nbin)
    # the k quadrature (spectra_compute_cl :958)
    meas = 4.0 * math.pi / k * pm.scalar_pk(k) * trapz_weights(k)

    def quad(a, b):
        return torch.sum(meas[None, :] * a * b, dim=-1)

    dd_pairs = tuple((i, j) for i in range(nbin)
                     for j in range(i, min(i + non_diag, nbin - 1) + 1))
    dl_pairs = tuple((i, j) for i in range(nbin) for j in range(nbin))
    cl_dd = torch.stack([quad(d_nc[:, i], d_nc[:, j]) for i, j in dd_pairs])
    cl_ll = torch.stack([quad(d_sl[:, i], d_sl[:, j]) for i, j in dd_pairs])
    cl_dl = torch.stack([quad(d_nc[:, i], d_sl[:, j]) for i, j in dl_pairs])
    ells = torch.arange(2, l_max + 1, device=k.device)
    to_all = _spline_to_all_l(ls, ells)
    return NumberCountsResult(ell=ells, dd=to_all(cl_dd), ll=to_all(cl_ll), dl=to_all(cl_dl),
                              dd_pairs=dd_pairs, dl_pairs=dl_pairs)

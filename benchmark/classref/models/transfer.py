"""Transfer functions Delta_l(q) by line-of-sight integration, in open,
flat and closed universes.

Counterpart of classpp_public_tpu/models/transfer.py (`get_l_list` :37,
`get_q_list` :55, `get_q_list_closed` :74, `_weighted_sources` :120-168,
`compute_transfer` :191, `_transfer_scan` :360-463, `_limber_parabola` :466,
`_curved_series_phi` :494, `_transfer_scan_curved` :534-685), for the
scalar modes.

The flat LOS scan runs spherical Bessel functions j_l(x) up the three-term
recurrence on the whole (q, tau) grid and, at every emitted l, contracts the
radial functions against the trapezoid-weighted sources. On a CUDA tensor it
is the hand-written kernel csrc/transfer_los.cu (`transfer_los`); on a CPU
tensor its plain version `transfer_los_plain` below. The q-neglect masks and
the Limber rows act on the (n_l, nq) result afterwards.

In a curved universe (K = -Omega_k H0^2 != 0) the scans run the
hyperspherical Bessel functions Phi_l^nu(x), x = sqrt|K| (tau0 - tau),
nu = q/sqrt|K|, up their own three-term recurrence, with the small-x curved
series at the emitted l and the closed model's discrete spectrum: the
kernel csrc/transfer_los_curved.cu (`transfer_los_curved`), whose plain
version is `transfer_los_curved_plain`. The sources are splined at k(q) =
sqrt(q^2 - K), carried in `TransferResult.k`.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import numpy as np
import torch

from ..config.precision import PrecisionParams
from ..ops.quadrature import trapz_weights
from ..ops.splines import spline_d2, spline_eval
from .perturbations.indices import SrcIdx

TT_TYPES = ["t0", "t1", "t2", "e", "lcmb"]


def get_l_list(pr: PrecisionParams, l_max: int, rescaling: float = 1.0) -> np.ndarray:
    """Multipole list: log spacing turning linear (transfer_get_l_list :694)."""
    ls = [2]
    current = 2
    inc = max(int(current * (pr.l_logstep**rescaling - 1.0)), 1)
    while current + inc < l_max and inc < pr.l_linstep * rescaling:
        current += inc
        ls.append(current)
        inc = max(int(current * (pr.l_logstep**rescaling - 1.0)), 1)
    inc = int(pr.l_linstep * rescaling)
    while current + inc <= l_max:
        current += inc
        ls.append(current)
    if current != l_max:
        ls.append(l_max)
    return np.array(ls, dtype=np.int64)


def get_q_list(pr: PrecisionParams, k_min: float, k_max: float,
               tau0: float, tau_rec: float, ang: float = 1.0) -> np.ndarray:
    """Flat q sampling: log step turning linear with period 2 pi/(tau0 -
    tau_rec) (transfer_get_q_list :884-1010)."""
    q_period = 2.0 * math.pi / (tau0 - tau_rec)
    q_logstep = pr.q_logstep_spline / ang ** pr.q_logstep_open
    qs = [k_min]
    q = k_min
    while q < k_max:
        q = q + q_period * pr.q_linstep * q / (q + pr.q_linstep / q_logstep)
        qs.append(q)
    if qs[-1] > k_max:
        qs.pop()
    return np.array(qs)


def get_q_list_closed(pr: PrecisionParams, q_max: float, tau0: float, tau_rec: float,
                      K: float) -> np.ndarray:
    """Closed-case q sampling (transfer_get_q_list :1013-1060; transfer.py:74-117):
    q = nu sqrt(K) with integer nu >= 3 below hyper_flat_approximation_nu
    (stepped by q_logstep_trapzd), then a q_numstep_transition-point blend into
    the flat spline stepping, where non-integer nu are fine."""
    sqK = math.sqrt(K)
    q_period = 2.0 * math.pi / (tau0 - tau_rec)
    qs = [3.0 * sqK]
    nu = 3
    last_step, last_index = sqK, 1
    i = 1
    while qs[-1] < q_max:
        qp = qs[-1]
        if nu < pr.hyper_flat_approximation_nu:
            q = qp + q_period * pr.q_linstep * qp / (qp + pr.q_linstep / pr.q_logstep_trapzd)
            nu_prop = int(q / sqK)
            nu = nu + 1 if nu_prop <= nu + 1 else nu_prop
            q = nu * sqK
            last_step = q - qp
            last_index = i + 1
        else:
            q_step = q_period * pr.q_linstep * qp / (qp + pr.q_linstep / pr.q_logstep_spline)
            f = (i - last_index) / pr.q_numstep_transition
            q = qp + ((1.0 - f) * last_step + f * q_step if f < 1.0 else q_step)
        qs.append(q)
        i += 1
    if qs[-1] > q_max and len(qs) > 2:
        qs.pop()
    return np.array(qs)


def q_grid(pr: PrecisionParams, k_min: float, k_max: float, tau0: float, tau_rec: float,
           ang: float, K: float, sgnK: int, m_mode: int = 0) -> tuple:
    """(q, k(q)) of the transfer functions over the source k range
    [k_min, k_max] (compute_transfer :208-230, compute_transfer_tensor
    :712-727): q^2 = k^2 + (1 + m) K with m = 0 scalars, 2 tensors; flat
    q = k, closed q on the discrete nu grid, open q stepped with the angular
    rescaling. k(q) is clamped to k_min from below."""
    if sgnK == 0:
        q = get_q_list(pr, k_min, k_max, tau0, tau_rec)
        return q, q
    mK = (1.0 + m_mode) * K
    if sgnK > 0:
        q = get_q_list_closed(pr, math.sqrt(k_max**2 + mK), tau0, tau_rec, K)
    else:
        floor = 1e-12 if m_mode == 0 else 1e-10
        q = get_q_list(pr, math.sqrt(max(k_min**2 + mK, floor * k_min**2)),
                       math.sqrt(k_max**2 + mK), tau0, tau_rec, ang=ang)
    return q, np.sqrt(np.maximum(q * q - mK, k_min**2))


class TransferResult(NamedTuple):
    l: torch.Tensor          # (nl,) multipoles
    q: torch.Tensor          # (nq,)
    delta: torch.Tensor      # (nl, ntt, nq) transfer functions, TT_TYPES order
    tau0: float
    k: torch.Tensor = None   # (nq,) k(q); equals q when flat


def _weighted_sources(pert, th, k_of_q: torch.Tensor, K: float = 0.0, sgnK: int = 0,
                      k_size: int = None):
    """Sources splined k -> k(q) (transfer_interpolate_sources :1767) with the
    trapezoidal tau weights folded in (transfer_sources :1845), and the lensing
    window of the lcmb row with its curved sinK form (:1920-1950). The spline
    runs over the first k_size modes (default: the CMB ones, k_size_cmb).
    Returns W, Sq (5, nq, ntau) and taus."""
    taus = pert.tau
    tau0 = pert.tau0
    n_k = k_size if k_size is not None else pert.k_size_cmb
    k = pert.k[:n_k]
    S = pert.sources[:n_k]
    six = SrcIdx.ix
    w_tau = trapz_weights(taus)
    tau_rec = th.tau_rec
    if sgnK == 0:
        resc = (tau_rec - taus) / (tau0 - taus) / (tau0 - tau_rec)
    else:
        sab = math.sqrt(abs(K))
        sinK, sin_rec = (torch.sin, math.sin) if sgnK > 0 else (torch.sinh, math.sinh)
        resc = sab * sinK(sab * (tau_rec - taus)) / sinK(sab * (tau0 - taus)) \
            / sin_rec(sab * (tau0 - tau_rec))
    resc = torch.where(taus > tau_rec, resc, 0.0)
    resc[-1] = 0.0
    src_cols = torch.stack([S[:, :, six["t0"]], S[:, :, six["t1"]], S[:, :, six["t2"]],
                            S[:, :, six["p"]], S[:, :, six["phi_plus_psi"]] * resc[None, :]],
                           dim=0)                                   # (ntt, nk, ntau)
    lnk = torch.log(k)
    y = src_cols.permute(1, 0, 2).reshape(S.shape[0], -1)
    yq = spline_eval(lnk, y, spline_d2(lnk, y), torch.log(k_of_q))
    Sq = yq.reshape(k_of_q.shape[0], len(TT_TYPES), S.shape[1]).permute(1, 0, 2)
    W = (Sq * w_tau[None, None, :]).contiguous()
    return W, Sq, taus


def _emit_tables(l_emit: np.ndarray, device):
    """emit_idx[l] = row of l in the output or -1; e_fac per emitted l."""
    lmax = int(l_emit[-1])
    emit_idx = np.full(lmax + 1, -1, dtype=np.int32)
    emit_idx[l_emit] = np.arange(len(l_emit), dtype=np.int32)
    lf = l_emit.astype(np.float64)
    e_fac = np.sqrt(3.0 / 8.0 * (lf + 2.0) * (lf + 1.0) * lf * (lf - 1.0))
    return (torch.as_tensor(emit_idx, device=device),
            torch.as_tensor(e_fac, dtype=torch.float64, device=device))


def transfer_los_plain(W: torch.Tensor, taus: torch.Tensor, tau0: float, q: torch.Tensor,
                       l_emit: np.ndarray, l_late: float,
                       late_mask: torch.Tensor) -> torch.Tensor:
    """Plain version of the LOS scan (_transfer_scan :369-444): a Python loop
    over l = 2..l_max on (nq, ntau) tensors. Returns (n_l, 5, nq) before the
    q-neglect masks and Limber."""
    f64 = W.dtype
    emit_idx, e_fac = _emit_tables(l_emit, "cpu")
    emit_idx = emit_idx.numpy()
    e_fac = e_fac.tolist()
    chi = tau0 - taus
    x = torch.clamp(q[:, None] * chi[None, :], min=1e-12)
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
    late_mask = late_mask.to(f64)
    acc = torch.zeros((len(l_emit), 5, q.shape[0]), dtype=f64, device=W.device)
    ln2 = math.log(2.0)
    jm1, jm2 = j1, j0
    for li in range(2, int(l_emit[-1]) + 1):
        l = float(li)
        jl = (2.0 * l - 1.0) * inv_x * jm1 - jm2
        jl = torch.where(l <= thr, jl, 0.0)
        ei = int(emit_idx[li])
        if ei >= 0:
            lndf = math.lgamma(2.0 * l + 2.0) - l * ln2 - math.lgamma(l + 1.0)
            lndf1 = math.lgamma(2.0 * l + 4.0) - (l + 1.0) * ln2 - math.lgamma(l + 2.0)
            c1 = 2.0 * l + 3.0
            corr = 1.0 - x2 / (2.0 * c1) * (1.0 - x2 / (4.0 * (c1 + 2.0))
                                            * (1.0 - x2 / (6.0 * (c1 + 4.0))))
            c1b = 2.0 * l + 5.0
            corr1 = 1.0 - x2 / (2.0 * c1b) * (1.0 - x2 / (4.0 * (c1b + 2.0))
                                              * (1.0 - x2 / (6.0 * (c1b + 4.0))))
            js = torch.exp(l * lnx - lndf) * corr
            js1 = torch.exp((l + 1.0) * lnx - lndf1) * corr1
            jl_e = torch.where(series, js, jl)
            jp_e = torch.where(series, l * inv_x * js - js1, jm1 - (l + 1.0) * inv_x * jl)
            jpp = -2.0 * inv_x * jp_e - (1.0 - l * (l + 1.0) * inv_x * inv_x) * jl_e
            rad_t2 = 0.5 * (3.0 * jpp + jl_e)
            rad_e = e_fac[ei] * jl_e * inv_x * inv_x
            late = late_mask if l > l_late else torch.ones_like(late_mask)
            acc[ei, 0] = (W[0] * jl_e).sum(-1)
            acc[ei, 1] = (W[1] * late * jp_e).sum(-1)
            acc[ei, 2] = (W[2] * late * rad_t2).sum(-1)
            acc[ei, 3] = (W[3] * late * rad_e).sum(-1)
            acc[ei, 4] = (W[4] * jl_e).sum(-1)
        jm2, jm1 = jm1, jl
    return acc


def transfer_los(W: torch.Tensor, taus: torch.Tensor, tau0: float, q: torch.Tensor,
                 l_emit: np.ndarray, l_late: float, late_mask: torch.Tensor) -> torch.Tensor:
    """The LOS Bessel scan: CUDA kernel for CUDA tensors, plain version for
    CPU tensors. W: (5, nq, ntau) float64 contiguous; taus (ntau,); q (nq,);
    l_emit: increasing emitted multipoles (numpy); late_mask (ntau,) bool.
    Returns (n_l, 5, nq)."""
    return transfer_los_plain(W, taus, tau0, q, l_emit, l_late, late_mask)


def _limber_parabola(taus, tau0, S_row, tau_lim):
    """[S chi](tau_lim) by the reference's 3-point parabola
    (transfer_limber_interpolate :3085). S_row (nq, ntau); tau_lim (nl, nq)."""
    chi = tau0 - taus
    V = S_row * chi[None, :]
    ntau = taus.shape[0]
    jst = torch.clamp(torch.searchsorted(taus, tau_lim.contiguous()), 1, ntau - 2)
    x1, x2, x3 = chi[jst - 1], chi[jst], chi[jst + 1]
    jT = jst.T
    V1 = torch.gather(V, 1, jT - 1).T
    V2 = torch.gather(V, 1, jT).T
    V3 = torch.gather(V, 1, jT + 1).T
    V3 = torch.where(jst == ntau - 2, V2, V3)
    xl = tau0 - tau_lim
    return (V1 * (xl - x2) * (xl - x3) / ((x1 - x2) * (x1 - x3))
            + V2 * (xl - x1) * (xl - x3) / ((x2 - x1) * (x2 - x3))
            + V3 * (xl - x1) * (xl - x2) / ((x3 - x1) * (x3 - x2)))


# ---------------------------------------------------------------------------
# Hyperspherical scans (curved universes)


def _curved_series_phi(l: float, x, lnx_df_C, Ktilde: float, beta2):
    """The small-x series of Phi_l^nu and its x-derivative (transfer.py:494-531):
    Phi_l = exp(lnx_df_C) (1 + c1 x^2 + c2 x^4 + c3 x^6), the c_i solving the
    hyperspherical equation order by order in x."""
    l2 = l * l
    c1 = (Ktilde * (l2 + 3.0 * l + 3.0) - 3.0 * beta2) / (6.0 * (2.0 * l + 3.0))
    c2 = (5.0 * l2 * l2 + 30.0 * l2 * l + 95.0 * l2 + 150.0 * l + 105.0
          - Ktilde * beta2 * (30.0 * l2 + 90.0 * l + 150.0) + 45.0 * beta2 * beta2
          + (12.0 * l2 * l + 38.0 * l2 + 30.0 * l)
          ) / (360.0 * (4.0 * l2 + 16.0 * l + 15.0))
    b2, b4, b6 = beta2, beta2 * beta2, beta2 * beta2 * beta2
    l3, l4, l5, l6 = l2 * l, l2 * l2, l2 * l2 * l, l2 * l2 * l2
    c3 = (Ktilde * (35.0 * l6 + 315.0 * l5 + 1680.0 * l4 + 5355.0 * l3
                    + 11200.0 * l2 + 13755.0 * l + 8085.0)
          - b2 * (315.0 * l4 + 1890.0 * l3 + 7245.0 * l2 + 13230.0 * l + 13755.0)
          + Ktilde * b4 * (945.0 * l2 + 2835.0 * l + 6615.0)
          + Ktilde * (252.0 * l5 + 2042.0 * l4 + 7188.0 * l3 + 11980.0 * l2
                      + 8442.0 * l + 1680.0)
          - 945.0 * b6
          - b2 * (756.0 * l3 + 2898.0 * l2 + 3402.0 * l + 1680.0)
          ) / (45360.0 * (8.0 * l3 + 60.0 * l2 + 142.0 * l + 105.0))
    x2 = x * x
    base = torch.exp(lnx_df_C)
    poly = 1.0 + x2 * (c1 + x2 * (c2 + x2 * c3))
    dpoly = x * (2.0 * c1 + x2 * (4.0 * c2 + x2 * 6.0 * c3))
    return base * poly, base * (l / x * poly + dpoly)


class _Hyper(NamedTuple):
    """The (q, tau) grid of a hyperspherical scan and its seeds
    (transfer.py:548-573): x = sqrt|K| chi, beta = q/sqrt|K|, sin_K, cot_K,
    the flat-equivalent argument beta x, the forbidden-region base
    6 cbrt(beta sin_K) + 2, and Phi_0, Phi_1."""

    x: torch.Tensor        # (1, ntau)
    beta: torch.Tensor     # (nq, 1)
    beta2: torch.Tensor
    sinK: torch.Tensor     # (1, ntau)
    cosK: torch.Tensor
    cotK: torch.Tensor
    bx: torch.Tensor       # (nq, ntau)
    xf: torch.Tensor       # beta sin_K
    buf6: torch.Tensor     # 6 cbrt(xf) + 2
    Phi0: torch.Tensor
    Phi1: torch.Tensor
    Ktilde: float


def _hyper_setup(taus, tau0: float, q, K: float, sgnK: int) -> _Hyper:
    sab = math.sqrt(abs(K))
    x = torch.clamp(sab * (tau0 - taus), min=1e-12)[None, :]
    beta = (q / sab)[:, None]
    if sgnK > 0:
        sinK, cosK, Kt = torch.sin(x), torch.cos(x), 1.0
    else:
        sinK, cosK, Kt = torch.sinh(x), torch.cosh(x), -1.0
    cotK = cosK / sinK
    beta2 = beta * beta
    bx = torch.clamp(beta * x, min=1e-12)
    bx2 = bx * bx
    j0f = torch.where(bx < 0.3, 1.0 - bx2 / 6.0 * (1.0 - bx2 / 20.0 * (1.0 - bx2 / 42.0)),
                      torch.sin(bx) / bx)
    Phi0 = j0f * (x / sinK)
    sq1 = torch.sqrt(torch.clamp(beta2 - Kt, min=1e-30))
    Phi1 = Phi0 * (cotK - beta / torch.tan(bx)) / sq1
    xf = beta * sinK
    return _Hyper(x, beta, beta2, sinK, cosK, cotK, bx, xf,
                  6.0 * torch.pow(xf, 1.0 / 3.0) + 2.0, Phi0, Phi1, Kt)


def _hyper_scan(h: _Hyper, sgnK: int, lmax: int, emit_idx: np.ndarray, lndf: np.ndarray,
                emit):
    """The upward recurrence of Phi_l^nu over l = 2..lmax on the (q, tau) grid
    (transfer.py:576-614): the forbidden region masked (closed: the buffer
    capped by the distance to nu, and l + 1/2 < nu), the running log
    prefactor lnC of the series carried, and at every emitted l
    emit(l, ei, Phi_l, dPhi_l/dx, d2Phi_l/dx2) with the series where
    beta x < 1 and the recurrence values elsewhere."""
    Kt, beta2 = h.Ktilde, h.beta2

    def sqK(lv):
        return torch.sqrt(torch.clamp(beta2 - Kt * lv * lv, min=1e-30))

    use_series = h.bx < 1.0
    lnbx = torch.log(h.bx)
    pm1, pm2 = h.Phi1, h.Phi0
    lnC = 0.5 * torch.log1p(-Kt * 1.0 / beta2)
    for li in range(2, lmax + 1):
        l = float(li)
        sq_l = sqK(l)
        pl = ((2.0 * l - 1.0) * h.cotK * pm1 - sqK(l - 1.0) * pm2) / sq_l
        if sgnK > 0:
            buf = torch.minimum(h.buf6, 0.5 * (h.beta - l) + 2.0)
            mask = (l <= h.xf + buf) & (l + 0.5 < h.beta)
        else:
            mask = l <= h.xf + h.buf6
        pl = torch.where(mask, pl, 0.0)
        lnC = lnC + 0.5 * torch.log1p(torch.clamp(-Kt * l * l / beta2, min=-1.0 + 1e-14))
        ei = int(emit_idx[li])
        if ei >= 0:
            js, djs = _curved_series_phi(l, h.x, l * lnbx - float(lndf[ei]) + lnC, Kt, beta2)
            pl_e = torch.where(use_series, js, pl)
            dp_e = torch.where(use_series, djs, sq_l * pm1 - (l + 1.0) * h.cotK * pl)
            d2p = -2.0 * dp_e * h.cotK + pl_e * (l * (l + 1.0) / (h.sinK * h.sinK) - beta2 + Kt)
            emit(l, ei, pl_e, dp_e, d2p)
        pm2, pm1 = pm1, pl


def transfer_los_curved_plain(W: torch.Tensor, taus: torch.Tensor, tau0: float,
                              q: torch.Tensor, kq: torch.Tensor, l_emit: np.ndarray,
                              l_late: float, late_mask: torch.Tensor, K: float,
                              sgnK: int) -> torch.Tensor:
    """Plain version of the hyperspherical LOS scan (_transfer_scan_curved
    :534-659): a Python loop over l = 2..l_max on (nq, ntau) tensors, the
    curved radial functions (transfer_radial_function :3413-3445) at the
    emitted l. kq: k(q). Returns (n_l, 5, nq) before the q-neglect masks and
    Limber."""
    emit_idx, e_fac, lndf = _series_emit_tables(np.asarray(l_emit))[:3]
    h = _hyper_setup(taus, tau0, q, K, sgnK)
    sab = math.sqrt(abs(K))
    k2 = (kq * kq)[:, None]
    s_l2 = torch.sqrt(1.0 - 3.0 * K / k2)
    absK_over_k2 = abs(K) / k2
    csc2 = abs(K) / (k2 * h.sinK * h.sinK)
    sab_over_k = sab / kq[:, None]
    late_mask = late_mask.to(W.dtype)
    acc = torch.zeros((len(l_emit), 5, q.shape[0]), dtype=W.dtype, device=W.device)

    def emit(l, ei, pl_e, dp_e, d2p):
        rad_t1 = sab_over_k * dp_e
        rad_t2 = (3.0 * absK_over_k2 * d2p + pl_e) / (2.0 * s_l2)
        rad_e = (float(e_fac[ei]) / s_l2) * csc2 * pl_e
        late = late_mask if l > l_late else torch.ones_like(late_mask)
        acc[ei, 0] = (W[0] * pl_e).sum(-1)
        acc[ei, 1] = (W[1] * late * rad_t1).sum(-1)
        acc[ei, 2] = (W[2] * late * rad_t2).sum(-1)
        acc[ei, 3] = (W[3] * late * rad_e).sum(-1)
        acc[ei, 4] = (W[4] * pl_e).sum(-1)

    _hyper_scan(h, sgnK, int(l_emit[-1]), emit_idx, lndf, emit)
    return acc


def transfer_los_curved(W: torch.Tensor, taus: torch.Tensor, tau0: float, q: torch.Tensor,
                        kq: torch.Tensor, l_emit: np.ndarray, l_late: float,
                        late_mask: torch.Tensor, K: float, sgnK: int) -> torch.Tensor:
    """The hyperspherical LOS scan: the CUDA kernel transfer_los_curved for
    CUDA tensors, the plain version for CPU tensors. W: (5, nq, ntau) float64
    contiguous; taus (ntau,); q, kq (nq,): q and k(q); l_emit: increasing
    emitted multipoles (numpy); late_mask (ntau,) bool; K != 0 the curvature,
    sgnK its sign. Returns (n_l, 5, nq)."""
    return transfer_los_curved_plain(W, taus, tau0, q, kq, l_emit, l_late, late_mask, K,
                                     sgnK)


def transfer_scan(W, Sq, taus, tau0: float, q, l_emit: np.ndarray, l_late: float,
                  late_mask, ra_rec: float, neglect_dk: tuple, l_switch_limber: float,
                  K: float = 0.0, sgnK: int = 0, kq=None):
    """The LOS stage of _transfer_scan (:360-463) and _transfer_scan_curved
    (:534-685): the Bessel scan (`transfer_los`) or, curved, the
    hyperspherical one (`transfer_los_curved`, kq = k(q)), then the q-neglect
    masks and the Limber rows for the lensing potential. Returns
    (n_l, 5, nq)."""
    if sgnK == 0:
        acc = transfer_los(W, taus, tau0, q, l_emit, l_late, late_mask)
        kq = q
    else:
        acc = transfer_los_curved(W, taus, tau0, q, kq, l_emit, l_late, late_mask, K, sgnK)
    lf = torch.as_tensor(np.asarray(l_emit), dtype=torch.float64, device=W.device)
    # q-neglect masks (transfer_can_be_neglected :3187): Delta ~ 0 when l is
    # far below the Bessel peak l ~ k ra_rec
    for i, dk in enumerate(neglect_dk):
        keep = lf[:, None] >= (kq[None, :] - dk) * ra_rec
        acc[:, i] = torch.where(keep, acc[:, i], 0.0)
    # Limber for the lensing potential above l_switch_limber
    # (transfer_use_limber :2678, transfer_limber :2912; curved :2926-2970:
    # the flat formula at the curved tau*(l, q), times (1 - K l^2/q^2)^-1/4)
    ipg = torch.sqrt(math.pi / (2.0 * lf)) * (1.0 - 0.25 / lf + 1.0 / (32.0 * lf * lf))
    if sgnK == 0:
        tau_lim = tau0 - (lf[:, None] + 0.5) / q[None, :]
    else:
        sab = math.sqrt(abs(K))
        if sgnK > 0:
            x_lim = torch.arcsin(torch.clamp(torch.sqrt(lf[:, None] * (lf[:, None] + 1.0))
                                             / q[None, :] * sab, 0.0, 1.0))
        else:
            x_lim = torch.arcsinh((lf[:, None] + 0.5) / q[None, :] * sab)
        tau_lim = tau0 - x_lim / sab
    S_at = _limber_parabola(taus, tau0, Sq[4], tau_lim)
    inside = (tau_lim > taus[0]) & (tau_lim < taus[-1])
    if sgnK == 0:
        d_limber = torch.where(inside, ipg[:, None] * S_at / (lf[:, None] + 0.5), 0.0)
    else:
        curv_fac = (1.0 - K * lf[:, None] ** 2 / q[None, :] ** 2) ** (-0.25)
        chi_lim = torch.clamp(tau0 - tau_lim, min=1e-30)
        d_limber = torch.where(inside, ipg[:, None] * curv_fac * S_at / (chi_lim * q[None, :]),
                               0.0)
    acc[:, 4] = torch.where((lf > l_switch_limber)[:, None], d_limber, acc[:, 4])
    return acc


def compute_transfer(pert, th, pr: PrecisionParams, l_max: int, K: float = 0.0,
                     sgnK: int = 0) -> TransferResult:
    """Delta_l^X(q) for X in TT_TYPES (compute_transfer :191-283); K the
    curvature, sgnK its sign."""
    if pr.phi_q_per_decade > 0.0:
        raise NotImplementedError(
            "the phi q-extension is not ported (classpp_public_tpu/models/transfer.py:286-316)")
    tau0 = float(pert.tau0)
    dev = pert.sources.device
    ls = get_l_list(pr, l_max)
    k_host = pert.k_np[: pert.k_size_cmb]
    ang = float(th.angular_rescaling)
    q_np, kq_np = q_grid(pr, float(k_host[0]), float(k_host[-1]), tau0, float(th.tau_rec), ang,
                         K, sgnK)
    q = torch.as_tensor(q_np, dtype=torch.float64, device=dev)
    kq = q if sgnK == 0 else torch.as_tensor(kq_np, dtype=torch.float64, device=dev)
    W, Sq, taus = _weighted_sources(pert, th, kq, K, sgnK)
    neglect_dk = (pr.transfer_neglect_delta_k_S_t0, pr.transfer_neglect_delta_k_S_t1,
                  pr.transfer_neglect_delta_k_S_t2, pr.transfer_neglect_delta_k_S_e)
    acc = transfer_scan(W, Sq, taus, tau0, q, ls, pr.transfer_neglect_late_source * ang,
                        taus <= th.tau_cut, (tau0 - float(th.tau_rec)) * ang, neglect_dk,
                        pr.l_switch_limber, K, sgnK, kq)
    return TransferResult(l=torch.as_tensor(ls, device=dev), q=q, delta=acc, tau0=tau0, k=kq)


def _series_emit_tables(l_emit: np.ndarray):
    """Per emitted l, on the host: the row index table emit_idx[l] (-1 where
    l is not emitted), the T2 (and scalar E) factor sqrt(3/8 (l+2)(l+1) l
    (l-1)) and the log double factorials of the small-x series, ln((2l+1)!!)
    and ln((2l+3)!!), from lgamma (:879-880, :635, :814)."""
    lmax = int(l_emit[-1])
    emit_idx = np.full(lmax + 1, -1, dtype=np.int32)
    emit_idx[l_emit] = np.arange(len(l_emit), dtype=np.int32)
    lf = l_emit.astype(np.float64)
    t2_fac = np.sqrt(3.0 / 8.0 * (lf + 2.0) * (lf + 1.0) * lf * (lf - 1.0))
    ln2 = math.log(2.0)
    lndf = np.array([math.lgamma(2.0 * v + 2.0) - v * ln2 - math.lgamma(v + 1.0) for v in lf])
    lndf1 = np.array([math.lgamma(2.0 * v + 4.0) - (v + 1.0) * ln2 - math.lgamma(v + 2.0)
                      for v in lf])
    return emit_idx, t2_fac, lndf, lndf1

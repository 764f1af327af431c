"""Transfer functions Delta_l(q) by line-of-sight integration, flat case.

Counterpart of classpp_public_tpu/models/transfer.py (`get_l_list` :37,
`get_q_list` :55, `_weighted_sources` :120-168, `compute_transfer` :191,
`_transfer_scan` :360-463, `_limber_parabola` :466, and the tensor modes'
`compute_transfer_tensor` :703-754, `_tensor_scan` :854-911).

The LOS scan runs spherical Bessel functions j_l(x) up the three-term
recurrence on the whole (q, tau) grid and, at every emitted l, contracts the
radial functions against the trapezoid-weighted sources. On a CUDA tensor it
is the hand-written kernel csrc/transfer_los.cu (`transfer_los`); on a CPU
tensor its plain version `transfer_los_plain` below. The q-neglect masks and
the Limber rows act on the (n_l, nq) result afterwards. The tensor scan has
the same shape: the kernel csrc/transfer_tensor_los.cu (`transfer_tensor_los`)
or its plain version `transfer_tensor_los_plain`, with the T2/E/B radial
functions and the q-neglect masks inside the scan.
"""

from __future__ import annotations

import ctypes
import math
from typing import NamedTuple

import numpy as np
import torch

from ..config.precision import PrecisionParams
from ..ops import cuda
from ..ops.quadrature import trapz_weights
from ..ops.splines import spline_d2, spline_eval
from .perturbations.indices import SrcIdx

TT_TYPES = ["t0", "t1", "t2", "e", "lcmb"]

# launches of the CUDA kernels transfer_los and transfer_tensor_los
# (incremented only where they are launched)
launches = 0
tensor_launches = 0


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


class TransferResult(NamedTuple):
    l: torch.Tensor          # (nl,) multipoles
    q: torch.Tensor          # (nq,)
    delta: torch.Tensor      # (nl, ntt, nq) transfer functions, TT_TYPES order
    tau0: float
    k: torch.Tensor = None   # (nq,) k(q); equals q when flat


def _weighted_sources(pert, th, q: torch.Tensor):
    """Sources splined k -> q (transfer_interpolate_sources :1767) with the
    trapezoidal tau weights folded in (transfer_sources :1845).
    Returns W, Sq (5, nq, ntau) and taus."""
    taus = pert.tau
    tau0 = pert.tau0
    n_k = pert.k_size_cmb
    k = pert.k[:n_k]
    S = pert.sources[:n_k]
    six = SrcIdx.ix
    w_tau = trapz_weights(taus)
    tau_rec = th.tau_rec
    resc = (tau_rec - taus) / (tau0 - taus) / (tau0 - tau_rec)
    resc = torch.where(taus > tau_rec, resc, 0.0)
    resc[-1] = 0.0
    src_cols = torch.stack([S[:, :, six["t0"]], S[:, :, six["t1"]], S[:, :, six["t2"]],
                            S[:, :, six["p"]], S[:, :, six["phi_plus_psi"]] * resc[None, :]],
                           dim=0)                                   # (ntt, nk, ntau)
    lnk = torch.log(k)
    y = src_cols.permute(1, 0, 2).reshape(S.shape[0], -1)
    yq = spline_eval(lnk, y, spline_d2(lnk, y), torch.log(q))
    Sq = yq.reshape(q.shape[0], len(TT_TYPES), S.shape[1]).permute(1, 0, 2)
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
    global launches
    if W.device.type == "cpu":
        return transfer_los_plain(W, taus, tau0, q, l_emit, l_late, late_mask)
    if W.device.type != "cuda":
        raise ValueError(f"transfer_los: unsupported device {W.device}")
    ntt, nq, ntau = W.shape
    if ntt != 5 or taus.shape != (ntau,) or q.shape != (nq,) or late_mask.shape != (ntau,):
        raise ValueError(f"transfer_los: bad shapes W{tuple(W.shape)} taus{tuple(taus.shape)} "
                         f"q{tuple(q.shape)} late_mask{tuple(late_mask.shape)}")
    for name, t in (("W", W), ("taus", taus), ("q", q)):
        if t.dtype != torch.float64 or not t.is_contiguous() or t.device != W.device:
            raise ValueError(f"transfer_los: {name} must be contiguous float64 on {W.device}")
    if ntau > 1024:
        raise ValueError(f"transfer_los: ntau = {ntau} > 1024 per q block")
    lib = cuda.library()
    emit_idx, e_fac = _emit_tables(np.asarray(l_emit), W.device)
    late = late_mask.to(device=W.device, dtype=torch.float64).contiguous()
    out = torch.empty((len(l_emit), 5, nq), dtype=torch.float64, device=W.device)
    err = lib.transfer_los_launch(
        W.data_ptr(), taus.data_ptr(), float(tau0), q.data_ptr(), emit_idx.data_ptr(),
        e_fac.data_ptr(), late.data_ptr(), float(l_late), nq, ntau, int(l_emit[-1]),
        len(l_emit), out.data_ptr(), cuda.stream_ptr(W.device))
    cuda.check(err, "transfer_los")
    launches += 1
    return out


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


def transfer_scan(W, Sq, taus, tau0: float, q, l_emit: np.ndarray, l_late: float,
                  late_mask, ra_rec: float, neglect_dk: tuple, l_switch_limber: float):
    """The flat LOS stage of _transfer_scan (:360-463): the Bessel scan
    (`transfer_los`), then the q-neglect masks and the Limber rows for the
    lensing potential. Returns (n_l, 5, nq)."""
    acc = transfer_los(W, taus, tau0, q, l_emit, l_late, late_mask)
    lf = torch.as_tensor(np.asarray(l_emit), dtype=torch.float64, device=W.device)
    # q-neglect masks (transfer_can_be_neglected :3187): Delta ~ 0 when l is
    # far below the Bessel peak l ~ k ra_rec
    for i, dk in enumerate(neglect_dk):
        keep = lf[:, None] >= (q[None, :] - dk) * ra_rec
        acc[:, i] = torch.where(keep, acc[:, i], 0.0)
    # Limber for the lensing potential above l_switch_limber
    # (transfer_use_limber :2678, transfer_limber :2912)
    ipg = torch.sqrt(math.pi / (2.0 * lf)) * (1.0 - 0.25 / lf + 1.0 / (32.0 * lf * lf))
    tau_lim = tau0 - (lf[:, None] + 0.5) / q[None, :]
    S_at = _limber_parabola(taus, tau0, Sq[4], tau_lim)
    inside = (tau_lim > taus[0]) & (tau_lim < taus[-1])
    d_limber = torch.where(inside, ipg[:, None] * S_at / (lf[:, None] + 0.5), 0.0)
    acc[:, 4] = torch.where((lf > l_switch_limber)[:, None], d_limber, acc[:, 4])
    return acc


def compute_transfer(pert, th, pr: PrecisionParams, l_max: int) -> TransferResult:
    """Delta_l^X(q) for X in TT_TYPES, flat geometry."""
    if pr.phi_q_per_decade > 0.0:
        raise NotImplementedError(
            "the phi q-extension is not ported (classpp_public_tpu/models/transfer.py:286-316)")
    tau0 = float(pert.tau0)
    dev = pert.sources.device
    ls = get_l_list(pr, l_max)
    k_host = pert.k_np[: pert.k_size_cmb]
    q_np = get_q_list(pr, float(k_host[0]), float(k_host[-1]), tau0, float(th.tau_rec))
    q = torch.as_tensor(q_np, dtype=torch.float64, device=dev)
    W, Sq, taus = _weighted_sources(pert, th, q)
    ang = float(th.angular_rescaling)
    neglect_dk = (pr.transfer_neglect_delta_k_S_t0, pr.transfer_neglect_delta_k_S_t1,
                  pr.transfer_neglect_delta_k_S_t2, pr.transfer_neglect_delta_k_S_e)
    acc = transfer_scan(W, Sq, taus, tau0, q, ls, pr.transfer_neglect_late_source * ang,
                        taus <= th.tau_cut, (tau0 - float(th.tau_rec)) * ang, neglect_dk,
                        pr.l_switch_limber)
    return TransferResult(l=torch.as_tensor(ls, device=dev), q=q, delta=acc, tau0=tau0, k=q)


# ---------------------------------------------------------------------------
# Tensor transfer functions (transfer.py:680-911, flat)

TT_TYPES_TENSOR = ["t2", "e", "b"]


def _tensor_emit_tables(l_emit: np.ndarray):
    """Per emitted l, on the host: the row index table emit_idx[l] (-1 where
    l is not emitted), the T2 factor sqrt(3/8 (l+2)(l+1) l (l-1)) and the
    log double factorials of the small-x series, ln((2l+1)!!) and
    ln((2l+3)!!), from lgamma (:879-880)."""
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


def transfer_tensor_los_plain(W: torch.Tensor, taus: torch.Tensor, tau0: float,
                              q: torch.Tensor, l_emit: np.ndarray, ra_rec: float,
                              neglect_dk: tuple) -> torch.Tensor:
    """Plain version of the tensor LOS scan (_tensor_scan :854-911): a Python
    loop over l = 2..l_max on (nq, ntau) tensors, the T2/E/B radial functions
    at the emitted l and the q-neglect masks. W: (2, nq, ntau) weighted
    S_T2, S_P. Returns (n_l, 3, nq)."""
    f64 = W.dtype
    emit_idx, t2_fac, lndf_l, lndf1_l = _tensor_emit_tables(np.asarray(l_emit))
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
    acc = torch.zeros((len(l_emit), 3, q.shape[0]), dtype=f64, device=W.device)
    jm1, jm2 = j1, j0
    for li in range(2, int(l_emit[-1]) + 1):
        l = float(li)
        jl = (2.0 * l - 1.0) * inv_x * jm1 - jm2
        jl = torch.where(l <= thr, jl, 0.0)
        ei = int(emit_idx[li])
        if ei >= 0:
            c1 = 2.0 * l + 3.0
            corr = 1.0 - x2 / (2.0 * c1) * (1.0 - x2 / (4.0 * (c1 + 2.0))
                                            * (1.0 - x2 / (6.0 * (c1 + 4.0))))
            c1b = 2.0 * l + 5.0
            corr1 = 1.0 - x2 / (2.0 * c1b) * (1.0 - x2 / (4.0 * (c1b + 2.0))
                                              * (1.0 - x2 / (6.0 * (c1b + 4.0))))
            js = torch.exp(l * lnx - float(lndf_l[ei])) * corr
            js1 = torch.exp((l + 1.0) * lnx - float(lndf1_l[ei])) * corr1
            jl_e = torch.where(series, js, jl)
            jp_e = torch.where(series, l * inv_x * js - js1, jm1 - (l + 1.0) * inv_x * jl)
            jpp = -2.0 * inv_x * jp_e - (1.0 - l * (l + 1.0) * inv_x * inv_x) * jl_e
            rad_t2 = float(t2_fac[ei]) * jl_e * inv_x * inv_x
            rad_e = 0.25 * (jpp + 4.0 * inv_x * jp_e - (1.0 - 2.0 * inv_x * inv_x) * jl_e)
            rad_b = 0.5 * (jp_e + 2.0 * inv_x * jl_e)
            rows = ((W[0] * rad_t2).sum(-1), (W[1] * rad_e).sum(-1), (W[1] * rad_b).sum(-1))
            for c, (row, dk) in enumerate(zip(rows, neglect_dk)):
                acc[ei, c] = torch.where(l >= (q - dk) * ra_rec, row, 0.0)
        jm2, jm1 = jm1, jl
    return acc


def transfer_tensor_los(W: torch.Tensor, taus: torch.Tensor, tau0: float, q: torch.Tensor,
                        l_emit: np.ndarray, ra_rec: float, neglect_dk: tuple) -> torch.Tensor:
    """The tensor LOS Bessel scan: the CUDA kernel transfer_tensor_los for
    CUDA tensors, the plain version for CPU tensors. W: (2, nq, ntau) float64
    contiguous; taus (ntau,); q (nq,); l_emit: increasing emitted multipoles
    (numpy); neglect_dk: the (t2, e, b) q-neglect offsets. Returns
    (n_l, 3, nq)."""
    global tensor_launches
    if W.device.type == "cpu":
        return transfer_tensor_los_plain(W, taus, tau0, q, l_emit, ra_rec, neglect_dk)
    if W.device.type != "cuda":
        raise ValueError(f"transfer_tensor_los: unsupported device {W.device}")
    ntt, nq, ntau = W.shape
    if ntt != 2 or taus.shape != (ntau,) or q.shape != (nq,) or len(neglect_dk) != 3:
        raise ValueError(f"transfer_tensor_los: bad shapes W{tuple(W.shape)} "
                         f"taus{tuple(taus.shape)} q{tuple(q.shape)}")
    for name, t in (("W", W), ("taus", taus), ("q", q)):
        if t.dtype != torch.float64 or not t.is_contiguous() or t.device != W.device:
            raise ValueError(f"transfer_tensor_los: {name} must be contiguous float64 on "
                             f"{W.device}")
    if ntau > 1024:
        raise ValueError(f"transfer_tensor_los: ntau = {ntau} > 1024 per q block")
    lib = cuda.library()
    emit_idx, t2_fac, lndf, lndf1 = _tensor_emit_tables(np.asarray(l_emit))
    emit = torch.as_tensor(emit_idx, device=W.device)
    per_l = torch.as_tensor(np.stack([t2_fac, lndf, lndf1]), dtype=torch.float64,
                            device=W.device)
    dk = (ctypes.c_double * 3)(*(float(v) for v in neglect_dk))
    out = torch.empty((len(l_emit), 3, nq), dtype=torch.float64, device=W.device)
    err = lib.transfer_tensor_los_launch(
        W.data_ptr(), taus.data_ptr(), float(tau0), q.data_ptr(), emit.data_ptr(),
        per_l.data_ptr(), float(ra_rec), dk, nq, ntau, int(l_emit[-1]), len(l_emit),
        out.data_ptr(), cuda.stream_ptr(W.device))
    cuda.check(err, "transfer_tensor_los")
    tensor_launches += 1
    return out


def compute_transfer_tensor(tpert, th, pr: PrecisionParams, l_max: int) -> TransferResult:
    """Tensor Delta_l^{T2,E,B}(q), flat geometry (compute_transfer_tensor
    :703-754): the sources splined k -> q with the trapezoid tau weights,
    then the tensor LOS scan (`transfer_tensor_los`)."""
    tau0 = float(tpert.tau0)
    dev = tpert.sources.device
    ls = get_l_list(pr, l_max)
    k = tpert.k_np
    q_np = get_q_list(pr, float(k[0]), float(k[-1]), tau0, float(th.tau_rec))
    q = torch.as_tensor(q_np, dtype=torch.float64, device=dev)
    taus = tpert.tau
    S = tpert.sources                                      # (nk, ntau, 2)
    lnk = torch.log(tpert.k)
    y = S.reshape(S.shape[0], -1)
    yq = spline_eval(lnk, y, spline_d2(lnk, y), torch.log(q))
    Sq = yq.reshape(len(q_np), S.shape[1], 2).permute(2, 0, 1)
    W = (Sq * trapz_weights(taus)[None, None, :]).contiguous()
    neglect_dk = (pr.transfer_neglect_delta_k_T_t2, pr.transfer_neglect_delta_k_T_e,
                  pr.transfer_neglect_delta_k_T_b)
    ra_rec = (tau0 - float(th.tau_rec)) * float(th.angular_rescaling)
    acc = transfer_tensor_los(W, taus, tau0, q, ls, ra_rec, neglect_dk)
    return TransferResult(l=torch.as_tensor(ls, device=dev), q=q, delta=acc, tau0=tau0, k=q)

"""Harmonic spectra C_l of the scalar adiabatic mode (counterpart of
classpp_public_tpu/models/spectra.py `cl_quad_weights` :27-62 and
`compute_spectra` :95; open, flat or closed).

C_l^XY = int dk (4 pi/k) P_R(k) Delta_l^X Delta_l^Y over k(q) with the
reference's spline integrator (array_integrate_all_trapzd_or_spline,
tools/arrays.c:1382; closed: a trapezoid over the integer-nu part of the q
grid and the first mode's weight restored), then a cubic spline over the
sparse l list to every integer l.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import numpy as np
import torch

from ..ops.splines import spline_d2, spline_eval
from .primordial import PrimordialResult
from .transfer import TT_TYPES, TransferResult

CT_TYPES = ["tt", "ee", "te", "bb", "pp", "tp", "ep"]


def cl_quad_weights(x: torch.Tensor, sgnK: int = 0, q0_over_k0: float = 1.0,
                    sqrtK: float = 0.0, q_flat_idx: int = 0) -> torch.Tensor:
    """Weights w with sum(w y) == the reference's est-deriv spline integral of
    y over x. The integral is linear in y, so w is its gradient: one reverse
    pass through the tridiagonal spline solve (torch.autograd.grad of the
    same scalar the JAX package differentiates with jax.grad). Closed
    (sgnK = 1): the segments below q_flat_idx, where nu is an integer and the
    steps jump, are trapezoids, and the discrete sum's first mode adds
    y[0] q0/k0 sqrt(K)/2 (spectra_module.cpp:1309-1337). Computed on the
    host; returned on x's device. The +h^3/24 sign follows the reference
    (tools/arrays.c:1419)."""
    xh = x.detach().to("cpu", torch.float64)
    y = torch.zeros_like(xh, requires_grad=True)
    y2 = spline_d2(xh, y, bc="est_deriv")
    h = torch.diff(xh)
    seg_tr = h * (y[:-1] + y[1:]) / 2.0
    seg_sp = seg_tr + h**3 * (y2[:-1] + y2[1:]) / 24.0
    if sgnK == 1:
        i = torch.arange(seg_sp.shape[0])
        total = torch.where(i < q_flat_idx, seg_tr, seg_sp).sum() \
            + y[0] * (q0_over_k0 * sqrtK / 2.0)
    else:
        total = seg_sp.sum()
    (w,) = torch.autograd.grad(total, y)
    return w.to(x.device)


def quad_kw(tr: TransferResult, sgnK: int, K: float, q_flat_nu: float) -> dict:
    """The closed case's arguments of `cl_quad_weights` for the transfer
    result tr (spectra.py:103-110): q0/k0, sqrt(K), and the index below which
    nu = q/sqrt(K) < q_flat_nu is an integer."""
    if sgnK != 1:
        return {"sgnK": sgnK}
    q_np = tr.q.cpu().numpy()
    return dict(sgnK=sgnK, q0_over_k0=float(q_np[0]) / float(tr.k[0]), sqrtK=math.sqrt(K),
                q_flat_idx=int(np.searchsorted(q_np, q_flat_nu * math.sqrt(K))))


class SpectraResult(NamedTuple):
    ell: torch.Tensor       # (nl_out,) integer multipoles 2..l_max
    cl: torch.Tensor        # (nl_out, nct) raw C_l per CT_TYPES
    l_list: torch.Tensor    # sparse computation multipoles
    cl_list: torch.Tensor   # (nl_list, nct)


def _rows(tr: TransferResult):
    """(T, E, lcmb) transfer rows (nl, nq) of a transfer result."""
    ix = {n: i for i, n in enumerate(TT_TYPES)}
    d = tr.delta
    return d[:, ix["t0"]] + d[:, ix["t1"]] + d[:, ix["t2"]], d[:, ix["e"]], d[:, ix["lcmb"]]


def compute_spectra(tr: TransferResult, pm: PrimordialResult, l_max: int,
                    sgnK: int = 0, K: float = 0.0, q_flat_nu: float = 0.0) -> SpectraResult:
    """C_l from the transfer functions: the quadrature over k(q) with the
    primordial spectrum at k (spectra_compute_cl :958); sgnK, K and the
    closed grid's hyper_flat_approximation_nu (q_flat_nu) select the closed
    quadrature."""
    q = tr.k if tr.k is not None else tr.q
    meas = 4.0 * math.pi / q * pm.scalar_pk(q)
    t_total, e, p = _rows(tr)
    wq = cl_quad_weights(q, **quad_kw(tr, sgnK, K, q_flat_nu))
    prods = torch.stack([t_total * t_total, e * e, t_total * e, p * p, t_total * p, e * p])
    tt, ee, te, pp, tp, ep = torch.einsum("pln,n->pl", prods, wq * meas)
    cl_list = torch.stack([tt, ee, te, torch.zeros_like(tt), pp, tp, ep], dim=1)
    l_f = tr.l.to(torch.float64)
    ells = torch.arange(2, l_max + 1, device=q.device)
    cl_all = spline_eval(l_f, cl_list, spline_d2(l_f, cl_list), ells.to(torch.float64))
    return SpectraResult(ell=ells, cl=cl_all, l_list=tr.l, cl_list=cl_list)

"""Harmonic spectra C_l (counterpart of classpp_public_tpu/models/spectra.py
`cl_quad_weights` :27-62 and `compute_spectra` :95, with its isocurvature
pairs :142-178 and its tensor branch :186-223; open, flat or closed).

C_l^XY = int dk (4 pi/k) P_R(k) Delta_l^X Delta_l^Y over k(q) with the
reference's spline integrator (array_integrate_all_trapzd_or_spline,
tools/arrays.c:1382; closed: a trapezoid over the integer-nu part of the q
grid and the first mode's weight restored), then a cubic spline over the
sparse l list to every integer l. With isocurvature modes every correlated
pair (ic1, ic2) adds its symmetrised products 0.5 (X1 Y2 + X2 Y1) with the
measure 4 pi/k P_12(k): the diagonal pairs once, the off-diagonal ones twice
(spectra_module.cpp:305-308, :1155-1183); each pair's C_l on the sparse list
is kept in `cl_pairs`. Tensor modes add T2 T2, E E, T2 E and B B with the
measure 4 pi/k P_h(k), splined to every integer l and zero above
l_max_tensors.
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
    cl_tensor: torch.Tensor = None   # (nl_out, nct) the tensor modes' part of cl
    # with isocurvature modes: {(ic1, ic2): (nl_list, nct)} each correlated
    # pair's C_l on the sparse list, ("ad", "ad") first; the total counts the
    # off-diagonal pairs twice
    cl_pairs: dict = None


def _tensor_cls(tr_tensor: TransferResult, pm: PrimordialResult, ells: torch.Tensor,
                quad: dict) -> torch.Tensor:
    """The tensor C_l at the integer multipoles `ells`, CT_TYPES columns
    (TT, EE, TE, BB; zero above the tensor l list); quad: the
    `cl_quad_weights` arguments of the tensor q grid."""
    qt = tr_tensor.k if tr_tensor.k is not None else tr_tensor.q
    meas_t = 4.0 * math.pi / qt * pm.tensor_pk(qt)
    d = tr_tensor.delta                                  # (nl_t, 3, nq_t): t2, e, b
    t2, e, b = d[:, 0], d[:, 1], d[:, 2]
    prods = torch.stack([t2 * t2, e * e, t2 * e, b * b])
    tot = torch.einsum("pln,n->pl", prods, cl_quad_weights(qt, **quad) * meas_t)
    zero = torch.zeros_like(tot[0])
    cl_list = torch.stack([tot[0], tot[1], tot[2], tot[3], zero, zero, zero], dim=1)
    lt = tr_tensor.l.to(torch.float64)
    ells_f = ells.to(torch.float64)
    cl = spline_eval(lt, cl_list, spline_d2(lt, cl_list), torch.minimum(ells_f, lt[-1]))
    return torch.where((ells <= tr_tensor.l[-1])[:, None], cl, 0.0)


def _rows(tr: TransferResult):
    """(T, E, lcmb) transfer rows (nl, nq) of a transfer result."""
    ix = {n: i for i, n in enumerate(TT_TYPES)}
    d = tr.delta
    return d[:, ix["t0"]] + d[:, ix["t1"]] + d[:, ix["t2"]], d[:, ix["e"]], d[:, ix["lcmb"]]


def compute_spectra(tr: TransferResult, pm: PrimordialResult, l_max: int,
                    tr_tensor: TransferResult = None, sgnK: int = 0, K: float = 0.0,
                    q_flat_nu: float = 0.0, tr_iso: dict = None) -> SpectraResult:
    """C_l from the transfer functions: the quadrature over k(q) with the
    primordial spectrum at k (spectra_compute_cl :958); sgnK, K and the
    closed grid's hyper_flat_approximation_nu (q_flat_nu) select the closed
    quadrature. tr_iso: {ic: TransferResult} of the isocurvature modes on the
    adiabatic q grid."""
    q = tr.k if tr.k is not None else tr.q
    meas = 4.0 * math.pi / q * pm.scalar_pk(q)
    t_total, e, p = _rows(tr)
    wq = cl_quad_weights(q, **quad_kw(tr, sgnK, K, q_flat_nu))
    prods = torch.stack([t_total * t_total, e * e, t_total * e, p * p, t_total * p, e * p])
    tt, ee, te, pp, tp, ep = torch.einsum("pln,n->pl", prods, wq * meas)
    cl_list = torch.stack([tt, ee, te, torch.zeros_like(tt), pp, tp, ep], dim=1)
    cl_pairs = None
    if tr_iso:
        rows = {"ad": (t_total, e, p), **{ic: _rows(t) for ic, t in tr_iso.items()}}

        def pair(pk12, r1, r2):
            t1, e1, p1 = rows[r1]
            t2, e2, p2 = rows[r2]
            sym = torch.stack([0.5 * (a * b2 + a2 * b) for a, b, a2, b2 in (
                (t1, t1, t2, t2), (e1, e1, e2, e2), (t1, e1, t2, e2), (p1, p1, p2, p2),
                (t1, p1, t2, p2), (e1, p1, e2, p2))])
            c = torch.einsum("pln,n->pl", sym, wq * (4.0 * math.pi / q * pk12))
            return torch.stack([c[0], c[1], c[2], torch.zeros_like(c[0]), c[3], c[4], c[5]],
                               dim=1)

        cl_pairs = {("ad", "ad"): cl_list}
        for ic in tr_iso:
            cl_pairs[(ic, ic)] = pair(pm.iso_pk(ic, q), ic, ic)
            cl_list = cl_list + cl_pairs[(ic, ic)]
        names = ["ad"] + list(tr_iso)
        for i1, n1 in enumerate(names):
            for n2 in names[i1 + 1:]:
                pk12 = pm.cross_pk(n1, n2, q)
                if pk12 is not None:
                    cl_pairs[(n1, n2)] = pair(pk12, n1, n2)
                    cl_list = cl_list + 2.0 * cl_pairs[(n1, n2)]
    l_f = tr.l.to(torch.float64)
    ells = torch.arange(2, l_max + 1, device=q.device)
    cl_all = spline_eval(l_f, cl_list, spline_d2(l_f, cl_list), ells.to(torch.float64))
    cl_t = None
    if tr_tensor is not None:
        cl_t = _tensor_cls(tr_tensor, pm, ells, quad_kw(tr_tensor, sgnK, K, q_flat_nu))
        cl_all = cl_all + cl_t
    return SpectraResult(ell=ells, cl=cl_all, l_list=tr.l, cl_list=cl_list, cl_tensor=cl_t,
                         cl_pairs=cl_pairs)

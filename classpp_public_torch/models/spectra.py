"""Harmonic spectra C_l (counterpart of classpp_public_tpu/models/spectra.py
`cl_quad_weights` :27-62 and `compute_spectra` :95, flat adiabatic case).

C_l^XY = int dk (4 pi/k) P_R(k) Delta_l^X Delta_l^Y with the reference's
spline integrator (array_integrate_all_trapzd_or_spline, tools/arrays.c:1382),
then a cubic spline over the sparse l list to every integer l.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import torch

from ..ops.splines import spline_d2, spline_eval
from .primordial import PrimordialResult
from .transfer import TT_TYPES, TransferResult

CT_TYPES = ["tt", "ee", "te", "bb", "pp", "tp", "ep"]


def cl_quad_weights(x: torch.Tensor) -> torch.Tensor:
    """Weights w with sum(w y) == the reference's est-deriv spline integral of
    y over x. The integral is linear in y, so w is its gradient: one reverse
    pass through the tridiagonal spline solve (torch.autograd.grad of the
    same scalar the JAX package differentiates with jax.grad). Computed on
    the host; returned on x's device. The +h^3/24 sign follows the
    reference (tools/arrays.c:1419)."""
    xh = x.detach().to("cpu", torch.float64)
    y = torch.zeros_like(xh, requires_grad=True)
    y2 = spline_d2(xh, y, bc="est_deriv")
    h = torch.diff(xh)
    total = (h * (y[:-1] + y[1:]) / 2.0 + h**3 * (y2[:-1] + y2[1:]) / 24.0).sum()
    (w,) = torch.autograd.grad(total, y)
    return w.to(x.device)


class SpectraResult(NamedTuple):
    ell: torch.Tensor       # (nl_out,) integer multipoles 2..l_max
    cl: torch.Tensor        # (nl_out, nct) raw C_l per CT_TYPES
    l_list: torch.Tensor    # sparse computation multipoles
    cl_list: torch.Tensor   # (nl_list, nct)


def compute_spectra(tr: TransferResult, pm: PrimordialResult, l_max: int) -> SpectraResult:
    q = tr.k if tr.k is not None else tr.q
    meas = 4.0 * math.pi / q * pm.scalar_pk(q)
    ix = {n: i for i, n in enumerate(TT_TYPES)}
    d = tr.delta
    t_total = d[:, ix["t0"]] + d[:, ix["t1"]] + d[:, ix["t2"]]
    e = d[:, ix["e"]]
    p = d[:, ix["lcmb"]]
    wq = cl_quad_weights(q)
    prods = torch.stack([t_total * t_total, e * e, t_total * e, p * p, t_total * p, e * p])
    tt, ee, te, pp, tp, ep = torch.einsum("pln,n->pl", prods, wq * meas)
    cl_list = torch.stack([tt, ee, te, torch.zeros_like(tt), pp, tp, ep], dim=1)
    l_f = tr.l.to(torch.float64)
    ells = torch.arange(2, l_max + 1, device=q.device)
    cl_all = spline_eval(l_f, cl_list, spline_d2(l_f, cl_list), ells.to(torch.float64))
    return SpectraResult(ell=ells, cl=cl_all, l_list=tr.l, cl_list=cl_list)

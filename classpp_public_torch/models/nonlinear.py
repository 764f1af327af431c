"""Linear matter power spectrum (counterpart of
classpp_public_tpu/models/nonlinear.py `pk_linear_at_z` :82; reference
nonlinear_pk_linear :1886). Halofit is not ported yet."""

from __future__ import annotations

import math

import torch

from ..ops.splines import spline_d2, spline_eval
from .background import tau_of_z
from .perturbations.indices import SrcIdx
from .primordial import PrimordialResult


def pk_linear_at_z(pert, bg, pm: PrimordialResult, z, col: str = "delta_m") -> torch.Tensor:
    """P(k, z) = 2 pi^2 / k^3 P_R(k) delta(k, z)^2, delta splined in tau."""
    tau_q = tau_of_z(bg, z).to(pert.tau.device)
    S = pert.sources[:, :, SrcIdx.ix[col]].T.contiguous()     # (ntau, nk)
    delta = spline_eval(pert.tau, S, spline_d2(pert.tau, S), tau_q)
    k = pert.k
    return 2.0 * math.pi**2 / k**3 * pm.scalar_pk(k) * delta**2

"""Primordial spectra: the analytic scalar and tensor power laws with running
(counterpart of classpp_public_tpu/models/primordial.py `scalar_pk` :66,
`tensor_pk` :74, `compute_primordial` :97;
primordial_analytic_spectrum_init, primordial_module.cpp:675)."""

from __future__ import annotations

from typing import NamedTuple

import torch

from ..config.params import CosmoParams


class PrimordialResult(NamedTuple):
    A_s: float
    n_s: float
    alpha_s: float
    k_pivot: float
    r: float
    n_t: float
    alpha_t: float

    def scalar_pk(self, k: torch.Tensor) -> torch.Tensor:
        """Dimensionless curvature spectrum P_R(k) (primordial_module.cpp:69)."""
        lnk = torch.log(k / self.k_pivot)
        return self.A_s * torch.exp((self.n_s - 1.0) * lnk + 0.5 * self.alpha_s * lnk**2)

    def tensor_pk(self, k: torch.Tensor) -> torch.Tensor:
        """Primordial tensor spectrum P_h(k) = r A_s (k/k_pivot)^(n_t + alpha_t/2 ln(k/k_pivot))
        (primordial.py:74-79)."""
        lnk = torch.log(k / self.k_pivot)
        return self.r * self.A_s * torch.exp(self.n_t * lnk + 0.5 * self.alpha_t * lnk**2)


def compute_primordial(params: CosmoParams) -> PrimordialResult:
    return PrimordialResult(A_s=params.A_s, n_s=params.n_s, alpha_s=params.alpha_s,
                            k_pivot=params.k_pivot, r=params.r, n_t=params.n_t,
                            alpha_t=params.alpha_t)

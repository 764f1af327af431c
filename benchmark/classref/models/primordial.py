"""Primordial spectra: the analytic scalar power law with running
(counterpart of classpp_public_tpu/models/primordial.py `scalar_pk` :66,
`compute_primordial` :97; primordial_analytic_spectrum_init,
primordial_module.cpp:675-758)."""

from __future__ import annotations

from typing import NamedTuple

import torch

from ..config.params import CosmoParams


class PrimordialResult(NamedTuple):
    A_s: float
    n_s: float
    alpha_s: float
    k_pivot: float

    def scalar_pk(self, k: torch.Tensor) -> torch.Tensor:
        """Dimensionless curvature spectrum P_R(k) (primordial_module.cpp:69)."""
        lnk = torch.log(k / self.k_pivot)
        return self.A_s * torch.exp((self.n_s - 1.0) * lnk + 0.5 * self.alpha_s * lnk**2)


def compute_primordial(params: CosmoParams) -> PrimordialResult:
    return PrimordialResult(A_s=params.A_s, n_s=params.n_s, alpha_s=params.alpha_s,
                            k_pivot=params.k_pivot)

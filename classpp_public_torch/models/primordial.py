"""Primordial spectra: the analytic scalar and tensor power laws with running,
and the isocurvature modes with their correlations (counterpart of
classpp_public_tpu/models/primordial.py `_amp_tilt_run` :28, `iso_pk` :38,
`cross_pk` :44, `scalar_pk` :66, `tensor_pk` :74, `compute_primordial` :97;
primordial_analytic_spectrum_init, primordial_module.cpp:675-890)."""

from __future__ import annotations

import math
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
    iso: dict = None        # {ic: (f_amp, n_index[, alpha_run])} isocurvature modes
    iso_corr: dict = None   # {(ic1, ic2): (c_12, n_12, alpha_12)} their correlations

    def _amp_tilt_run(self, ic):
        """(amplitude, tilt, running) of the auto spectrum of `ic`
        (primordial_module.cpp:675-758): A_s f^2, n, alpha for an
        isocurvature mode."""
        if ic == "ad":
            return self.A_s, self.n_s, self.alpha_s
        ent = self.iso[ic]
        a = ent[2] if len(ent) > 2 else 0.0
        return self.A_s * ent[0] ** 2, ent[1], a

    def iso_pk(self, ic, k: torch.Tensor) -> torch.Tensor:
        """P_ic(k) = A_s f^2 (k/k*)^(n - 1 + alpha/2 ln(k/k*))."""
        amp, n, a = self._amp_tilt_run(ic)
        lnk = torch.log(k / self.k_pivot)
        return amp * torch.exp((n - 1.0) * lnk + 0.5 * a * lnk**2)

    def cross_pk(self, ic1, ic2, k: torch.Tensor):
        """The correlated ic1 x ic2 spectrum (primordial_module.cpp:860-890):
        amplitude sqrt(A1 A2) c_12, tilt (n1 + n2)/2 + n_12, running
        (a1 + a2)/2 + alpha_12; None when the pair is uncorrelated."""
        corr = self.iso_corr or {}
        key = (ic1, ic2) if (ic1, ic2) in corr else (ic2, ic1)
        if key not in corr or corr[key][0] == 0.0:
            return None
        c, n12, a12 = corr[key]
        A1, n1, a1 = self._amp_tilt_run(ic1)
        A2, n2, a2 = self._amp_tilt_run(ic2)
        amp = math.sqrt(A1 * A2) * c
        tilt = 0.5 * (n1 + n2) + n12
        run = 0.5 * (a1 + a2) + a12
        lnk = torch.log(k / self.k_pivot)
        return amp * torch.exp((tilt - 1.0) * lnk + 0.5 * run * lnk**2)

    def scalar_pk(self, k: torch.Tensor) -> torch.Tensor:
        """Dimensionless curvature spectrum P_R(k) (primordial_module.cpp:69)."""
        lnk = torch.log(k / self.k_pivot)
        return self.A_s * torch.exp((self.n_s - 1.0) * lnk + 0.5 * self.alpha_s * lnk**2)

    def tensor_pk(self, k: torch.Tensor) -> torch.Tensor:
        """Primordial tensor spectrum P_h(k) = r A_s (k/k_pivot)^(n_t + alpha_t/2 ln(k/k_pivot))
        (primordial.py:74-79)."""
        lnk = torch.log(k / self.k_pivot)
        return self.r * self.A_s * torch.exp(self.n_t * lnk + 0.5 * self.alpha_t * lnk**2)


def compute_primordial(params: CosmoParams, iso: dict = None,
                       iso_corr: dict = None) -> PrimordialResult:
    return PrimordialResult(A_s=params.A_s, n_s=params.n_s, alpha_s=params.alpha_s,
                            k_pivot=params.k_pivot, r=params.r, n_t=params.n_t,
                            alpha_t=params.alpha_t, iso=iso or None, iso_corr=iso_corr or None)

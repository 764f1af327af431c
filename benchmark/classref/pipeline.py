"""Pipeline orchestrator: the staged, lazily cached computation chain.

Counterpart of classpp_public_tpu/pipeline.py (`OutputSelection`, the
`Cosmology` stages :141-467, the curvature `curvature_K` and `sgnK` :317-326,
the number counts `number_counts` :422-438). Each stage is computed once per
parameter set; downstream stages pull upstream ones on demand. Stage order:
background, thermodynamics, perturbations, primordial, nonlinear, transfer,
spectra, lensing; with nCl/sCl the spectra level also holds number_counts.
Scalar modes and adiabatic initial conditions only; the CMB x number-count
crosses are refused.

Every stage takes an explicit torch.device. The background is computed on
the host and thermodynamics mostly so; both hand their tables over on that
device, and the later stages run there.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional, Sequence

import numpy as np
import torch

from .config.params import CosmoParams, check_lcdm
from .config.precision import PrecisionParams

LEVELS = ["background", "thermodynamics", "perturbations", "primordial",
          "nonlinear", "transfer", "spectra", "lensing"]


@dataclass
class OutputSelection:
    """What to compute (reference 'output=' parsing, input_module.cpp)."""

    tCl: bool = False
    pCl: bool = False
    lCl: bool = False
    mPk: bool = False
    lensing: bool = False
    l_scalar_max: int = 2500
    P_k_max: float = 1.0
    z_pk: tuple = (0.0,)
    z_max_pk: float = 0.0
    non_linear: str = ""   # "" or "halofit"
    # number counts and galaxy lensing (nCl / sCl; pipeline.py:49-72)
    nCl: bool = False
    sCl: bool = False
    selection_mean: tuple = (1.0,)
    selection_width: tuple = (0.1,)
    selection_kind: str = "gaussian"
    l_lss_max: int = 300
    non_diagonal: int = 0
    nc_contributions: tuple = ("density",)
    selection_bias: tuple = (1.0,)
    magnification_bias: tuple = (0.0,)
    dndz: str = None          # None, "analytic" or a file path
    dndz_evo: str = None

    @property
    def has_cls(self) -> bool:
        return self.tCl or self.pCl or self.lCl

    @property
    def has_nc(self) -> bool:
        return self.nCl or self.sCl

    @property
    def has_pk(self) -> bool:
        return self.mPk


def resolve_device(device) -> torch.device:
    """The stage device. "cuda" needs a card; nothing falls back to the CPU."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("device 'cuda' requested but torch.cuda.is_available() is "
                           "False; pass device='cpu' explicitly to run on the CPU")
    return dev


class Cosmology:
    """Lazy pipeline over (CosmoParams, PrecisionParams, OutputSelection)."""

    def __init__(self, params: CosmoParams, precision: Optional[PrecisionParams] = None,
                 output: Optional[OutputSelection] = None, device="cuda"):
        check_lcdm(params)
        self.params = params
        self.pr = precision or PrecisionParams()
        if self.pr.evolver != "imex":
            raise NotImplementedError(
                f"evolver = {self.pr.evolver} is not ported: only the imex evolver is "
                "(classpp_public_tpu/ops/ode.py:44 rkck)")
        self.out = output or OutputSelection()
        if self.out.nCl and self.out.lCl and self.out.has_cls:
            raise NotImplementedError("the CMB x number-count crosses are outside the "
                                      "benchmark reference")
        self.device = resolve_device(device)
        self._cache = {}

    def set_stage(self, name: str, result):
        """Seed a stage with a result computed elsewhere, e.g. another
        Cosmology's. name: "background" ((BackgroundResult, BgIdx)),
        "thermodynamics" or "perturbations"."""
        keys = {"background": "bg", "thermodynamics": "th", "perturbations": "pt"}
        if name not in keys:
            raise ValueError(f"set_stage: {name!r} is not one of {sorted(keys)}")
        self._cache[keys[name]] = result

    @property
    def background(self):
        if "bg" not in self._cache:
            from .models.background import compute_background

            self._cache["bg"] = compute_background(self.params, self.pr, self.device)
        return self._cache["bg"]

    @property
    def thermodynamics(self):
        if "th" not in self._cache:
            from .models.thermodynamics import compute_thermodynamics

            bg, bidx = self.background
            self._cache["th"] = compute_thermodynamics(self.params, self.pr, bg, bidx,
                                                       self.device)
        return self._cache["th"]

    @property
    def l_max_internal(self) -> int:
        # lensing needs unlensed spectra beyond the output l_max
        # (l_scalar_max += delta_l_max, input_module.cpp)
        return self.out.l_scalar_max + (self.pr.delta_l_max if self.out.lensing else 0)

    @property
    def perturbations(self):
        if "pt" not in self._cache:
            from .models.perturbations import compute_perturbations

            bg, bidx = self.background
            k_max_cl_extra = 0.0
            if self.out.has_nc or self.out.lCl:
                # l_lss_max resolved at the comoving distance of the first
                # selection bin, for the number counts and the lensing
                # potential (perturbations_module.cpp:1726-1733,
                # pipeline.py:184-195)
                from .models.background import tau_of_z

                tau1 = float(tau_of_z(bg, float(self.out.selection_mean[0])))
                k_max_cl_extra = self.pr.k_max_tau0_over_l_max * self.out.l_lss_max \
                    / (float(bg.tau0) - tau1)
            # a nonlinear method samples k to P_k_max (its floor
            # nonlinear_min_k_max) with or without mPk, as the reference does
            # (input_module.cpp:2806, perturbations_module.cpp:1739)
            self._cache["pt"] = compute_perturbations(
                self.params, self.pr, bg, bidx, self.thermodynamics,
                l_scalar_max=self.l_max_internal, k_max_for_pk=self.out.P_k_max,
                has_cls=self.out.has_cls, has_pk=self.out.has_pk or bool(self.out.non_linear),
                z_max_pk=self.out.z_max_pk,
                has_lcmb=self.out.lCl and self.out.has_cls,
                k_max_cl_extra=k_max_cl_extra, has_nc=self.out.has_nc, device=self.device)
        return self._cache["pt"]

    @property
    def primordial(self):
        if "pm" not in self._cache:
            from .models.primordial import compute_primordial

            self._cache["pm"] = compute_primordial(self.params)
        return self._cache["pm"]

    @property
    def nonlinear(self):
        if "nl" not in self._cache:
            from .models.nonlinear import compute_nonlinear

            bg, bidx = self.background
            self._cache["nl"] = compute_nonlinear(
                self.perturbations, bg, bidx, self.primordial, self.pr, self.params,
                z_pk=self.out.z_pk)
        return self._cache["nl"]

    @property
    def nl_source_ratio(self) -> torch.Tensor:
        """sqrt(P_nl/P_lin)(tau, k) on the source sampling: the reference's
        nl_corr_density, multiplied into the metric/density transfer sources
        whenever a nonlinear method is on (transfer_module.cpp:542-597).
        Computed on a fixed 24-point z grid (z <= 10; beyond it the ratio is 1)
        and interpolated linearly in tau per k column. (ntau, nk)."""
        if "nlr" not in self._cache:
            from .models.background import tau_of_z
            from .models.nonlinear import compute_nonlinear

            bg, bidx = self.background
            pert = self.perturbations
            z_grid = np.concatenate([[0.0], np.geomspace(0.05, 10.0, 23)])
            nl = compute_nonlinear(pert, bg, bidx, self.primordial, self.pr, self.params,
                                   z_pk=tuple(z_grid))
            ratio = torch.sqrt(nl.pk_nl / torch.clamp(nl.pk_lin, min=1e-300))
            ratio = torch.where(torch.isfinite(ratio) & (ratio > 0), ratio, 1.0)
            tau_z = tau_of_z(bg, torch.as_tensor(z_grid)).to(ratio.device)
            order = torch.argsort(tau_z)
            tau_s, r_s = tau_z[order].contiguous(), ratio[order]     # (nz,), (nz, nk)
            taus = pert.tau
            j = torch.clamp(torch.searchsorted(tau_s, taus) - 1, 0, len(tau_s) - 2)
            f = torch.clamp((taus - tau_s[j]) / (tau_s[j + 1] - tau_s[j]), 0.0, 1.0)
            out = (1.0 - f)[:, None] * r_s[j] + f[:, None] * r_s[j + 1]
            out[taus < tau_s[0]] = 1.0                               # z > 10: linear
            self._cache["nlr"] = out
        return self._cache["nlr"]

    def _pert_for_transfer(self, pert):
        """The scalar-source table entering the CMB transfer integrals: with a
        nonlinear method on, phi+psi (the lensing source) carries the halofit
        correction as the reference's copied sources do
        (transfer_module.cpp:566-588); without one it is the linear table."""
        if not self.out.non_linear:
            return pert
        from .models.perturbations.indices import SrcIdx

        r = self.nl_source_ratio.T                                   # (nk, ntau)
        if r.shape != pert.sources.shape[:2]:
            raise AssertionError(f"nl_source_ratio {tuple(r.shape)} does not match the "
                                 f"source table {tuple(pert.sources.shape[:2])}")
        src = pert.sources.clone()
        src[:, :, SrcIdx.ix["phi_plus_psi"]] *= r
        return pert._replace(sources=src)

    @property
    def transfer(self):
        if "tr" not in self._cache:
            from .models.transfer import compute_transfer

            self._cache["tr"] = compute_transfer(
                self._pert_for_transfer(self.perturbations), self.thermodynamics,
                self.pr, l_max=self.l_max_internal, K=self.curvature_K, sgnK=self.sgnK)
        return self._cache["tr"]

    @property
    def curvature_K(self) -> float:
        """K = -Omega_k H0^2 [Mpc^-2] (reference pba->K)."""
        from .models.perturbations.solve import curvature_of

        return curvature_of(self.params, self.background[0])[0]

    @property
    def sgnK(self) -> int:
        """The sign of K: 0 flat, -1 open, +1 closed."""
        from .models.perturbations.solve import curvature_of

        return curvature_of(self.params, self.background[0])[1]

    @property
    def spectra(self):
        if "sp" not in self._cache:
            from .models.spectra import compute_spectra

            self._cache["sp"] = compute_spectra(
                self.transfer, self.primordial, l_max=self.l_max_internal,
                sgnK=self.sgnK, K=self.curvature_K,
                q_flat_nu=self.pr.hyper_flat_approximation_nu)
        return self._cache["sp"]

    def _nc_kwargs(self) -> dict:
        o = self.out
        return dict(kind=o.selection_kind, l_max=o.l_lss_max, contributions=o.nc_contributions,
                    selection_bias=o.selection_bias, magnification_bias=o.magnification_bias,
                    dndz=o.dndz, dndz_evo=o.dndz_evo)

    @property
    def number_counts(self):
        """nCl / sCl spectra (pipeline.py:422-438): the linear sources, as the
        JAX package feeds them (ROADMAP Queue 3: the C++ code applies
        nl_corr_density)."""
        if "nc" not in self._cache:
            from .models.numbercounts import compute_number_counts

            bg, bidx = self.background
            self._cache["nc"] = compute_number_counts(
                self.perturbations, bg, bidx, self.primordial, self.pr,
                self.out.selection_mean, self.out.selection_width,
                non_diag=self.out.non_diagonal, **self._nc_kwargs())
        return self._cache["nc"]

    @property
    def lensing(self):
        if "le" not in self._cache:
            from .models.lensing import compute_lensing

            self._cache["le"] = compute_lensing(self.spectra, self.pr,
                                                l_lensed_max=self.out.l_scalar_max)
        return self._cache["le"]

    def stages(self, level: str = "lensing"):
        """The stage names `compute(level)` runs, in order."""
        want = LEVELS.index(level)
        out = []
        for lv in LEVELS[: want + 1]:
            if lv == "nonlinear" and not self.out.has_pk:
                continue
            if lv == "spectra" and self.out.has_nc:
                out.append("number_counts")
            if lv in ("transfer", "spectra") and not self.out.has_cls:
                continue
            if lv == "lensing" and not (self.out.lensing and self.out.has_cls):
                continue
            out.append(lv)
        return out

    def compute(self, level: Sequence[str] = ("lensing",)):
        """Pull all stages up to the requested level (classy.pyx compute())."""
        want = max(LEVELS.index(lv) for lv in level)
        for lv in self.stages(LEVELS[want]):
            getattr(self, lv)
        return self

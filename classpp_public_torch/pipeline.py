"""Pipeline orchestrator: the staged, lazily cached computation chain.

Counterpart of classpp_public_tpu/pipeline.py (`OutputSelection`, the
`Cosmology` stages :141-467, the tensor stages :295-313, the curvature
`curvature_K` and `sgnK` :317-326, the isocurvature transfers `transfer_iso`
:391-406 and their spectra :410-420, the number counts `number_counts` and
`nc_cross` :422-458). Each stage is
computed once per parameter set; downstream stages pull upstream ones on
demand. Stage order: background, thermodynamics, perturbations, primordial,
nonlinear, transfer, transfer_iso (with isocurvature modes),
tensor_perturbations, tensor_transfer (with tensor modes), spectra, lensing;
with nCl/sCl the spectra level also holds number_counts and, with nCl and lCl
among C_l outputs, nc_cross (pipeline.py:601-603).

Every stage takes an explicit torch.device. The background is computed on
the host and thermodynamics mostly so (its two serial recurrences are kernels
on a CUDA device; see the module docstrings); both hand their tables over on
that device, and the later stages run there.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional, Sequence

import numpy as np
import torch

from .config.params import CosmoParams, check_lcdm
from .config.precision import PrecisionParams

LEVELS = ["background", "thermodynamics", "perturbations", "primordial",
          "nonlinear", "transfer", "tensor_perturbations", "tensor_transfer",
          "spectra", "lensing"]


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
    non_linear: str = ""   # "", "halofit" or "hmcode"
    hm_eta0: float = 0.603  # HMcode feedback (default emu_dmonly, input_module.cpp:3411)
    hm_cmin: float = 3.13
    modes: tuple = ("s",)  # "s" scalars, "t" tensors
    l_tensor_max: int = 500
    ics: tuple = ("ad",)   # initial conditions: "ad" and any of bi, cdi, nid, niv
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


def check_ics(ics, Omega_k: float) -> None:
    """The port's two refusals of the isocurvature initial conditions, where
    the JAX package computes something else than it means to: an ic list
    without "ad" (its perturbations always solve "ad", solve.py:739, and its
    C_l add the others only when len(ics) > 1, pipeline.py:414, so the C_l
    would be adiabatic and P(k) not), and isocurvature modes in a curved
    universe (`isocurvature_ic` is the flat case, equations.py:1216-1219, and
    `transfer_iso` runs flat Bessels on a grid not the adiabatic one,
    pipeline.py:391-406)."""
    if "ad" not in ics:
        raise NotImplementedError(
            f"ic = {', '.join(ics)} without 'ad' is not ported: the JAX package solves the "
            "adiabatic mode regardless (classpp_public_tpu/models/perturbations/solve.py:739, "
            "classpp_public_tpu/pipeline.py:414)")
    if len(ics) > 1 and Omega_k != 0.0:
        raise NotImplementedError(
            "isocurvature initial conditions with Omega_k != 0 are not ported: the JAX package "
            "takes the flat case (classpp_public_tpu/models/perturbations/equations.py:1216) "
            "and flat Bessels (classpp_public_tpu/pipeline.py:391-406)")


class Cosmology:
    """Lazy pipeline over (CosmoParams, PrecisionParams, OutputSelection).
    iso_primordial ({ic: (f, n, alpha)}) and iso_corr ({(ic1, ic2): (c, n,
    alpha)}) are the isocurvature amplitudes and correlations the primordial
    stage reads (JAX classy.py:855-856)."""

    def __init__(self, params: CosmoParams, precision: Optional[PrecisionParams] = None,
                 output: Optional[OutputSelection] = None, device="cuda",
                 iso_primordial: Optional[dict] = None, iso_corr: Optional[dict] = None):
        check_lcdm(params)
        self.params = params
        self.pr = precision or PrecisionParams()
        if self.pr.evolver != "imex":
            raise NotImplementedError(
                f"evolver = {self.pr.evolver} is not ported: only the imex evolver is "
                "(classpp_public_tpu/ops/ode.py:44 rkck)")
        self.out = output or OutputSelection()
        check_ics(self.out.ics, params.Omega_k)
        if "t" in self.out.modes:
            from .models.perturbations.tensors import check_tensor_method

            check_tensor_method(params)
        self.device = resolve_device(device)
        self.iso_primordial = iso_primordial or None
        self.iso_corr = iso_corr or None
        self._cache = {}

    def set_stage(self, name: str, result):
        """Seed a stage with a result computed elsewhere, e.g. the JAX
        package's, moved across with classpp_public_torch.interop, or another
        Cosmology's. name: "background" ((BackgroundResult, BgIdx)),
        "thermodynamics", "perturbations" or "tensor_perturbations"."""
        keys = {"background": "bg", "thermodynamics": "th", "perturbations": "pt",
                "tensor_perturbations": "tpt"}
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
                k_max_cl_extra=k_max_cl_extra, has_nc=self.out.has_nc, ics=self.out.ics,
                device=self.device)
        return self._cache["pt"]

    @property
    def primordial(self):
        if "pm" not in self._cache:
            from .models.primordial import compute_primordial

            self._cache["pm"] = compute_primordial(self.params, iso=self.iso_primordial,
                                                   iso_corr=self.iso_corr)
        return self._cache["pm"]

    @property
    def nonlinear(self):
        if "nl" not in self._cache:
            from .models.nonlinear import compute_nonlinear

            bg, bidx = self.background
            self._cache["nl"] = compute_nonlinear(
                self.perturbations, bg, bidx, self.primordial, self.pr, self.params,
                z_pk=self.out.z_pk, method=self.out.non_linear or "halofit",
                hm_eta0=self.out.hm_eta0, hm_cmin=self.out.hm_cmin)
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
                                   z_pk=tuple(z_grid), method=self.out.non_linear or "halofit",
                                   hm_eta0=self.out.hm_eta0, hm_cmin=self.out.hm_cmin)
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
        or HMcode correction as the reference's copied sources do
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
    def transfer_iso(self) -> dict:
        """{ic: TransferResult} of each isocurvature mode (pipeline.py:391-406):
        one transfer_los launch per mode, each table through
        `_pert_for_transfer` with the one IC-summed nonlinear ratio (the
        reference corrects every (ic, type) with one nl_corr_density table,
        transfer_module.cpp:556-588)."""
        if "tr_iso" not in self._cache:
            from .models.transfer import compute_transfer

            pert = self.perturbations
            self._cache["tr_iso"] = {
                ic: compute_transfer(self._pert_for_transfer(pert._replace(sources=src)),
                                     self.thermodynamics, self.pr, l_max=self.l_max_internal,
                                     K=self.curvature_K, sgnK=self.sgnK)
                for ic, src in (pert.sources_iso or {}).items()}
        return self._cache["tr_iso"]

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
    def tensor_perturbations(self):
        if "tpt" not in self._cache:
            from .models.perturbations.tensors import compute_tensor_perturbations

            bg, bidx = self.background
            self._cache["tpt"] = compute_tensor_perturbations(
                self.params, self.pr, bg, bidx, self.thermodynamics,
                l_tensor_max=self.out.l_tensor_max, device=self.device)
        return self._cache["tpt"]

    @property
    def tensor_transfer(self):
        if "ttr" not in self._cache:
            from .models.transfer import compute_transfer_tensor

            self._cache["ttr"] = compute_transfer_tensor(
                self.tensor_perturbations, self.thermodynamics, self.pr,
                l_max=self.out.l_tensor_max, K=self.curvature_K, sgnK=self.sgnK)
        return self._cache["ttr"]

    @property
    def spectra(self):
        if "sp" not in self._cache:
            from .models.spectra import compute_spectra

            tr_tensor = self.tensor_transfer if "t" in self.out.modes else None
            tr_iso = self.transfer_iso if len(self.out.ics) > 1 else None
            self._cache["sp"] = compute_spectra(
                self.transfer, self.primordial, l_max=self.l_max_internal, tr_tensor=tr_tensor,
                sgnK=self.sgnK, K=self.curvature_K,
                q_flat_nu=self.pr.hyper_flat_approximation_nu, tr_iso=tr_iso)
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
    def nc_cross(self):
        """CMB x number-count cross spectra (pipeline.py:440-458): phi-dens,
        and the T-dens / T-lens extensions."""
        if "ncx" not in self._cache:
            from .models.numbercounts import compute_cmb_nc_cross

            bg, bidx = self.background
            self._cache["ncx"] = compute_cmb_nc_cross(
                self.perturbations, self.thermodynamics, bg, bidx, self.primordial, self.pr,
                self.out.selection_mean, self.out.selection_width,
                want_td=self.out.tCl, want_tl=self.out.tCl and self.out.sCl,
                **self._nc_kwargs())
        return self._cache["ncx"]

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
                if self.out.nCl and self.out.lCl and self.out.has_cls:
                    out.append("nc_cross")
            if lv in ("transfer", "spectra") and not self.out.has_cls:
                continue
            if lv in ("tensor_perturbations", "tensor_transfer") \
                    and not (self.out.has_cls and "t" in self.out.modes):
                continue
            if lv == "lensing" and not (self.out.lensing and self.out.has_cls):
                continue
            out.append(lv)
            if lv == "transfer" and len(self.out.ics) > 1:
                out.append("transfer_iso")
        return out

    def compute(self, level: Sequence[str] = ("lensing",)):
        """Pull all stages up to the requested level (classy.pyx compute())."""
        want = max(LEVELS.index(lv) for lv in level)
        for lv in self.stages(LEVELS[want]):
            getattr(self, lv)
        return self

"""classy-compatible entry point (counterpart of classpp_public_tpu/classy.py:
`Class.set` :76, `compute` :976, `raw_cl` :1007, `lensed_cl` :1086,
`pk_lin` :1221), for the inputs of the flat-LambdaCDM slice.

Every other input key raises with the JAX file and line that implements it.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional

import numpy as np

from .config.params import CosmoParams
from .config.precision import PrecisionParams
from .pipeline import Cosmology, OutputSelection, resolve_device


class CosmoSevereError(Exception):
    pass


def _parse_bool(v) -> bool:
    if isinstance(v, str):
        return v.strip().lower() in ("yes", "y", "true", "1", "on")
    return bool(v)


def _parse_list(v):
    if isinstance(v, str):
        return [float(x) for x in v.replace(",", " ").split()]
    if isinstance(v, (list, tuple, np.ndarray)):
        return [float(x) for x in v]
    return [float(v)]


_FLOAT_KEYS = ("n_s", "alpha_s", "k_pivot", "T_cmb", "N_ur", "tau_reio", "z_reio",
               "reionization_width", "reionization_exponent",
               "helium_fullreio_redshift", "helium_fullreio_width")
_OUTPUT_TOKENS = ("tCl", "pCl", "lCl", "mPk")


class Class:
    """The classy entry point. `device` is where the stages run ("cuda" by
    default; a run without a card must pass device="cpu")."""

    def __init__(self, device="cuda"):
        self.device = resolve_device(device)
        self._pars: Dict = {}
        self._cosmo: Optional[Cosmology] = None
        self.parameters_changed = True

    def set(self, *args, **kwargs):
        if args and isinstance(args[0], dict):
            self._pars.update(args[0])
        self._pars.update(kwargs)
        self.parameters_changed = True
        return True

    def _build(self) -> Cosmology:
        p = dict(self._pars)
        kw = {}
        h = float(p.pop("h")) if "h" in p else (
            float(p.pop("H0")) / 100.0 if "H0" in p else 0.67556)
        kw["h"] = h
        if "omega_b" in p:
            kw["omega_b"] = float(p.pop("omega_b"))
        elif "Omega_b" in p:
            kw["omega_b"] = float(p.pop("Omega_b")) * h * h
        if "omega_cdm" in p:
            kw["omega_cdm"] = float(p.pop("omega_cdm"))
        elif "Omega_cdm" in p:
            kw["omega_cdm"] = float(p.pop("Omega_cdm")) * h * h
        if "ln10^{10}A_s" in p:
            kw["A_s"] = float(np.exp(float(p.pop("ln10^{10}A_s")))) * 1e-10
        if "A_s" in p:
            kw["A_s"] = float(p.pop("A_s"))
        for name in _FLOAT_KEYS:
            if name in p:
                kw[name] = float(p.pop(name))
        if "YHe" in p:
            v = p.pop("YHe")
            kw["YHe"] = None if isinstance(v, str) and v.strip().upper() == "BBN" else float(v)
        if "tau_reio" in kw and "z_reio" not in kw:
            kw["z_reio"] = None

        out = OutputSelection()
        output = str(p.pop("output", ""))
        extra = [t for t in output.replace(",", " ").split() if t not in _OUTPUT_TOKENS]
        if extra:
            raise NotImplementedError(
                f"output {extra} not ported (classpp_public_tpu/classy.py:451-468)")
        out.tCl, out.pCl = "tCl" in output, "pCl" in output
        out.lCl, out.mPk = "lCl" in output, "mPk" in output
        lensing_explicit = "lensing" in p
        out.lensing = _parse_bool(p.pop("lensing", "yes" if out.lCl else "no"))
        if lensing_explicit and out.lensing and not ((out.tCl or out.pCl) and out.lCl):
            raise CosmoSevereError(
                "you asked for lensed CMB Cls, but this requires 'output' to include "
                "'tCl' and/or 'pCl', and 'lCl' (input_module.cpp:2427-2436)")
        out.l_scalar_max = int(float(p.pop("l_max_scalars", 2500)))
        if "P_k_max_1/Mpc" in p:
            out.P_k_max = float(p.pop("P_k_max_1/Mpc"))
        if "P_k_max_h/Mpc" in p:
            out.P_k_max = float(p.pop("P_k_max_h/Mpc")) * h
        if "z_pk" in p:
            out.z_pk = tuple(_parse_list(p.pop("z_pk")))
        if "z_max_pk" in p:
            out.z_max_pk = float(p.pop("z_max_pk"))
        out.z_max_pk = max(out.z_max_pk, max(out.z_pk))
        if "non linear" in p or "non_linear" in p:
            raise NotImplementedError(
                "non linear (halofit/hmcode) is not ported "
                "(classpp_public_tpu/models/nonlinear.py:490, classy.py:535-564)")

        pr_fields = {f.name: f for f in dataclasses.fields(PrecisionParams)}
        prkw = {}
        for key in list(p):
            if key in pr_fields:
                cur = getattr(PrecisionParams(), key)
                val = p.pop(key)
                prkw[key] = _parse_bool(val) if isinstance(cur, bool) else type(cur)(val)
            elif key.endswith("_verbose"):
                p.pop(key)
        if p:
            raise NotImplementedError(
                "input parameter(s) not ported: " + ", ".join(repr(k) for k in sorted(p))
                + " (classpp_public_tpu/classy.py:93-860 parses them)")
        return Cosmology(CosmoParams(**kw), PrecisionParams(**prkw), out, device=self.device)

    def compute(self, level=("lensing",)):
        if isinstance(level, str):
            level = [level]
        if self.parameters_changed or self._cosmo is None:
            self._cosmo = self._build()
            self.parameters_changed = False
        lv = list(level)
        if not self._cosmo.out.lensing:
            lv = ["spectra" if x == "lensing" else x for x in lv]
        if not self._cosmo.out.has_cls:
            lv = ["primordial" if x in ("lensing", "spectra", "transfer") else x for x in lv]
        if not (self._cosmo.out.has_cls or self._cosmo.out.has_pk):
            lv = ["thermodynamics"]
        self._cosmo.compute(lv)

    @property
    def cosmo(self) -> Cosmology:
        if self._cosmo is None or self.parameters_changed:
            self._cosmo = self._build()
            self.parameters_changed = False
        return self._cosmo

    def _cl_dict(self, ell, cl, lmax):
        from .models.spectra import CT_TYPES

        ell = ell.cpu().numpy()
        cl = cl.cpu().numpy()
        n = lmax + 1
        out = {"ell": np.arange(n)}
        m = ell <= lmax
        for i, name in enumerate(CT_TYPES):
            arr = np.zeros(n)
            arr[ell[m]] = cl[m, i]
            out[name] = arr
        return out

    def raw_cl(self, lmax=-1):
        """Unlensed C_l dict (classy.pyx raw_cl)."""
        if not self.cosmo.out.has_cls:
            raise CosmoSevereError("No Cls computed")
        sp = self.cosmo.spectra
        return self._cl_dict(sp.ell, sp.cl, self.cosmo.out.l_scalar_max if lmax < 0 else lmax)

    def lensed_cl(self, lmax=-1):
        if not self.cosmo.out.has_cls:
            raise CosmoSevereError("No Cls computed")
        if not self.cosmo.out.lensing:
            raise CosmoSevereError(
                "Lensing Cls not computed, add 'lensing':'yes' to your input.")
        le = self.cosmo.lensing
        return self._cl_dict(le.ell, le.cl, self.cosmo.out.l_scalar_max if lmax < 0 else lmax)

    def pk_lin(self, k, z):
        """Linear P_m(k, z) in Mpc^3 (classy.pyx pk_lin)."""
        from .models.nonlinear import pk_linear_at_z

        if not self.cosmo.out.has_pk:
            raise CosmoSevereError("no mPk in output: P(k) was not computed")
        bg, _ = self.cosmo.background
        pert = self.cosmo.perturbations
        pk = pk_linear_at_z(pert, bg, self.cosmo.primordial, float(z)).cpu().numpy()
        return float(np.exp(np.interp(np.log(k), np.log(pert.k_np), np.log(pk))))

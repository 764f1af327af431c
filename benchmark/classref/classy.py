"""classy-compatible entry point (counterpart of classpp_public_tpu/classy.py:
`Class.set` :76, `_m_ncdm_from_omega` :863, `compute` :976, `raw_cl` :1007,
`lensed_cl` :1086, `pk_lin` :1221, `pk` :1257, `pk_cb` :1275, `sigma8` :1319),
for the inputs of what the benchmark's cells run: the LambdaCDM slice with
Fermi-Dirac massive neutrinos, halofit, the RECFAST thermodynamics variants
(`annihilation`, `decay` and their modifiers, `on the spot`,
`reio_parametrization` with its node lists: classy.py:139-150, :173-206),
and the number counts and galaxy lensing (`output` nCl / dCl / sCl with the
selection, contribution, bias and dN/dz keys: classy.py:455-510; `raw_cl`'s
number-count keys :1008-1075, `density_cl` :1077), with the primordial
spectra `P_k_ini type` analytic_Pk and two_scales (:720-737).

Every other input key raises.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional

import numpy as np

from . import constants as const
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


_FLOAT_KEYS = ("n_s", "alpha_s", "k_pivot", "T_cmb", "N_ur", "Omega_k", "tau_reio", "z_reio", "r",
               "reionization_width", "reionization_exponent",
               "helium_fullreio_redshift", "helium_fullreio_width",
               "annihilation", "decay", "annihilation_variation", "annihilation_z",
               "annihilation_zmax", "annihilation_zmin", "annihilation_f_halo",
               "annihilation_z_halo", "binned_reio_step_sharpness", "many_tanh_width")
_REIO_SCHEMES = ("reio_camb", "reio_half_tanh", "reio_bins_tanh", "reio_many_tanh", "reio_inter",
                 "reio_none")
_OUTPUT_TOKENS = ("tCl", "pCl", "lCl", "mPk", "nCl", "dCl", "sCl")
_NC_CONTRIBUTIONS = ("density", "rsd", "lensing", "gr")


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
        if not -0.95 < kw.get("Omega_k", 0.0) < 0.95:
            raise CosmoSevereError(f"Omega_k = {kw['Omega_k']} outside (-0.95, 0.95) "
                                   "(classpp_public_tpu/classy.py:928)")
        # gauge (classy.py:166-172) and recombination code: the stages raise
        # for what is not ported
        if "gauge" in p:
            g = str(p.pop("gauge")).strip().lower()
            g = "newtonian" if g in ("new", "newt") else g
            if g not in ("synchronous", "newtonian"):
                raise CosmoSevereError(f"unknown gauge {g!r}")
            kw["gauge"] = g
        for key in ("Nbody gauge transfer functions", "nbody gauge transfer functions",
                    "Nbody_gauge_transfer_functions"):
            if key in p:
                raise NotImplementedError(
                    f"{key!r} is not ported: the N-body gauge shifts need the dTk/vTk "
                    "outputs (classpp_public_tpu/classy.py:462, "
                    "classpp_public_tpu/models/perturbations/equations.py:1580)")
        if "recombination" in p:
            kw["recombination"] = str(p.pop("recombination")).strip().lower()
        self._parse_thermo(p, kw)
        if "YHe" in p:
            v = p.pop("YHe")
            kw["YHe"] = None if isinstance(v, str) and v.strip().upper() == "BBN" else float(v)
        if "tau_reio" in kw and "z_reio" not in kw:
            kw["z_reio"] = None

        # ncdm (classy.py:208-266)
        n_ncdm = int(p.pop("N_ncdm", 0) or 0)
        if n_ncdm > 0:
            if "T_ncdm" in p:
                kw["T_ncdm"] = tuple(_parse_list(p.pop("T_ncdm")))
            if "deg_ncdm" in p:
                kw["deg_ncdm"] = tuple(_parse_list(p.pop("deg_ncdm")))
            if "m_ncdm" in p or not any(x in p for x in ("Omega_ncdm", "omega_ncdm")):
                kw["m_ncdm"] = tuple(_parse_list(p.pop("m_ncdm", "0.06")))
            else:
                # Omega_ncdm / omega_ncdm given: invert the momentum integral
                # for the mass per species
                om = _parse_list(p.pop("Omega_ncdm", "")) or \
                    [v / (h * h) for v in _parse_list(p.pop("omega_ncdm", ""))]
                p.pop("omega_ncdm", None)
                tol_M = float(p.get("tol_M_ncdm", 1.0e-7))
                kw["m_ncdm"] = tuple(self._m_ncdm_from_omega(dict(kw), i, float(om[i]), h,
                                                             tol_M=tol_M)
                                     for i in range(len(om)))
            if len(kw["m_ncdm"]) != n_ncdm:
                raise CosmoSevereError(
                    f"N_ncdm = {n_ncdm} but {len(kw['m_ncdm'])} masses were given")


        out = OutputSelection()
        output = str(p.pop("output", ""))
        extra = [t for t in output.replace(",", " ").split() if t not in _OUTPUT_TOKENS]
        if extra:
            raise NotImplementedError(
                f"output {extra} not ported (classpp_public_tpu/classy.py:451-468)")
        out.tCl, out.pCl = "tCl" in output, "pCl" in output
        out.lCl, out.mPk = "lCl" in output, "mPk" in output
        out.nCl = "nCl" in output or "dCl" in output
        out.sCl = "sCl" in output
        if out.has_nc:
            self._parse_nc(p, out)
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
        nl_explicit = "non linear" in p or "non_linear" in p
        out.non_linear = str(p.pop("non linear", p.pop("non_linear", ""))).strip().lower()
        if nl_explicit and output.strip() in ("", "none"):
            raise CosmoSevereError("Class did not read input parameter(s): non linear")
        if out.non_linear not in ("", "halofit"):
            raise NotImplementedError(f"non linear = {out.non_linear}: the reference holds "
                                      "halofit alone")
        self._parse_pk_ini(p, kw)

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
        pr = PrecisionParams(**prkw)
        # the synchronous gauge is the rest frame of cdm: without cdm a
        # negligible floor keeps it defined (classy.py:838-846,
        # input_module.cpp:872)
        if kw.get("gauge", "synchronous") == "synchronous" and kw.get("omega_cdm", 0.12038) == 0.0:
            kw["omega_cdm"] = pr.Omega0_cdm_min_synchronous * h * h
        if out.non_linear:
            # the sigma(R) integrals need k beyond the requested P(k) range
            # (input_module.cpp:2806-2811): nonlinear_min_k_max and halofit's
            # own floor
            out.P_k_max = max(out.P_k_max, pr.nonlinear_min_k_max, pr.halofit_min_k_max)
        return Cosmology(CosmoParams(**kw), pr, out, device=self.device)

    @staticmethod
    def _parse_thermo(p: dict, kw: dict) -> None:
        """Energy injection's 'on the spot', the reionization scheme and the
        node lists of the binned, many-tanh and interpolated schemes, with
        the reference's guards (classy.py:139-150, :173-206,
        input_module.cpp:1436, :1469-1487)."""
        if "on the spot" in p or "on_the_spot" in p:
            v = str(p.pop("on the spot", p.pop("on_the_spot", "yes"))).strip().lower()
            p.pop("on_the_spot", None)
            kw["on_the_spot"] = v not in ("no", "n", "false", "0")
        if "reio_parametrization" in p:
            reio = str(p.pop("reio_parametrization")).strip().lower()
            if reio not in _REIO_SCHEMES:
                raise CosmoSevereError(f"reio_parametrization {reio!r} unknown "
                                       "(input_module.cpp:1436)")
            kw["reio_parametrization"] = reio
        # the *_num counts are implied by the list lengths, accepted and
        # cross-checked
        for base in ("binned_reio", "many_tanh", "reio_inter"):
            zkey, xkey, nkey = f"{base}_z", f"{base}_xe", f"{base}_num"
            if zkey in p or xkey in p:
                zs = tuple(_parse_list(p.pop(zkey)))
                xs = tuple(_parse_list(p.pop(xkey)))
                if nkey in p and int(p.pop(nkey)) != len(zs):
                    raise CosmoSevereError(f"{nkey} inconsistent with {zkey} length")
                if len(zs) != len(xs):
                    raise CosmoSevereError(f"{zkey} and {xkey} must have equal length")
                kw[zkey], kw[xkey] = zs, xs
            else:
                p.pop(nkey, None)

    @staticmethod
    def _parse_nc(p: dict, out: OutputSelection) -> None:
        """The selection windows, number-count contributions, biases and
        dN/dz of the nCl / sCl spectra, with the JAX classy's refusals
        (classy.py:469-510, input_module.cpp:1678-1699)."""
        kind = str(p.pop("selection", "gaussian")).strip().lower()
        if kind not in ("gaussian", "tophat", "dirac"):
            raise CosmoSevereError(f"unknown selection {kind!r}")
        out.selection_kind = kind
        out.selection_mean = tuple(_parse_list(p.pop("selection_mean", "1.0")))
        w = _parse_list(p.pop("selection_width", "0.1"))
        if len(w) == 1:
            w = w * len(out.selection_mean)
        out.selection_width = tuple(w)
        out.l_lss_max = int(float(p.pop("l_max_lss", 300)))
        out.non_diagonal = int(float(p.pop("non_diagonal", 0)))
        contrib = str(p.pop("number count contributions",
                            p.pop("number_count_contributions", "density")))
        p.pop("number_count_contributions", None)
        got = [name for name in _NC_CONTRIBUTIONS if name in contrib]
        extras = [c.strip() for c in contrib.replace(",", " ").split()
                  if c.strip() and c.strip() not in ("density", "dens", "rsd", "lensing", "gr")]
        if extras or not got:
            raise CosmoSevereError(f"unknown number count contributions {extras} "
                                   "(supported: density, rsd, lensing, gr)")
        out.nc_contributions = tuple(got)
        if "selection_bias" in p:
            out.selection_bias = tuple(_parse_list(p.pop("selection_bias")))
        if "selection_magnification_bias" in p:
            out.magnification_bias = tuple(_parse_list(p.pop("selection_magnification_bias")))
        for key, field in (("dNdz_selection", "dndz"), ("dNdz_evolution", "dndz_evo")):
            if key in p:
                v = str(p.pop(key)).strip()
                setattr(out, field, "analytic" if v.lower() == "analytic" else v)

    @staticmethod
    def _parse_pk_ini(p: dict, kw: dict) -> None:
        """`P_k_ini type`: analytic_Pk, or two_scales, whose two amplitudes
        set n_s and A_s (classy.py:720-737, input_module.cpp:1847-1905,
        adiabatic branch; its isocurvature keys are refused as in the JAX
        classy). The JAX classy reads k_pivot after popping it, so takes A_s
        at 0.05/Mpc whatever k_pivot says; a k_pivot other than 0.05 is
        refused (ROADMAP Queue 3)."""
        pk_ini = str(p.pop("P_k_ini type", p.pop("Pk_ini_type", "analytic_Pk"))).strip()
        if pk_ini == "two_scales":
            k1, k2 = float(p.pop("k1")), float(p.pop("k2"))
            if k1 <= 0.0 or k2 <= 0.0:
                raise CosmoSevereError("two_scales requires k1, k2 > 0")
            if any(key in p for key in ("P_{II}^1", "P_{II}^2", "P_{RI}^1", "|P_{RI}^2|",
                                        "special_iso")):
                raise CosmoSevereError(
                    "two_scales isocurvature amplitudes not implemented "
                    "(correlated isocurvature; input_module.cpp:1869)")
            prr1, prr2 = float(p.pop("P_{RR}^1")), float(p.pop("P_{RR}^2"))
            if prr1 <= 0.0 or prr2 <= 0.0:
                raise CosmoSevereError("two_scales requires P_{RR}^{1,2} > 0")
            if kw.get("k_pivot", 0.05) != 0.05:
                raise NotImplementedError(
                    "P_k_ini type two_scales with k_pivot != 0.05 is not ported: the JAX "
                    "classy takes A_s at 0.05/Mpc whatever k_pivot "
                    "(classpp_public_tpu/classy.py:735)")
            n_s = np.log(prr2 / prr1) / np.log(k2 / k1) + 1.0
            kw["n_s"] = float(n_s)
            kw["A_s"] = float(prr1 * np.exp((n_s - 1.0) * np.log(0.05 / k1)))
        elif pk_ini in ("external_Pk", "inflation_V", "inflation_H", "inflation_V_end"):
            raise NotImplementedError(
                f"P_k_ini type {pk_ini!r} is not ported (classpp_public_tpu/classy.py:677-719, "
                "classpp_public_tpu/models/inflation.py)")
        elif pk_ini != "analytic_Pk":
            raise CosmoSevereError(
                f"P_k_ini type {pk_ini!r} not implemented (analytic_Pk, external_Pk, "
                "inflation_V, inflation_H, inflation_V_end, two_scales)")

    @staticmethod
    def _m_ncdm_from_omega(kw: dict, i: int, omega_target: float, h: float,
                           tol_M: float = 1.0e-7) -> float:
        """Invert Omega_ncdm_i -> m_ncdm_i [eV] by bisection on the momentum
        integral (background_ncdm_M_from_Omega,
        tools/non_cold_dark_matter.cpp:893): each iteration is one 128-node
        quadrature."""
        from .models.background import _RHO_INTEGRAL_0, ncdm_psd_weights

        T_cmb = float(kw.get("T_cmb", 2.7255))
        T_list, deg_list = kw.get("T_ncdm", ()), kw.get("deg_ncdm", ())
        T_ratio = T_list[i] if i < len(T_list) else 0.71611
        deg = deg_list[i] if i < len(deg_list) else 1.0
        qn, wn, _ = ncdm_psd_weights(CosmoParams(m_ncdm=(0.0,) * (i + 1)), 128, gauss=False)
        w_i = wn[i]
        H0 = h / 2997.92458
        Omega_g = const.rho_gamma_class_units(T_cmb) / H0**2
        T0_eV = const.k_B * T_cmb * T_ratio / const.eV_SI

        def omega_of_m(m):
            x = m / T0_eV
            i_rho = np.sum(qn**2 * np.sqrt(qn**2 + x**2) * w_i) / _RHO_INTEGRAL_0
            return deg * (7.0 / 8.0) * T_ratio**4 * Omega_g * i_rho

        lo, hi = 0.0, 1.0
        while omega_of_m(hi) < omega_target and hi < 1.0e6:
            hi *= 10.0
        if omega_of_m(hi) < omega_target:
            raise CosmoSevereError(f"cannot match Omega_ncdm={omega_target} with any mass")
        for _ in range(200):
            mid = 0.5 * (lo + hi)
            if omega_of_m(mid) < omega_target:
                lo = mid
            else:
                hi = mid
            if mid > 0.0 and (hi - lo) / mid < tol_M:
                break
        return 0.5 * (lo + hi)

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
            lv = ["nonlinear" if x in ("lensing", "spectra", "transfer") else x for x in lv]
        if not (self._cosmo.out.has_cls or self._cosmo.out.has_pk or self._cosmo.out.has_nc):
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
        """Unlensed C_l dict (classy.pyx raw_cl; classy.py:1007-1075): the CMB
        types, and with nCl / sCl "dens[i]-dens[j]", "lens[i]-lens[j]",
        "dens[i]-lens[j]" (|i - j| <= non_diagonal)."""
        o = self.cosmo.out
        if not (o.has_cls or o.has_nc):
            raise CosmoSevereError("No Cls computed")
        if lmax < 0:
            lmax = o.l_scalar_max if o.has_cls else o.l_lss_max
        n = lmax + 1
        if o.has_cls:
            sp = self.cosmo.spectra
            out = self._cl_dict(sp.ell, sp.cl, lmax)
        else:
            out = {"ell": np.arange(n)}
        if not o.has_nc:
            return out

        def put(name, ell, row):
            ell, row = ell.cpu().numpy(), row.cpu().numpy()
            m = ell <= lmax
            arr = np.zeros(n)
            arr[ell[m]] = row[m]
            out[name] = arr

        nc = self.cosmo.number_counts
        if o.nCl:
            for p, (i, j) in enumerate(nc.dd_pairs):
                put(f"dens[{i + 1}]-dens[{j + 1}]", nc.ell, nc.dd[p])
        if o.sCl:
            for p, (i, j) in enumerate(nc.dd_pairs):
                put(f"lens[{i + 1}]-lens[{j + 1}]", nc.ell, nc.ll[p])
        if o.nCl and o.sCl:
            for p, (i, j) in enumerate(nc.dl_pairs):
                if abs(i - j) <= o.non_diagonal:
                    put(f"dens[{i + 1}]-lens[{j + 1}]", nc.ell, nc.dl[p])
        return out

    def density_cl(self, lmax=-1):
        """Number-count spectra: 'ell', and 'dd', 'll', 'dl' stacked over the
        bin pairs (classy.py:1077)."""
        nc = self.cosmo.number_counts
        ell = nc.ell.cpu().numpy()
        if lmax < 0:
            lmax = int(ell[-1])
        m = ell <= lmax
        return {"ell": ell[m], "dd": nc.dd.cpu().numpy()[:, m], "ll": nc.ll.cpu().numpy()[:, m],
                "dl": nc.dl.cpu().numpy()[:, m]}

    def lensed_cl(self, lmax=-1):
        if not self.cosmo.out.has_cls:
            raise CosmoSevereError("No Cls computed")
        if not self.cosmo.out.lensing:
            raise CosmoSevereError(
                "Lensing Cls not computed, add 'lensing':'yes' to your input.")
        le = self.cosmo.lensing
        return self._cl_dict(le.ell, le.cl, self.cosmo.out.l_scalar_max if lmax < 0 else lmax)

    def _require_mpk(self):
        if not self.cosmo.out.has_pk:
            raise CosmoSevereError("no mPk in output: P(k) was not computed")

    def _pk_lin_col(self, k, z, col):
        from .models.nonlinear import pk_linear_at_z

        self._require_mpk()
        bg, _ = self.cosmo.background
        pert = self.cosmo.perturbations
        pk = pk_linear_at_z(pert, bg, self.cosmo.primordial, float(z), col).cpu().numpy()
        return float(np.exp(np.interp(np.log(k), np.log(pert.k_np), np.log(pk))))

    def pk_lin(self, k, z):
        """Linear P_m(k, z) in Mpc^3 (classy.pyx pk_lin)."""
        return self._pk_lin_col(k, z, "delta_m")

    def _pk_nl_row(self, z, pk_table):
        """ln P_nl(k) row at redshift z: ln P interpolated linearly in
        ln(1+z) between the two adjacent tabulated z_pk rows; raises outside
        the tabulated range (classy.py:1232)."""
        zs = self.cosmo.nonlinear.z.cpu().numpy()
        order = np.argsort(zs)
        zs_s = zs[order]
        lnp = np.log(pk_table.cpu().numpy())[order]
        if z < zs_s[0] - 1e-10 or z > zs_s[-1] + 1e-10:
            if abs(z - zs_s[0]) < 1e-8:
                return lnp[0]
            if abs(z - zs_s[-1]) < 1e-8:
                return lnp[-1]
            raise CosmoSevereError(
                f"z={z} outside computed nonlinear z_pk range [{zs_s[0]}, {zs_s[-1]}]")
        if len(zs_s) == 1:
            return lnp[0]
        x = np.log1p(zs_s)
        j = int(np.clip(np.searchsorted(x, np.log1p(z)) - 1, 0, len(x) - 2))
        w = (np.log1p(z) - x[j]) / (x[j + 1] - x[j])
        return (1.0 - w) * lnp[j] + w * lnp[j + 1]

    def _pk_nl(self, k, z, pk_table):
        lnk = np.log(self.cosmo.perturbations.k_np)
        return float(np.exp(np.interp(np.log(k), lnk, self._pk_nl_row(z, pk_table))))

    def pk(self, k, z):
        """P_m(k, z): halofit or HMcode if 'non linear' was requested, else linear."""
        self._require_mpk()
        if self.cosmo.out.non_linear:
            return self._pk_nl(k, z, self.cosmo.nonlinear.pk_nl)
        return self.pk_lin(k, z)

    def _require_pk_cb(self):
        if self.cosmo.params.N_ncdm == 0:
            raise CosmoSevereError("P_cb not computed (probably because there are no massive "
                                   "neutrinos) so you cannot ask for it")

    def pk_cb_lin(self, k, z):
        self._require_pk_cb()
        return self._pk_lin_col(k, z, "delta_cb")

    def pk_cb(self, k, z):
        if self.cosmo.out.non_linear:
            return self._pk_nl(k, z, self.cosmo.nonlinear.pk_cb_nl)
        return self.pk_cb_lin(k, z)

    def _background_at(self, name, z):
        """Column `name` of the background table at redshift(s) z, linear in
        ln a (the JAX classy's np.interp on the ln a grid)."""
        bg, bidx = self.cosmo.background
        loga = -np.log1p(np.asarray(z, dtype=float))
        return np.interp(loga, bg.loga.cpu().numpy(), bg.table[:, bidx[name]].cpu().numpy())

    def scale_independent_growth_factor(self, z):
        """D(z), normalised to 1 today (classy.py:1141)."""
        return self._background_at("D", z)

    def scale_independent_growth_factor_f(self, z):
        """f(z) = dln D/dln a (classy.py:1146)."""
        return self._background_at("f", z)

    def Omega0_k(self):
        """The curvature density today (classy.pyx Omega0_k :1771)."""
        return float(self.cosmo.params.Omega_k)

    def sigma8(self):
        """sigma8 of the linear total-matter spectrum at z = 0."""
        from .models.nonlinear import pk_linear_at_z, sigma_R

        self._require_mpk()
        bg, _ = self.cosmo.background
        pert = self.cosmo.perturbations
        pk = pk_linear_at_z(pert, bg, self.cosmo.primordial, 0.0)
        return float(sigma_R(pert.k, pk, 8.0 / self.cosmo.params.h)[0])

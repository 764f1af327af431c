"""Moving state across from the JAX package: parameter sets and stage
results given as plain dicts and numpy arrays become the port's types, so a
test can feed a torch stage exactly the input the JAX stage had.

Nothing here imports JAX: the caller turns the JAX objects into dicts
(NamedTuple._asdict(), dataclasses.asdict(), numpy.asarray) first. A
UniformSpline is a dict with keys x0, dx, y, y2. The curvature travels with
the parameters (Omega_k) and the background (H0): K = -Omega_k H0^2 and its
sign follow from them (`solve.curvature_of`, `Cosmology.curvature_K`), and a
transfer result keeps its k(q). The isocurvature modes travel as dicts: a
perturbation result's `sources_iso` {ic: table}, a spectra result's
`cl_pairs` {(ic1, ic2): table}, a primordial result's `iso` and `iso_corr`,
and the output selection's `ics`.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from .config.params import CosmoParams
from .config.precision import PrecisionParams
from .models.background import BackgroundResult, BgIdx
from .models.hyrec import HY_PARAMS, HyrecCtx, HyrecTables
from .models.nonlinear import PkResult
from .models.numbercounts import CmbNcCrossResult, NumberCountsResult, RowInfo
from .models.perturbations.equations import NcdmCtx
from .models.perturbations.solve import PerturbResult
from .models.perturbations.tensors import TensorResult
from .models.primordial import PrimordialResult
from .models.spectra import SpectraResult
from .models.thermodynamics import RecfastCtx, ThermoResult
from .models.transfer import TransferResult
from .ops.splines import UniformSpline
from .pipeline import OutputSelection


def _t(a, device):
    return torch.as_tensor(np.array(a, dtype=np.float64, order="C"),
                           device=device)


def _f(a):
    return None if a is None else float(np.asarray(a))


def cosmo_params(d: dict) -> CosmoParams:
    """CosmoParams from the JAX CosmoParams fields."""
    names = {f.name for f in dataclasses.fields(CosmoParams)}
    return CosmoParams(**{k: v for k, v in d.items() if k in names})


def precision_params(d: dict) -> PrecisionParams:
    """PrecisionParams from the JAX PrecisionParams fields. Fields the port
    does not have (the TPU launch knobs k_chunk_size and tau_windows, the
    float32 rule perturb_dtype, knobs of stages not ported yet) are dropped."""
    names = {f.name for f in dataclasses.fields(PrecisionParams)}
    return PrecisionParams(**{k: v for k, v in d.items() if k in names})


def spline(d: dict, device) -> UniformSpline:
    return UniformSpline(float(np.asarray(d["x0"])), float(np.asarray(d["dx"])),
                         _t(d["y"], device), _t(d["y2"], device))


def background(d: dict, device, names=None) -> tuple:
    """(BackgroundResult, BgIdx) from a JAX BackgroundResult dict. `names`
    (the JAX BgIdx.names) reorders the table columns when given; the scalar
    field's columns and idm_dr's (rho_idm_dr, rho_idr) come across when
    `names` holds them. The thermodynamics table carries idm_dr's rates and
    sound speed in every case (zeros without it)."""
    n_ncdm = len(np.atleast_1d(np.asarray(d.get("rho_ncdm0", ()))))
    has_scf = names is not None and "rho_scf" in names
    has_idm = names is not None and "rho_idm_dr" in names
    idx = BgIdx(n_ncdm, has_scf, has_idm)
    cols = slice(None) if names is None else [list(names).index(n) for n in idx.names]
    table = np.asarray(d["table"])[:, cols]
    spl = d["lntau_spline"]
    spl = dict(spl, y=np.asarray(spl["y"])[:, cols], y2=np.asarray(spl["y2"])[:, cols])
    scalars = {k: _f(d[k]) for k in BackgroundResult._fields
               if k not in ("loga", "tau_of_loga", "table", "lntau_spline", "rho_ncdm0")
               and k in d}
    scalars["rho_ncdm0"] = tuple(float(v) for v in np.atleast_1d(np.asarray(
        d.get("rho_ncdm0", ()))))
    return BackgroundResult(loga=_t(d["loga"], device), tau_of_loga=_t(d["tau_of_loga"], device),
                            table=_t(table, device), lntau_spline=spline(spl, device),
                            **scalars), idx


def thermo(d: dict, device) -> ThermoResult:
    kw = {}
    for k in ThermoResult._fields:
        if k == "lntau_spline":
            kw[k] = spline(d[k], device)
        elif k in ("z_grid", "xe_of_z", "Tb_of_z", "cb2_of_z", "dkappa_of_z"):
            kw[k] = _t(d[k], "cpu")
        elif k in d:
            kw[k] = _f(d[k])
    return ThermoResult(**kw)


def _tables(d, device):
    """{key: tensor} of a dict of tables (None or empty: None)."""
    if isinstance(d, np.ndarray) and d.dtype == object:
        d = d.item()
    return {k: _t(v, device) for k, v in d.items()} if d else None


def perturb(d: dict, device) -> PerturbResult:
    k_np = np.asarray(d["k"], dtype=np.float64)
    tau_np = np.asarray(d["tau"], dtype=np.float64)
    return PerturbResult(k=_t(k_np, device), tau=_t(tau_np, device),
                         sources=_t(d["sources"], device), tau0=_f(d["tau0"]),
                         k_size_cmb=int(d["k_size_cmb"]),
                         stats_steps=torch.as_tensor(np.array(d["stats_steps"]),
                                                     device=device),
                         k_np=k_np, tau_np=tau_np,
                         sources_iso=_tables(d.get("sources_iso"), device))


def transfer(d: dict, device) -> TransferResult:
    return TransferResult(l=torch.as_tensor(np.array(d["l"]), device=device),
                          q=_t(d["q"], device), delta=_t(d["delta"], device),
                          tau0=_f(d["tau0"]),
                          k=None if d.get("k") is None else _t(d["k"], device))


def tensor_perturb(d: dict, device) -> TensorResult:
    """TensorResult from a JAX TensorResult dict (no step counts)."""
    k_np = np.asarray(d["k"], dtype=np.float64)
    return TensorResult(k=_t(k_np, device), tau=_t(d["tau"], device),
                        sources=_t(d["sources"], device), tau0=_f(d["tau0"]), k_np=k_np)


def spectra(d: dict, device) -> SpectraResult:
    return SpectraResult(ell=torch.as_tensor(np.array(d["ell"]), device=device),
                         cl=_t(d["cl"], device),
                         l_list=torch.as_tensor(np.array(d["l_list"]), device=device),
                         cl_list=_t(d["cl_list"], device),
                         cl_tensor=None if d.get("cl_tensor") is None
                         else _t(d["cl_tensor"], device),
                         cl_pairs=_tables(d.get("cl_pairs"), device))


def primordial(d: dict) -> PrimordialResult:
    """PrimordialResult from a JAX PrimordialResult dict, with its
    isocurvature amplitudes and correlations (the external spectrum is
    dropped: not ported)."""
    def entries(v):
        if isinstance(v, np.ndarray) and v.dtype == object:
            v = v.item()
        return {k: tuple(float(x) for x in e) for k, e in v.items()} if v else None

    return PrimordialResult(*(float(np.asarray(d[k])) for k in PrimordialResult._fields[:7]),
                            iso=entries(d.get("iso")), iso_corr=entries(d.get("iso_corr")))


def ncdm_ctx(d: dict, device) -> NcdmCtx:
    """NcdmCtx from the JAX NcdmCtx arrays (the decay fields are dropped)."""
    return NcdmCtx(*(_t(d[k], device) for k in NcdmCtx._fields))


def pk_result(d: dict, device) -> PkResult:
    """PkResult from a JAX PkResult dict."""
    kw = {k: _t(d[k], device) for k in PkResult._fields if k != "sigma8"}
    return PkResult(sigma8=_f(d["sigma8"]), **kw)


def hyrec_ctx(d: dict) -> HyrecCtx:
    """HyrecCtx from a JAX HyrecCtx dict (scalars and tables, host)."""
    t = torch.as_tensor
    tables = HyrecTables(
        _t(d["log_alpha"], "cpu"), _t(d["log_r2p2s"], "cpu"),
        _t(np.stack([np.asarray(d[k]) for k in ("Eb", "A1s", "A2s", "A3s3d", "A4s4d")]), "cpu"),
        t(np.array(d["read_src"], dtype=np.int32)), t(np.array(d["read_off"], dtype=np.int32)),
        _t(d["read_w"], "cpu"))
    return HyrecCtx(**{k: _f(d[k]) for k in HY_PARAMS}, tables=tables)


def recfast_ctx(d: dict) -> RecfastCtx:
    """RecfastCtx from a JAX RecfastCtx dict, with its energy-injection
    fields (the inj scalars, rho_cdm today, the ln E spline beyond the
    spot); recfast_params of the result is the RF_PARAMS vector."""
    kw = {k: _f(d[k]) for k in RecfastCtx._fields
          if k not in ("H_of_z", "inj", "inj_conv") and k in d}
    conv = d.get("inj_conv")
    return RecfastCtx(H_of_z=spline(d["H_of_z"], "cpu"),
                      inj=tuple(float(np.asarray(v)) for v in d["inj"]),
                      inj_conv=None if conv is None else spline(conv, "cpu"), **kw)


def output_selection(d: dict) -> OutputSelection:
    """OutputSelection from the JAX OutputSelection fields, the number-count
    ones and the initial conditions `ics` included; fields the port does not
    have (dTk, vTk, the HMcode feedback, gauge, nbody) are dropped."""
    names = {f.name for f in dataclasses.fields(OutputSelection)}
    return OutputSelection(**{k: (tuple(v) if isinstance(v, list) else v)
                              for k, v in d.items() if k in names})


def row_info(d: dict, device) -> RowInfo:
    """RowInfo from a JAX `_RowInfo` dict (the numbercounts rows, windows and
    tau grids)."""
    return RowInfo(rows=tuple((str(t), int(b)) for t, b in d["rows"]),
                   tau_rows=_t(d["tau_rows"], device), W_rows=_t(d["W_rows"], device),
                   src_cols=tuple(str(c) for c in d["src_cols"]),
                   kpow=tuple(int(v) for v in d["kpow"]), radial=tuple(int(v) for v in d["radial"]),
                   lim_switch=tuple(float(v) for v in d["lim_switch"]), tau0=_f(d["tau0"]))


def number_counts(d: dict, device) -> NumberCountsResult:
    """NumberCountsResult from a JAX NumberCountsResult dict."""
    return NumberCountsResult(ell=torch.as_tensor(np.array(d["ell"]), device=device),
                              dd=_t(d["dd"], device), ll=_t(d["ll"], device),
                              dl=_t(d["dl"], device),
                              dd_pairs=tuple(tuple(int(v) for v in p) for p in d["dd_pairs"]),
                              dl_pairs=tuple(tuple(int(v) for v in p) for p in d["dl_pairs"]))


def nc_cross(d: dict, device) -> CmbNcCrossResult:
    """CmbNcCrossResult from a JAX CmbNcCrossResult dict."""
    return CmbNcCrossResult(ell=torch.as_tensor(np.array(d["ell"]), device=device),
                            pd=_t(d["pd"], device),
                            td=None if d.get("td") is None else _t(d["td"], device),
                            tl=None if d.get("tl") is None else _t(d["tl"], device))

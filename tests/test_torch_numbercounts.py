"""The port's number counts and galaxy lensing (classpp_public_torch/models/
numbercounts.py) against the JAX package's (classpp_public_tpu/models/
numbercounts.py) on the CPU, at small size.

- `nc_scan_plain` (the plain version of the CUDA kernel nc_scan) against the
  JAX `_nc_scan` on seeded random (x, Wrow): 6 rows (every radial code twice)
  x 40 k x 128 tau to l = 120, so that the x < 0.3 start, the x < 1 series
  and the forbidden-region mask all act. Both are float64 and differ only in
  the last bits of sin/cos/log/exp and of fused multiply-adds: where the
  upward recurrence is stable (x < 1, x > l_max) to 1e-10 of each row's scale
  (measured ~1e-15); with x through the band 1 < x < l < x + 6 x^(1/3) + 2,
  which the JAX algorithm keeps and where the recurrence amplifies those
  bits, to 1e-6 (measured 3.6e-8).
- The selection windows (Gaussian, tophat, the analytic dN/dz and
  myselection.dat with myevolution.dat), the assembled rows and the rows
  through the scan and the Limber tail on the JAX rows and identical sources:
  1e-12 of scale (the scan's band limit where the scan enters).
- `compute_number_counts` and `compute_cmb_nc_cross` given the same JAX
  perturbation table (classpp_public_torch.interop): 1e-8 of each spectrum's
  maximum. The two quadratures, splines and scans agree to ~1e-9.
- `Class(device="cpu")` end to end, from the JAX background and
  thermodynamics (the tau sampling reads the last bits of the thermodynamics
  table), for `nCl,sCl` with every contribution, bias and magnification bias,
  and for `tCl,lCl,nCl,mPk` (unlensed) with halofit on: the raw_cl keys of the JAX classy
  and its values to 1e-5 of each spectrum's maximum (measured: the number
  counts and crosses <= 2e-7, the two perturbation integrations agreeing to
  ~1e-8; the halofit-corrected phiphi 1.7e-6), and the nCl-only k and tau
  grids exactly.
- The divergences inherited from the JAX package: with halofit on, the number
  counts read the linear sources (the end-to-end case above); with Omega_k !=
  0 they use the flat j_l (compute_number_counts on a curved JAX background).
- The JAX classy's refusals: an unknown selection, unknown contributions, and
  `dirac` at the window.

Coarse precision throughout: perturb_sampling_stepsize 2, rtol 1e-4, a coarse
k step and 128 tau samples per row (selection_sampling 12.5, the Bessel knobs
5), l_max_lss 60.
"""

import dataclasses
import math
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import classpp_public_torch as T
from classpp_public_torch import interop
from classpp_public_torch.models import numbercounts as tnc
from classpp_public_torch.models.transfer import get_l_list

import classpp_public_tpu as J
from classpp_public_tpu.models import background as jbg
from classpp_public_tpu.models import numbercounts as jnc
from test_torch_common import asdict, one_torch_thread  # noqa: F401

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SEL_FILE = os.path.join(ROOT, "myselection.dat")
EVO_FILE = os.path.join(ROOT, "myevolution.dat")
SMALL = dict(background_Nloga=1024, recfast_Nz0=4000, perturb_sampling_stepsize=2.0,
             tol_perturb_integration=1e-4, k_step_sub=0.15, k_step_super=0.01,
             selection_sampling=12.5, selection_sampling_bessel=5.0,
             selection_sampling_bessel_los=5.0)
G19 = {"h": 0.67810, "omega_b": 0.02238280, "omega_cdm": 0.1201075, "N_ur": 3.046,
       "A_s": 2.100549e-09, "n_s": 0.9660499, "tau_reio": 0.05430842,
       "selection": "gaussian", "selection_mean": "0.5, 1.0", "selection_width": "0.1",
       "l_max_lss": 60, "non_diagonal": 1, "l_max_scalars": 60,
       "number count contributions": "density, rsd, lensing, gr",
       "selection_bias": "1.2, 1.5", "selection_magnification_bias": "0.1, 0.15", **SMALL}
ALL = ("density", "rsd", "lensing", "gr")
STAGE_TOL, E2E_TOL = 1e-8, 1e-5


def _rel(a, b, axis=-1):
    """max |a - b| over each row of the last axis, relative to the row's max |b|."""
    a, b = np.asarray(a), np.asarray(b)
    return float(np.max(np.max(np.abs(a - b), axis=axis) / np.max(np.abs(b), axis=axis)))


# --- the selection-window scan --------------------------------------------


# x samples: "stable" where neither scan amplifies round-off (below 1, where
# the emitted values come from the series, and beyond l_max, where the upward
# recurrence is stable), with the x < 0.3 start and the mask acting; "band"
# over the whole range, through 1 < x < l < x + 6 x^(1/3) + 2, where the
# upward recurrence that the JAX algorithm keeps (the mask cuts it only above
# that band) amplifies last-bit differences of sin/cos and of fused
# multiply-adds by up to ~1e16 per point
NC_SCAN_X = {"stable": (1e-10, lambda rng, n: np.where(rng.random(n) < 0.5,
                                                        10.0 ** rng.uniform(-3.0, -1e-3, n),
                                                        rng.uniform(160.0, 300.0, n))),
             "band": (1e-6, lambda rng, n: 10.0 ** rng.uniform(-3.0, math.log10(300.0), n))}


@pytest.mark.parametrize("xs", list(NC_SCAN_X))
def test_nc_scan_plain_matches_jax(xs):
    """Per row, relative to the row's scale: measured ~1e-15 on the stable
    samples, 3.6e-8 with the band (limit 1e-6)."""
    rng = np.random.default_rng(7)
    nrow, nk, ntau = 6, 40, 128
    tol, draw = NC_SCAN_X[xs]
    x = draw(rng, nrow * nk * ntau).reshape(nrow, nk, ntau)
    x[:, :, :4] = 0.0                                    # the clamp at 1e-12
    W = rng.standard_normal((nrow, nk, ntau))
    radial = (0, 1, 2, 0, 1, 2)
    ls = get_l_list(T.PrecisionParams(), 120)
    emit_idx = np.full(int(ls[-1]) + 1, -1, dtype=np.int32)
    emit_idx[ls] = np.arange(len(ls), dtype=np.int32)
    ref = np.asarray(jnc._nc_scan(jnp.asarray(x), jnp.asarray(W),
                                  jnp.asarray(np.eye(3)[list(radial)]), jnp.asarray(ls),
                                  jnp.asarray(emit_idx), int(ls[-1]), len(ls), nrow, nk))
    got = tnc.nc_scan(torch.as_tensor(x), torch.as_tensor(W), radial, ls).numpy()
    assert got.shape == ref.shape == (len(ls), nrow, nk)
    assert np.isfinite(got).all()
    err = [float(np.abs(got[:, r] - ref[:, r]).max() / np.abs(ref[:, r]).max())
           for r in range(nrow)]
    print(f"nc_scan_plain vs JAX _nc_scan ({xs}), per row relative to its scale: {err}")
    assert max(err) <= tol, err


# --- the LSS side: windows, rows, Limber ----------------------------------


@pytest.fixture(scope="module")
def tables():
    """The JAX background (and both packages' views of it) at the g19 cosmology."""
    params = J.CosmoParams(h=0.67810, omega_b=0.02238280, omega_cdm=0.1201075)
    pr = J.PrecisionParams(**SMALL)
    bg, bidx = jbg.compute_background(params, pr)
    bgt, bit = interop.background(asdict(bg), "cpu", names=bidx.names)
    return pr, interop.precision_params(dataclasses.asdict(pr)), bg, bidx, bgt, bit


@pytest.mark.parametrize("kind", ["gaussian", "tophat"])
@pytest.mark.parametrize("dndz", [None, "analytic", "file"])
def test_selection_dndz_matches_jax(tables, kind, dndz):
    prj, prt = tables[:2]
    z = np.linspace(0.0, 2.5, 301)
    fj = jnc.make_dndz_from_file(SEL_FILE)[0] if dndz == "file" else (
        jnc._dndz_analytic if dndz else None)
    ft = tnc.make_dndz_from_file(SEL_FILE)[0] if dndz == "file" else (
        tnc._dndz_analytic if dndz else None)
    ref = np.asarray(jnc._selection_dndz(jnp.asarray(z), 0.7, 0.2, kind, prj, fj))
    got = tnc._selection_dndz(torch.as_tensor(z), 0.7, 0.2, kind, prt, ft).numpy()
    assert np.max(np.abs(got - ref)) <= 1e-13 * np.abs(ref).max()


ROW_CASES = {
    # name: (kind, contributions, bias, magnification, dndz, dndz_evo, want_ll)
    "gaussian_all": ("gaussian", ALL, (1.2, 1.5), (0.1, 0.15), None, None, True),
    "tophat_files": ("tophat", ALL, (1.3,), (0.2,), SEL_FILE, EVO_FILE, True),
    "analytic": ("gaussian", ("density", "rsd", "gr"), None, None, "analytic", "analytic",
                 False),
}


def _rows_both(tables, case):
    prj, prt, bg, bidx, bgt, bit = tables
    kind, contrib, bias, magn, dndz, evo, want_ll = ROW_CASES[case]
    args = ((0.5, 1.0), (0.1, 0.1), kind, contrib, bias, magn, dndz, evo,
            float(bg.tau0), want_ll)
    return (jnc._assemble_rows(bg, bidx, prj, *args),
            tnc._assemble_rows(bgt, bit, prt, *args))


@pytest.mark.parametrize("case", list(ROW_CASES))
def test_assemble_rows_matches_jax(tables, case):
    rj, rt = _rows_both(tables, case)
    assert rt.rows == rj.rows and rt.src_cols == rj.src_cols
    assert rt.kpow == rj.kpow and rt.radial == rj.radial
    np.testing.assert_allclose(rt.lim_switch, rj.lim_switch, rtol=1e-15)
    np.testing.assert_allclose(rt.tau_rows.numpy(), np.asarray(rj.tau_rows), rtol=1e-14)
    assert _rel(rt.W_rows.numpy(), rj.W_rows) <= 1e-12


@pytest.mark.parametrize("case", ["gaussian_all", "tophat_files"])
def test_delta_from_rows_matches_jax(tables, case):
    """The rows through the scan and, above each row's switch, the Limber
    tail (T0, T1, NC_RSD), on the JAX rows and the same smooth sources: the
    scan's own limit (1e-6 of each row's scale; its x runs through the band)
    and the Limber rows alone 1e-12."""
    rj, _ = _rows_both(tables, case)
    rt = interop.row_info(asdict(rj), "cpu")
    k = np.geomspace(2e-3, 0.3, 50)
    ls = get_l_list(T.PrecisionParams(), 120)
    cols = sorted(set(rj.src_cols))

    def source(col, tau):
        c = cols.index(col) + 1.0
        return np.cos(k[:, None] * tau[None, :] / (30.0 * c)) * np.exp(-k[:, None] * c)

    got = tnc._delta_from_rows(torch.as_tensor(k), lambda col, tr: torch.as_tensor(
        source(col, tr.numpy())), rt, ls).numpy()
    ref = np.asarray(jnc._delta_from_rows(jnp.asarray(k), lambda col, tr: jnp.asarray(
        source(col, np.asarray(tr))), rj, ls))
    assert got.shape == ref.shape
    err = np.abs(got - ref).max(axis=(0, 2)) / np.abs(ref).max(axis=(0, 2))
    print(f"_delta_from_rows ({case}) per row relative to its scale: max {err.max():.3e}")
    assert err.max() <= NC_SCAN_X["band"][0]
    lim = ls[:, None] >= np.asarray(rj.lim_switch)[None, :]
    assert lim.any() and (~lim).any()
    d = np.abs(got - ref)[lim]
    assert d.max() <= 1e-12 * np.abs(ref[lim]).max()


def test_dndz_file_and_evolution_match_jax():
    z = np.linspace(0.0, 3.2, 200)
    for i in (0, 1):
        fj, ft = jnc.make_dndz_from_file(EVO_FILE)[i], tnc.make_dndz_from_file(EVO_FILE)[i]
        np.testing.assert_allclose(ft(torch.as_tensor(z)).numpy(), np.asarray(fj(jnp.asarray(z))),
                                   rtol=1e-14, atol=1e-300)
    zz = np.linspace(0.05, 3.0, 50)
    np.testing.assert_allclose(tnc._dln_dndz_dz_analytic(torch.as_tensor(zz)).numpy(),
                               np.asarray(jnc._dln_dndz_dz_analytic(jnp.asarray(zz))), rtol=1e-14)


# --- whole stages and the classy surface -----------------------------------


def _classy_pair(params):
    """(JAX Class, port Class) computed on params; the port seeded with the
    JAX background and thermodynamics."""
    cj = J.Class()
    cj.set(dict(params))
    cj.compute(["lensing"])
    ct = T.Class(device="cpu")
    ct.set(dict(params))
    bg, bidx = cj.cosmo.background
    ct.cosmo.set_stage("background", interop.background(asdict(bg), "cpu", names=bidx.names))
    ct.cosmo.set_stage("thermodynamics", interop.thermo(asdict(cj.cosmo.thermodynamics), "cpu"))
    ct.compute(["lensing"])
    return cj, ct


@pytest.fixture(scope="module")
def nc_only():
    return _classy_pair(dict(G19, output="nCl,sCl"))


@pytest.fixture(scope="module")
def cmb_nc():
    return _classy_pair(dict(G19, output="tCl,lCl,nCl,mPk", lensing="no",
                             **{"non linear": "halofit", "P_k_max_1/Mpc": 1.0,
                                "nonlinear_min_k_max": 1.0, "halofit_min_k_max": 1.0}))


def _check_raw_cl(cj, ct):
    a, b = ct.raw_cl(), cj.raw_cl()
    assert sorted(a) == sorted(b)
    worst = {}
    for key in b:
        if key == "ell":
            np.testing.assert_array_equal(a[key], b[key])
            continue
        ref = np.asarray(b[key])
        scale = np.max(np.abs(ref))
        if scale == 0.0:              # bb without tensor modes
            np.testing.assert_array_equal(a[key], ref)
            continue
        worst[key] = float(np.max(np.abs(a[key] - ref)) / scale)
    print(f"raw_cl relative to each spectrum's max: {worst}")
    assert max(worst.values()) <= E2E_TOL, worst
    return a


def test_nc_only_grids_match_jax(nc_only):
    cj, ct = nc_only
    np.testing.assert_array_equal(ct.cosmo.perturbations.k_np, cj.cosmo.perturbations.k_np)
    np.testing.assert_array_equal(ct.cosmo.perturbations.tau_np,
                                  np.asarray(cj.cosmo.perturbations.tau))


def test_classy_nc_sc_matches_jax(nc_only):
    cj, ct = nc_only
    a = _check_raw_cl(cj, ct)
    assert {"dens[1]-dens[2]", "lens[2]-lens[2]", "dens[2]-lens[1]"} <= set(a)
    d = ct.density_cl()
    dj = cj.density_cl()
    assert sorted(d) == sorted(dj)
    for key in ("dd", "ll", "dl"):
        assert _rel(d[key], dj[key]) <= E2E_TOL


def test_classy_cmb_cross_matches_jax(cmb_nc):
    """tCl,lCl,nCl with halofit on: the CMB spectra, dens, and phi-dens /
    T-dens; the number counts read the linear sources as in the JAX package."""
    cj, ct = cmb_nc
    a = _check_raw_cl(cj, ct)
    assert {"phi-dens[1]", "T-dens[2]", "tt", "pp"} <= set(a)
    assert "T-lens[1]" not in a


def test_stages_on_the_jax_table_match(cmb_nc):
    """compute_number_counts and compute_cmb_nc_cross (with both extensions)
    given the JAX perturbation table: 1e-8 of each spectrum's maximum."""
    cj, _ = cmb_nc
    c = cj.cosmo
    o = interop.output_selection(dataclasses.asdict(c.out))
    assert o.has_nc and o.nc_contributions == ALL and o.selection_bias == (1.2, 1.5)
    bg, bidx = c.background
    bgt, bit = interop.background(asdict(bg), "cpu", names=bidx.names)
    pt = interop.perturb(asdict(c.perturbations), "cpu")
    tht = interop.thermo(asdict(c.thermodynamics), "cpu")
    prt = interop.precision_params(dataclasses.asdict(c.pr))
    pm = T.Cosmology(interop.cosmo_params(dataclasses.asdict(c.params)), prt,
                     device="cpu").primordial
    kw = dict(kind=o.selection_kind, l_max=o.l_lss_max, contributions=o.nc_contributions,
              selection_bias=o.selection_bias, magnification_bias=o.magnification_bias)
    sel = (o.selection_mean, o.selection_width)
    ncj = interop.number_counts(asdict(c.number_counts), "cpu")
    nct = tnc.compute_number_counts(pt, bgt, bit, pm, prt, *sel, non_diag=o.non_diagonal, **kw)
    assert torch.equal(nct.ell, ncj.ell)
    assert nct.dd_pairs == ncj.dd_pairs and nct.dl_pairs == ncj.dl_pairs
    errs = {f: _rel(getattr(nct, f).numpy(), getattr(ncj, f).numpy())
            for f in ("dd", "ll", "dl")}
    xj = interop.nc_cross(asdict(jnc.compute_cmb_nc_cross(
        c.perturbations, c.thermodynamics, bg, bidx, c.primordial, c.pr, *sel, want_td=True,
        want_tl=True, **kw)), "cpu")
    xt = tnc.compute_cmb_nc_cross(pt, tht, bgt, bit, pm, prt, *sel, want_td=True,
                                  want_tl=True, **kw)
    errs.update({f: _rel(getattr(xt, f).numpy(), getattr(xj, f).numpy())
                 for f in ("pd", "td", "tl")})
    print(f"stages on the JAX table, relative to each spectrum's max: {errs}")
    assert max(errs.values()) <= STAGE_TOL, errs


def test_curved_number_counts_use_flat_bessels_as_jax(nc_only):
    """Omega_k = 0.01: on a curved background the number counts equal the
    JAX ones; neither takes the curvature into its Bessel scan (flat j_l; the
    C++ code uses hyperspherical Bessels, ROADMAP Queue 3)."""
    cj = nc_only[0].cosmo
    params = dataclasses.replace(cj.params, Omega_k=0.01)
    bg, bidx = jbg.compute_background(params, cj.pr)
    bgt, bit = interop.background(asdict(bg), "cpu", names=bidx.names)
    prt = interop.precision_params(dataclasses.asdict(cj.pr))
    pm = T.Cosmology(interop.cosmo_params(dataclasses.asdict(params)), prt,
                     device="cpu").primordial
    kw = dict(l_max=30, contributions=("density", "lensing"))
    ref = jnc.compute_number_counts(cj.perturbations, bg, bidx, cj.primordial, cj.pr, (0.5,),
                                    (0.1,), **kw)
    got = tnc.compute_number_counts(interop.perturb(asdict(cj.perturbations), "cpu"), bgt, bit,
                                    pm, prt, (0.5,), (0.1,), **kw)
    for f in ("dd", "ll", "dl"):
        assert _rel(getattr(got, f).numpy(), getattr(ref, f)) <= STAGE_TOL, f


# --- refusals ---------------------------------------------------------------


@pytest.mark.parametrize("extra,err", [
    ({"selection": "lorentzian"}, "unknown selection"),
    ({"number count contributions": "density, magic"}, "unknown number count contributions"),
])
def test_refusals_mirror_jax(extra, err):
    params = dict(G19, output="nCl", **extra)
    for cls, exc in ((J.Class, J.CosmoSevereError), (T.Class, T.CosmoSevereError)):
        c = cls(device="cpu") if cls is T.Class else cls()
        c.set(dict(params))
        with pytest.raises(exc, match=err):
            c.cosmo


def test_dirac_selection_raises_as_jax(tables):
    """`selection = dirac` parses on both sides and is refused at the window,
    as the JAX package refuses it."""
    prj, prt = tables[:2]
    for cls in (J.Class, T.Class):
        c = cls(device="cpu") if cls is T.Class else cls()
        c.set(dict(G19, output="nCl", selection="dirac"))
        assert c.cosmo.out.selection_kind == "dirac"
    z = np.linspace(0.3, 0.7, 5)
    with pytest.raises(ValueError, match="unknown selection 'dirac'"):
        jnc._selection_dndz(jnp.asarray(z), 0.5, 0.1, "dirac", prj)
    with pytest.raises(ValueError, match="unknown selection 'dirac'"):
        tnc._selection_dndz(torch.as_tensor(z), 0.5, 0.1, "dirac", prt)


@pytest.mark.parametrize("name", ["g7_ncl", "g19_ncl_full", "g27_pd"])
def test_nc_golden_contracts_read_the_golden(name):
    """tools/golden_check.py's number-count contracts: the golden's own
    spectra meet them with no error, and a 2% excess in one spectrum (of
    itself, or of the phi-dens envelope) breaks its 1e-2 limit."""
    from classpp_public_torch.tools.golden_check import Golden, golden_check

    g = Golden(name).g
    cols = [str(c) for c in g["cl__cols"]]
    lr = g["cl"][:, 0].astype(int)
    raw = {}
    for i, col in enumerate(cols[1:], 1):
        arr = np.zeros(lr.max() + 1)
        arr[lr] = g["cl"][:, i] * 2.0 * np.pi / np.maximum(lr * (lr + 1.0), 1.0)
        raw[{"TT": "tt", "phiphi": "pp"}.get(col, col)] = arr
    for b in (1, 2):
        dd = raw[f"dens[{b}]-dens[{b}]"]
        raw[f"T-dens[{b}]"] = 0.5 * np.sqrt(np.abs(raw.get("tt", 0.0) * dd))
    rel = golden_check(name, raw, None, None, 0.6781)
    assert all(v <= 1e-12 for k, (v, tol, _) in rel.items() if not k.endswith("_envelope"))
    if name == "g27_pd":
        key = "phi-dens[1]"
        raw[key] = raw[key] + 0.02 * np.sqrt(raw["pp"] * raw["dens[1]-dens[1]"])
    else:
        key = "dens[1]-dens[1]"
        raw[key] = raw[key] * 1.02
    rel = golden_check(name, raw, None, None, 0.6781)
    assert rel[key][1] < rel[key][0] < 0.021

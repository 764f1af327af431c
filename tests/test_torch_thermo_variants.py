"""classpp_public_torch's thermodynamics variants against classpp_public_tpu
on identical inputs (CPU): HyRec in both its models, DM energy injection in
RECFAST (on the spot and beyond it) and the reionization schemes, at the
reduced precision of __graft_entry__._small_setup (background_Nloga = 1024,
recfast_Nz0 = 4000) and the cosmology of the g5/g11/g16 goldens.

- HyRec histories (all 108 487 steps): the plain loop `hyrec_history_plain`
  against the JAX `build_history` through `_history_core`, from the same
  context (interop.hyrec_ctx), `model="recfast"` with and without an
  injection table and `model="full"`: x_e and T_m to 1e-8 relative (measured
  3e-15 and 1.7e-14: libm and XLA differ in last bits only). Each phase's
  first step is the same in both: the JAX package's are found by taking its
  `done` tests (hyrec.py:622-720) again on its own x_e and T_m; both print.
- The host build of the kernel's code (csrc/hyrec_host.cpp) against the plain
  loop, both models: 1e-12 relative (measured: equal bits; the plain loop
  calls libm and sums per-bin values in the kernel's tree order).
- RECFAST with injection (g16: on the spot; g22: beyond it): the plain loop
  against the JAX `compute_recombination(..., inj_on=True)`, as the
  injection-free history in test_torch_background_thermo.py: 1e-10 relative,
  1e-7 in the HeI rows (the explicit RK4 through the stiff HeI phase takes
  XLA's and libm's last bits to ~5e-8 of x_e). The host build of
  csrc/recfast.cuh with injection (including the variation, halo and decay
  terms) against the plain loop: 1e-12.
- The six reionization schemes: the port's thermodynamics against the JAX
  `_compute_thermodynamics_impl` from the same background and recombination
  table (both moved across): tau_reio, z_reio and the merged x_e, T_b, c_b^2
  tables to 1e-10 relative.
- The refusals of tests/test_reio.py:121-130 raise CosmoSevereError.
- End to end: a g5_hyrec-like point (recombination = HyRec, unlensed
  TT/EE/TE to l = 100) through Class(device="cpu") from the JAX background:
  its thermodynamics against the JAX package's (scalars and merged x_e, T_b
  tables to 1e-8 relative, c_b^2 to 1e-7: at z > 5000 its Compton term is a
  cancellation that takes T_m's last bits to ~2e-8), and its C_l against the JAX Class's computed from the
  port's thermodynamics (1e-3, TE against sqrt(TT EE), as
  test_torch_slice.py). The source sampling in tau follows the last bits of
  the thermodynamics table, so the JAX spectra are seeded with the port's
  table rather than computed from their own.
"""

import ctypes
import dataclasses
import shutil
import subprocess
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import classpp_public_torch as T
from classpp_public_torch import interop
from classpp_public_torch.config.params import CosmoParams as TParams
from classpp_public_torch.config.precision import PrecisionParams as TPrec
from classpp_public_torch.models import hyrec as thy
from classpp_public_torch.models import thermodynamics as tth
from classpp_public_torch.ops import cuda

import classpp_public_tpu as J
from classpp_public_tpu import CosmoParams as JParams
from classpp_public_tpu import PrecisionParams as JPrec
from classpp_public_tpu.models import background as jbg
from classpp_public_tpu.models import hyrec as jhy
from classpp_public_tpu.models import thermodynamics as jth
from test_torch_common import asdict, one_torch_thread  # noqa: F401

SMALL = dict(background_Nloga=1024, recfast_Nz0=4000)
COSMO = dict(h=0.67810, T_cmb=2.7255, omega_b=0.02238280, omega_cdm=0.1201075, N_ur=3.046,
             A_s=2.100549e-09, n_s=0.9660499)
ZSTART = 1.0e4
HIST_TOL = 1e-8
HOST_TOL = 1e-12


def _params(**kw):
    return JParams(**dict(COSMO, **kw)), TParams(**dict(COSMO, **kw))


def _jax_background(pj):
    bgj, bij = jbg.compute_background(pj, JPrec(**SMALL))
    bgt, bit = interop.background(asdict(bgj), "cpu", names=bij.names)
    return (bgj, bij), (bgt, bit)


# --- HyRec ------------------------------------------------------------------


@pytest.fixture(scope="module")
def hyrec_ctx():
    """The JAX HyrecCtx of the default point, its injection table for
    annihilation = 1e-6 on the spot, and both moved across."""
    pj, pt = _params(annihilation=1e-6)
    (bgj, bij), (bgt, _) = _jax_background(pj)
    YHe = float(jth.make_recfast_ctx(pj, JPrec(**SMALL), bgj, bij).YHe)
    ctx = jhy.make_hyrec_ctx(pj, bgj, YHe, pj.N_eff, pr=JPrec(**SMALL))
    inj = jhy.hyrec_injection_grid(pj, ctx, ZSTART)
    tctx = interop.hyrec_ctx(asdict(ctx))
    return ctx, inj, tctx, pt, (bgt, YHe)


def _plain(tctx, inj, model):
    starts = []
    xe, Tm = thy.hyrec_history_plain(thy.hyrec_params(tctx), tctx.tables,
                                     torch.as_tensor(thy.z_grid(ZSTART)),
                                     None if inj is None else torch.as_tensor(inj), model,
                                     phase_starts=starts)
    return xe.numpy(), Tm.numpy(), starts


@pytest.fixture(scope="module")
def histories(hyrec_ctx):
    """(JAX, plain) histories: recfast model without and with injection, and
    the full model."""
    ctx, inj, tctx, _, _ = hyrec_ctx
    out = {}
    for key, model, table in (("recfast", "recfast", None), ("recfast_inj", "recfast", inj),
                              ("full", "full", None)):
        if table is None:
            _, xe, Tm = jhy._history_core(ZSTART, model)(ctx)
        else:
            _, xe, Tm = jhy._history_core(ZSTART, model, True)(ctx, table)
        out[key] = (np.asarray(xe), np.asarray(Tm)), _plain(tctx, table, model)
    return out


def _jax_phase_starts(ctx, xe, Tm, z):
    """(phase, first step) of phases 1-7 of the JAX build_history: its done
    tests, each decided at step j on the values that step wrote (the Saha
    offsets of phases 1 and 3, the Saha gap and z of phase 2, the T_m / T_r
    gap of phase 4, z for 5 and 6), taken again on the JAX x_e and T_m."""
    zj = jnp.asarray(z)
    dd = [np.asarray(jhy.saha_HeII(ctx, zj)[1]) <= 1e-9,
          xe - np.asarray(jhy.saha_HeI(ctx, zj)) >= 5e-4,
          (np.abs(xe - np.asarray(jhy.saha_xe_H(ctx, zj))) <= 1e-4) & (z <= 1650.0),
          xe - np.asarray(jhy.saha_xe_H(ctx, zj)) >= 5e-5,
          (1.0 - Tm / (float(ctx.T0) * (1.0 + z)) >= 5e-4) | (z <= 700.0),
          z <= 700.0, z <= 20.0]
    starts, j = [], 1
    for ph, done in enumerate(dd):
        hits = np.nonzero(done[j:])[0]
        if not len(hits):
            break
        j += int(hits[0])
        starts.append((ph + 1, j + 1))
        j += 1
    return starts


@pytest.mark.parametrize("key", ["recfast", "recfast_inj", "full"])
def test_hyrec_history_plain_matches_jax(hyrec_ctx, histories, key):
    (xe_j, Tm_j), (xe_p, Tm_p, starts) = histories[key]
    assert xe_p.shape == xe_j.shape == (108487,)
    z = thy.z_grid(ZSTART)
    starts_j = _jax_phase_starts(hyrec_ctx[0], xe_j, Tm_j, z)
    for who, st in (("port", starts), ("JAX", starts_j)):
        print(f"{key}: {who} phase first steps (phase, step, z) "
              + ", ".join(f"({ph}, {j}, {z[j]:.2f})" for ph, j in st if j < len(z)))
    assert [ph for ph, _ in starts] == list(range(1, 8))
    assert starts == starts_j
    for name, a, b in (("x_e", xe_p, xe_j), ("T_m", Tm_p, Tm_j)):
        rel = np.abs(a - b) / np.abs(b)
        first = np.nonzero(rel > HIST_TOL)[0]
        assert not len(first), f"{key} {name}: step {first[0]} (z = {z[first[0]]:.3f}) is " \
            f"{rel[first[0]]:.3e} apart; phase starts {starts}"


@pytest.fixture(scope="module")
def hyrec_host(tmp_path_factory):
    """csrc/hyrec_host.cpp built with g++ (None without g++)."""
    gxx = shutil.which("g++")
    if gxx is None:
        return None
    so = tmp_path_factory.mktemp("hyrec") / "libhyrec_host.so"
    subprocess.run([gxx, "-O2", "-std=c++17", "-shared", "-fPIC", "-o", str(so),
                    str(Path(cuda.CSRC_DIR) / "hyrec_host.cpp")], check=True)
    lib = ctypes.CDLL(str(so))
    P, I = ctypes.c_void_p, ctypes.c_int
    lib.hyrec_history_host.argtypes = [P] * 8 + [I, P, I, P, P, P]
    return lib


@pytest.mark.parametrize("key", ["recfast", "recfast_inj", "full"])
def test_hyrec_kernel_code_on_host(hyrec_ctx, histories, hyrec_host, key):
    """csrc/hyrec.cuh built for the host against the plain loop."""
    if hyrec_host is None:
        pytest.skip("no g++ to build the host version of the HyRec kernel's code")
    _, inj, tctx, _, _ = hyrec_ctx
    _, (xe_p, Tm_p, _) = histories[key]
    assert hyrec_host.hyrec_n_params() == len(thy.HY_PARAMS)
    assert hyrec_host.hyrec_n_zcol() == thy.NZCOL     # the wrapper sizes the kernel's table
    z = torch.as_tensor(thy.z_grid(ZSTART))
    nz = z.shape[0]
    table = torch.as_tensor(inj) if key == "recfast_inj" else None
    ring = torch.full((thy.RING, thy.NROW), -1.0, dtype=torch.float64)
    xe, Tm = torch.empty(nz, dtype=torch.float64), torch.empty(nz, dtype=torch.float64)
    hp, tb = thy.hyrec_params(tctx), tctx.tables
    assert hyrec_host.hyrec_history_host(
        hp.data_ptr(), tb.log_alpha.data_ptr(), tb.log_r2p2s.data_ptr(), tb.twog.data_ptr(),
        tb.read_src.data_ptr(), tb.read_off.data_ptr(), tb.read_w.data_ptr(), z.data_ptr(), nz,
        None if table is None else table.data_ptr(), int(key == "full"), ring.data_ptr(),
        xe.data_ptr(), Tm.data_ptr()) == 0
    for name, a, b in (("x_e", xe.numpy(), xe_p), ("T_m", Tm.numpy(), Tm_p)):
        assert np.max(np.abs(a - b) / np.abs(b)) <= HOST_TOL, name


def test_hyrec_context_and_tables_are_the_ports_own(hyrec_ctx):
    """make_hyrec_ctx from the port's own copy of the rate tables equals the
    JAX context moved across."""
    _, _, tctx, pt, (bgt, YHe) = hyrec_ctx
    mine = thy.make_hyrec_ctx(pt, bgt, YHe, pt.N_eff, TPrec(**SMALL))
    assert thy._DATA == Path(thy.__file__).resolve().parents[1] / "data" / "hyrec"
    for n in thy.HY_PARAMS:
        assert getattr(mine, n) == pytest.approx(getattr(tctx, n), rel=1e-14), n
    for a, b in zip(mine.tables, tctx.tables):
        assert torch.equal(a, b)


def test_hyrec_injection_grid_matches_jax(hyrec_ctx):
    """On the spot at full size; beyond it (the dz' = 1 trapezoid, computed
    here in blocks of rows: two at this size) from z = 0.3 down."""
    ctx, inj, tctx, pt, _ = hyrec_ctx
    np.testing.assert_allclose(thy.hyrec_injection_grid(pt, tctx, ZSTART), inj, rtol=1e-13)
    pj_b = JParams(**dict(COSMO, annihilation=1e-6, on_the_spot=False))
    pt_b = TParams(**dict(COSMO, annihilation=1e-6, on_the_spot=False))
    np.testing.assert_allclose(thy.hyrec_injection_grid(pt_b, tctx, 0.3),
                               jhy.hyrec_injection_grid(pj_b, ctx, 0.3), rtol=1e-13)


def test_hyrec_wrapper_takes_the_plain_version_only_on_the_cpu(hyrec_ctx):
    _, _, tctx, _, _ = hyrec_ctx
    before = thy.launches
    meta = tctx.tables._replace(log_alpha=tctx.tables.log_alpha.to("meta"))
    z = torch.zeros(8, dtype=torch.float64, device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        thy.hyrec_history(thy.hyrec_params(tctx).to("meta"), meta, z, None, "recfast")
    with pytest.raises(ValueError, match="model"):
        thy.hyrec_history_plain(thy.hyrec_params(tctx), tctx.tables,
                                torch.zeros(8, dtype=torch.float64), None, "exact")
    assert thy.launches == before


# --- RECFAST with energy injection --------------------------------------------


@pytest.fixture(scope="module")
def recfast_host(tmp_path_factory):
    gxx = shutil.which("g++")
    if gxx is None:
        return None
    so = tmp_path_factory.mktemp("recfast_inj") / "librecfast_host.so"
    subprocess.run([gxx, "-O2", "-std=c++17", "-shared", "-fPIC", "-o", str(so),
                    str(Path(cuda.CSRC_DIR) / "recfast_host.cpp")], check=True)
    lib = ctypes.CDLL(str(so))
    P, I, D = ctypes.c_void_p, ctypes.c_int, ctypes.c_double
    lib.recfast_history_host_inj.argtypes = [P, P, P, D, D, I, P, P, D, D, I, I, P]
    return lib


INJECTION = {"ots": dict(annihilation=1e-6, YHe=0.2454006),
             "bos": dict(annihilation=1e-6, YHe=0.2454006, on_the_spot=False)}


def _port_recfast(pt, bgt, bit):
    ctx = tth.make_recfast_ctx(pt, TPrec(**SMALL), bgt, bit)
    rp = tth.recfast_params(ctx, TPrec(**SMALL))
    return ctx, rp, tth.recfast_history(rp, ctx.H_of_z, SMALL["recfast_Nz0"], ctx.inj_conv)


@pytest.mark.parametrize("kind", sorted(INJECTION))
def test_recfast_injection_plain_matches_jax(kind):
    pj, pt = _params(**INJECTION[kind])
    (bgj, bij), (bgt, bit) = _jax_background(pj)
    cj = jth.make_recfast_ctx(pj, JPrec(**SMALL), bgj, bij)
    ref = jth.compute_recombination(pj, JPrec(**SMALL), cj, inj_on=True)
    ref = np.stack([np.asarray(getattr(ref, n)) for n in tth.RECO_COLUMNS])
    ctx, rp, got = _port_recfast(pt, bgt, bit)
    assert (ctx.inj_conv is None) == (kind == "ots")
    assert float(rp[tth.RF_PARAMS.index("inj_on")]) == 1.0
    # the JAX context moved across gives the same RF_PARAMS vector
    moved = interop.recfast_ctx(asdict(cj))
    assert (moved.inj_conv is None) == (kind == "ots")
    np.testing.assert_allclose(tth.recfast_params(moved, TPrec(**SMALL)).numpy(), rp.numpy(),
                               rtol=1e-14)
    if ctx.inj_conv is not None:
        np.testing.assert_allclose(ctx.inj_conv.y.numpy(), np.asarray(cj.inj_conv.y),
                                   rtol=0, atol=1e-12)
    got = got.numpy()
    he_rows = (ref[1] > 1.0) & (ref[1] < 1.0 + ctx.fHe)
    for i, name in enumerate(tth.RECO_COLUMNS):
        rel = np.abs(got[i] - ref[i]) / np.abs(ref[i]).clip(1e-300)
        assert rel[~he_rows].max() <= 1e-10, name
        assert rel[he_rows].max() <= 1e-7, name
    # and the injection moves the freeze-out tail (test_injection.py:78-96)
    clean = tth.recfast_history(tth.recfast_params(tth.make_recfast_ctx(
        TParams(**dict(COSMO, YHe=0.2454006)), TPrec(**SMALL), bgt, bit), TPrec(**SMALL)),
        ctx.H_of_z, SMALL["recfast_Nz0"]).numpy()
    tail = (ref[0] > 80) & (ref[0] < 300)
    assert (got[1][tail] / clean[1][tail]).max() > 1.5


@pytest.mark.parametrize("extra", [{}, dict(on_the_spot=False),
                                   dict(annihilation_variation=-0.2, decay=1e-26,
                                        annihilation_f_halo=0.1, annihilation_zmin=50.0)])
def test_recfast_injection_kernel_code_on_host(recfast_host, extra):
    """csrc/recfast.cuh with injection, built for the host, against the
    plain loop: on the spot, beyond it, and the variation, halo and decay
    terms of the on-the-spot rate."""
    if recfast_host is None:
        pytest.skip("no g++ to build the host version of the RECFAST kernel's code")
    pj, pt = _params(**dict(INJECTION["ots"], **extra))
    _, (bgt, bit) = _jax_background(pj)
    ctx, rp, got = _port_recfast(pt, bgt, bit)
    H, E = ctx.H_of_z, ctx.inj_conv
    Nz = SMALL["recfast_Nz0"]
    out = torch.empty((6, Nz), dtype=torch.float64)
    Hy, Hy2 = H.y.contiguous(), H.y2.contiguous()
    Ey, Ey2 = (E.y.contiguous(), E.y2.contiguous()) if E is not None else (None, None)
    assert recfast_host.recfast_history_host_inj(
        rp.data_ptr(), Hy.data_ptr(), Hy2.data_ptr(), H.x0, H.dx, H.n,
        None if E is None else Ey.data_ptr(), None if E is None else Ey2.data_ptr(),
        E.x0 if E else 0.0, E.dx if E else 0.0, E.n if E else 0, Nz, out.data_ptr()) == 0
    got = got.numpy()
    rel = np.abs(out.numpy() - got) / np.abs(got).clip(1e-300)
    assert rel.max() <= HOST_TOL


# --- the reionization schemes -----------------------------------------------

SCHEMES = {
    "reio_camb": dict(tau_reio=0.05430842),
    "reio_half_tanh": dict(z_reio=7.0, reio_parametrization="reio_half_tanh"),
    "reio_bins_tanh": dict(reio_parametrization="reio_bins_tanh", binned_reio_z=(8.0, 12.0, 16.0),
                           binned_reio_xe=(0.8, 0.2, 0.1), binned_reio_step_sharpness=0.3),
    "reio_many_tanh": dict(reio_parametrization="reio_many_tanh", many_tanh_z=(3.5, 8.0),
                           many_tanh_xe=(-2.0, -1.0), many_tanh_width=0.5),
    "reio_inter": dict(reio_parametrization="reio_inter", reio_inter_z=(0.0, 3.0, 9.5, 28.0),
                       reio_inter_xe=(-2.0, -2.0, 0.16, 0.0)),
    "reio_none": dict(reio_parametrization="reio_none"),
}


@pytest.mark.parametrize("scheme", sorted(SCHEMES))
def test_reionization_scheme_matches_jax(scheme, monkeypatch):
    kw = dict(SCHEMES[scheme])
    if "tau_reio" in kw:
        kw["z_reio"] = None
    pj, pt = _params(**kw)
    assert interop.cosmo_params(dataclasses.asdict(pj)) == pt
    (bgj, bij), (bgt, bit) = _jax_background(pj)
    thj = jth._compute_thermodynamics_impl(pj, JPrec(**SMALL), bgj, bij)
    reco = jth.compute_recombination(pj, JPrec(**SMALL),
                                     jth.make_recfast_ctx(pj, JPrec(**SMALL), bgj, bij))
    moved = tth.RecoTable(*(torch.as_tensor(np.array(getattr(reco, n)))
                            for n in tth.RecoTable._fields))
    monkeypatch.setattr(tth, "_recombination", lambda *a: moved)
    tht = tth.compute_thermodynamics(pt, TPrec(**SMALL), bgt, bit, device="cpu")
    assert tht.tau_reio == pytest.approx(float(thj.tau_reio), rel=1e-10)
    assert tht.z_reio == pytest.approx(float(thj.z_reio), rel=1e-10)
    for name in ("z_grid", "xe_of_z", "Tb_of_z", "cb2_of_z"):
        a, b = getattr(tht, name).numpy(), np.asarray(getattr(thj, name))
        assert a.shape == b.shape, name
        bad = np.abs(a - b) > 1e-10 * np.abs(b)
        assert not bad.any(), (name, b[bad][:3], a[bad][:3])
    if scheme == "reio_half_tanh":
        assert abs(float(tht.xe_of_z[0]) - 1.0) < 5e-2      # He neglected
    if scheme == "reio_inter":
        assert float(tht.xe_of_z[0]) == pytest.approx(1.0 + 2.0 * tht.fHe, rel=1e-3)


def test_bad_reionization_inputs_raise():
    base = dict(COSMO, output="tCl", l_max_scalars=100)
    c = T.Class(device="cpu")
    with pytest.raises(T.CosmoSevereError):
        c.set(dict(base, reio_parametrization="reio_nonsense"))
        c.compute(["thermodynamics"])
    c2 = T.Class(device="cpu")
    with pytest.raises(T.CosmoSevereError):
        c2.set(dict(base, reio_parametrization="reio_bins_tanh", binned_reio_num=7,
                    binned_reio_z="8,12,16", binned_reio_xe="0.8,0.2,0.1"))
        c2.compute(["thermodynamics"])


@pytest.mark.parametrize("name", ["g5_hyrec", "g16_injection", "g22_injection_bos",
                                  "g11a_reio_bins", "g11b_reio_manytanh", "hyrec_full"])
def test_configurations_parse_as_in_jax(name):
    from classpp_public_torch.tools.configs import CONFIGS, THERMO_ONLY

    cfg = {**CONFIGS, **THERMO_ONLY}[name]
    ct, cj = T.Class(device="cpu"), J.Class()
    ct.set(dict(cfg))
    cj.set(dict(cfg))
    want = dataclasses.asdict(cj.cosmo.params)
    got = dataclasses.asdict(ct.cosmo.params)
    for k, v in got.items():
        assert v == want[k] or (isinstance(v, float) and v == pytest.approx(want[k], rel=1e-12)), k


# --- end to end ---------------------------------------------------------------


def _jax_thermo(th):
    """A port ThermoResult as the JAX package's (to seed its Cosmology)."""
    import jax.numpy as jnp
    from classpp_public_tpu.ops.splines import UniformSpline as JSpline

    kw = {}
    for k in jth.ThermoResult._fields:
        v = getattr(th, k)
        if k == "lntau_spline":
            kw[k] = JSpline(jnp.asarray(v.x0), jnp.asarray(v.dx), jnp.asarray(v.y.cpu().numpy()),
                            jnp.asarray(v.y2.cpu().numpy()))
        else:
            kw[k] = jnp.asarray(v.cpu().numpy() if isinstance(v, torch.Tensor) else v)
    return jth.ThermoResult(**kw)


@pytest.fixture(scope="module")
def hyrec_point():
    """A g5_hyrec-like point (unlensed TT/EE/TE to l = 100): the port's
    Class(device="cpu") from the JAX background, computing its HyRec
    thermodynamics and spectra; the JAX thermodynamics of the same point; and
    the JAX Class's spectra from the port's thermodynamics."""
    params = dict(COSMO, tau_reio=0.05430842, recombination="HyRec", output="tCl,pCl",
                  l_max_scalars=100, perturb_sampling_stepsize=2.0,
                  tol_perturb_integration=1e-4, **SMALL)
    cj = J.Class()
    cj.set(dict(params))
    bg, bidx = cj.cosmo.background
    thj = jth.compute_thermodynamics(cj.cosmo.params, cj.cosmo.pr, bg, bidx)
    ct = T.Class(device="cpu")
    ct.set(dict(params))
    ct.cosmo.set_stage("background", interop.background(asdict(bg), "cpu", names=bidx.names))
    ct.compute(["spectra"])
    cj.cosmo._cache["th"] = _jax_thermo(ct.cosmo.thermodynamics)
    cj.compute(["spectra"])
    return cj, ct, thj


def test_hyrec_point_thermodynamics_matches_jax(hyrec_point):
    _, ct, thj = hyrec_point
    tht = ct.cosmo.thermodynamics
    for f in ("YHe", "z_reio", "tau_reio", "z_rec", "tau_rec", "rs_rec", "z_star", "rs_star",
              "z_d", "rs_d"):
        assert getattr(tht, f) == pytest.approx(float(getattr(thj, f)), rel=1e-8), f
    # c_b^2 carries dT_m/dlna, whose Compton term is (T_r - T_m) times a rate
    # that keeps T_m within ~1e-8 of T_r at z > 5000: the cancellation takes
    # the last bits of T_m to ~2e-8 of c_b^2 there
    for name, tol in (("z_grid", 1e-8), ("xe_of_z", 1e-8), ("Tb_of_z", 1e-8), ("cb2_of_z", 1e-7)):
        a, b = getattr(tht, name).numpy(), np.asarray(getattr(thj, name))
        bad = np.abs(a - b) > tol * np.abs(b)
        assert not bad.any(), (name, tht.z_grid.numpy()[bad][:3])


def test_hyrec_point_spectra_match_jax(hyrec_point):
    cj, ct, _ = hyrec_point
    a, b = ct.raw_cl(100), cj.raw_cl(100)
    for name in ("tt", "ee", "te"):
        den = np.sqrt(np.abs(b["tt"] * b["ee"]))[2:] if name == "te" else np.abs(b[name][2:])
        rel = np.max(np.abs(a[name][2:] - b[name][2:]) / den)
        assert rel <= 1e-3, (name, rel)

"""classpp_public_torch background and thermodynamics against
classpp_public_tpu at the reduced precision of __graft_entry__._small_setup
(background_Nloga = 1024, recfast_Nz0 = 4000), default cosmology (CPU).

Tolerances: background columns 1e-12 relative (closed forms and spline
integrals in float64; only the tridiagonal algorithm differs); the
thermodynamics table 1e-6 of each column's scale: RECFAST is a stiff
20 000-step scalar march and the two implementations round exp/pow
differently (XLA vs libm), which the stiff system amplifies to ~5e-8 in
x_e. Derived scalars to 1e-8 relative. The ncdm momentum data (nodes,
weights, dln f0/dln q, the Fermi-Dirac integrals) and the ncdm columns of the
table with one 0.06 eV species: 1e-12 relative (the same closed forms and
numpy quadrature rules on both sides).

The RECFAST history and the Tb march, the two loops that run as the kernels
of csrc/recfast.cu on a card, are held column by column: the plain loops
against the JAX `compute_recombination` and `_tb_march_impl` (1e-10
relative; in the HeI recombination rows, 1 < x_e < 1 + fHe, where H is in
Saha equilibrium and the stiff He equation is integrated, the explicit RK4
takes XLA's and libm's last bits to 4.9e-8 of x_e, so those rows are held to
1e-7), and the host build of the kernels' code (csrc/recfast.cuh) against
the plain loops (1e-12 relative; measured 6e-15).
"""

import ctypes
import shutil
import subprocess
from pathlib import Path

import numpy as np
import pytest
import torch

from classpp_public_torch.config.params import CosmoParams as TParams
from classpp_public_torch.config.precision import PrecisionParams as TPrec
from classpp_public_torch.models import background as tbg
from classpp_public_torch.models import thermodynamics as tth
from classpp_public_tpu import CosmoParams as JParams
from classpp_public_tpu import PrecisionParams as JPrec
from classpp_public_tpu.models import background as jbg
from classpp_public_tpu.models import thermodynamics as jth
from classpp_public_torch.ops import cuda
from test_torch_common import one_torch_thread  # noqa: F401

SMALL = dict(background_Nloga=1024, recfast_Nz0=4000)


@pytest.fixture(scope="module")
def stages():
    bgj, bij = jbg.compute_background(JParams(), JPrec(**SMALL))
    thj = jth.compute_thermodynamics(JParams(), JPrec(**SMALL), bgj, bij)
    bgt, bit = tbg.compute_background(TParams(), TPrec(**SMALL), device="cpu")
    tht = tth.compute_thermodynamics(TParams(), TPrec(**SMALL), bgt, bit, device="cpu")
    return (bgj, bij, thj), (bgt, bit, tht)


def test_background_table(stages):
    (bgj, bij, _), (bgt, bit, _) = stages
    for i, name in enumerate(bit.names):
        a = np.asarray(bgj.table[:, bij[name]])
        b = bgt.table[:, i].numpy()
        assert np.max(np.abs(a - b)) <= 1e-12 * np.max(np.abs(a)), name
    ya = np.asarray(bgj.lntau_spline.y)[:, [bij[n] for n in bit.names]]
    assert np.max(np.abs(ya - bgt.lntau_spline.y.numpy()) / np.max(np.abs(ya), axis=0)) < 1e-11
    assert bgt.lntau_spline.x0 == pytest.approx(float(bgj.lntau_spline.x0), rel=1e-14)
    for f in ("tau0", "age", "z_eq", "tau_eq", "Omega0_m", "Omega0_r", "Omega0_lambda"):
        assert getattr(bgt, f) == pytest.approx(float(getattr(bgj, f)), rel=1e-12), f
    z = torch.tensor([0.0, 0.5, 3.0, 1100.0], dtype=torch.float64)
    assert np.allclose(tbg.tau_of_z(bgt, z).numpy(),
                       np.asarray(jbg.tau_of_z(bgj, np.asarray(z))), rtol=1e-12)


def test_thermodynamics_table(stages):
    (_, _, thj), (_, _, tht) = stages
    ya, yb = np.asarray(thj.lntau_spline.y), tht.lntau_spline.y.numpy()
    assert ya.shape == yb.shape
    for i, name in enumerate(tth.ThIdx.names[:12]):
        tol = 1e-4 if name in ("dddkappa", "ddg") else 1e-6   # two spline derivatives deep
        scale = np.max(np.abs(ya[:, i]))
        assert np.max(np.abs(ya[:, i] - yb[:, i])) <= tol * scale, name


def test_thermodynamics_scalars(stages):
    (_, _, thj), (_, _, tht) = stages
    for f in ("YHe", "fHe", "z_reio", "tau_reio", "z_rec", "tau_rec", "rs_rec", "z_star",
              "tau_star", "rs_star", "ra_star", "z_d", "tau_d", "rs_d", "tau_cut", "rd_rec",
              "rd_star", "n_e", "angular_rescaling"):
        assert getattr(tht, f) == pytest.approx(float(getattr(thj, f)), rel=1e-8), f


def test_tau_reio_shooting():
    """tau_reio pinned (z_reio shot for), as in the Planck configurations."""
    kw = dict(tau_reio=0.0544, z_reio=None)
    bgj, bij = jbg.compute_background(JParams(**kw), JPrec(**SMALL))
    thj = jth.compute_thermodynamics(JParams(**kw), JPrec(**SMALL), bgj, bij)
    bgt, bit = tbg.compute_background(TParams(**kw), TPrec(**SMALL), device="cpu")
    tht = tth.compute_thermodynamics(TParams(**kw), TPrec(**SMALL), bgt, bit, device="cpu")
    assert tht.z_reio == pytest.approx(float(thj.z_reio), rel=1e-8)
    assert tht.tau_reio == pytest.approx(0.0544, rel=1e-4)
    assert tht.tau_reio == pytest.approx(float(thj.tau_reio), rel=1e-8)


NCDM = dict(m_ncdm=(0.06,), N_ur=2.0328)


def test_ncdm_momenta():
    x = np.concatenate([[0.0], np.geomspace(1e-6, 1e4, 40)])
    got = tbg.ncdm_momenta(torch.as_tensor(x))
    ref = jbg.ncdm_momenta(x)
    for a, b in zip(got, ref):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-12)
    # massless limit: I_rho = 3 I_p = 1 up to the 128-node trapezoid rule (3e-6)
    assert float(got[0][0]) == pytest.approx(1.0, abs=1e-5)
    assert 3.0 * float(got[1][0]) == pytest.approx(1.0, abs=1e-5)


@pytest.mark.parametrize("nq,gauss", [(16, True), (128, False)])
def test_ncdm_psd_weights(nq, gauss):
    pt, pj = TParams(**NCDM), JParams(**NCDM)
    for a, b in zip(tbg.ncdm_psd_weights(pt, nq, gauss=gauss),
                    jbg.ncdm_psd_weights(pj, nq, gauss=gauss)):
        assert a.shape == b.shape
        np.testing.assert_allclose(a, b, rtol=1e-12, atol=1e-300)


def test_ncdm_q_rule():
    assert tbg.ncdm_q_rule(TParams(**NCDM), TPrec()) == jbg.ncdm_q_rule(JParams(**NCDM), JPrec())
    assert tbg.ncdm_q_rule(TParams()) == jbg.ncdm_q_rule(JParams())


def test_ncdm_background_columns():
    bgj, bij = jbg.compute_background(JParams(**NCDM), JPrec(**SMALL))
    bgt, bit = tbg.compute_background(TParams(**NCDM), TPrec(**SMALL), device="cpu")
    assert bit.names == bij.names and bit.key == bij.key
    for name in bit.names:
        a = np.asarray(bgj.table[:, bij[name]])
        b = bgt.table[:, bit[name]].numpy()
        assert np.max(np.abs(a - b)) <= 1e-12 * np.max(np.abs(a)), name
    assert bgt.Omega0_ncdm_tot == pytest.approx(float(bgj.Omega0_ncdm_tot), rel=1e-12)
    assert bgt.rho_ncdm0 == pytest.approx(np.asarray(bgj.rho_ncdm0), rel=1e-12)
    assert bgt.Omega0_m == pytest.approx(float(bgj.Omega0_m), rel=1e-12)
    assert TParams(**NCDM).N_eff == pytest.approx(JParams(**NCDM).N_eff, rel=1e-14)


def test_unported_physics_raises():
    with pytest.raises(NotImplementedError, match="ncdm"):
        tbg.compute_background(TParams(m_ncdm=(0.06,), ksi_ncdm=(0.1,)), TPrec(**SMALL),
                               device="cpu")
    with pytest.raises(NotImplementedError, match="decaying ncdm"):
        tbg.compute_background(TParams(m_ncdm=(0.06,), N_ncdm_decay_dr=1), TPrec(**SMALL),
                               device="cpu")
    with pytest.raises(NotImplementedError, match="fluid"):
        tbg.compute_background(TParams(use_fld=True), TPrec(**SMALL), device="cpu")


@pytest.fixture(scope="module")
def recfast_host(tmp_path_factory):
    """csrc/recfast_host.cpp built with g++ (None without g++)."""
    gxx = shutil.which("g++")
    if gxx is None:
        return None
    so = tmp_path_factory.mktemp("recfast") / "librecfast_host.so"
    subprocess.run([gxx, "-O2", "-std=c++17", "-shared", "-fPIC", "-o", str(so),
                    str(Path(cuda.CSRC_DIR) / "recfast_host.cpp")], check=True)
    lib = ctypes.CDLL(str(so))
    P, I, D = ctypes.c_void_p, ctypes.c_int, ctypes.c_double
    lib.recfast_history_host.argtypes = [P, P, P, D, D, I, I, P]
    lib.tb_march_host.argtypes = [P, P, P, P, P, P, I, D, I, P, P]
    return lib


@pytest.fixture(scope="module")
def recfast_tables(stages):
    """The RECFAST history of the JAX package and the port's plain loop, with
    the port's inputs (RF_PARAMS vector and H spline)."""
    (bgj, bij, _), (bgt, bit, _) = stages
    ctxj = jth.make_recfast_ctx(JParams(), JPrec(**SMALL), bgj, bij)
    ref = jth.compute_recombination(JParams(), JPrec(**SMALL), ctxj)
    ctxt = tth.make_recfast_ctx(TParams(), TPrec(**SMALL), bgt, bit)
    rp = tth.recfast_params(ctxt, TPrec(**SMALL))
    got = tth.recfast_history(rp, ctxt.H_of_z, SMALL["recfast_Nz0"])
    ref = np.stack([np.asarray(getattr(ref, n)) for n in tth.RECO_COLUMNS])
    return ref, got.numpy(), rp, ctxt


def test_recfast_history_plain_matches_jax(recfast_tables):
    ref, got, _, ctx = recfast_tables
    assert got.shape == ref.shape == (6, SMALL["recfast_Nz0"])
    xe = ref[1]
    he_rows = (xe > 1.0) & (xe < 1.0 + ctx.fHe)
    assert 0 < he_rows.sum() < 0.5 * len(xe)
    for i, name in enumerate(tth.RECO_COLUMNS):
        rel = np.abs(got[i] - ref[i]) / np.abs(ref[i]).clip(1e-300)
        assert rel[~he_rows].max() <= 1e-10, name
        assert rel[he_rows].max() <= 1e-7, name


def test_recfast_kernel_code_on_host(recfast_tables, recfast_host):
    """csrc/recfast.cuh built for the host against the plain loop."""
    if recfast_host is None:
        pytest.skip("no g++ to build the host version of the RECFAST kernel's code")
    _, got, rp, ctx = recfast_tables
    assert recfast_host.recfast_n_params() == len(tth.RF_PARAMS)
    H = ctx.H_of_z
    Hy, Hy2 = H.y.contiguous(), H.y2.contiguous()
    Nz = SMALL["recfast_Nz0"]
    out = torch.empty((6, Nz), dtype=torch.float64)
    assert recfast_host.recfast_history_host(rp.data_ptr(), Hy.data_ptr(), Hy2.data_ptr(),
                                             H.x0, H.dx, H.n, Nz, out.data_ptr()) == 0
    for i, name in enumerate(tth.RECO_COLUMNS):
        rel = np.abs(out[i].numpy() - got[i]) / np.abs(got[i]).clip(1e-300)
        assert rel.max() <= 1e-12, name


def test_tb_march_matches_jax(stages, recfast_host):
    """The backward-Euler Tb march on seeded reionization inputs: the plain
    loop against the JAX `_tb_march_impl` and the host build of the kernel's
    code (1e-12 relative, dTb/dz 1e-12 of its scale)."""
    import jax.numpy as jnp

    (_, _, _), (bgt, bit, _) = stages
    rng = np.random.default_rng(4)
    n = 4096
    z = np.linspace(0.0, 50.0, n)
    xe = 1.08 / (1.0 + np.exp((z - 8.0) / 0.7)) + 2e-4 + 1e-5 * rng.uniform(size=n)
    H = 2.2e-4 * np.sqrt(0.31 * (1.0 + z) ** 3 + 0.69)
    rho_g = 1.2e-12 * (1.0 + z) ** 4
    rho_b = 1.1e-9 * (1.0 + z) ** 3
    consts = (2.3e-7, 0.2454, 2.7255, tth.const.m_H, tth.const.m_e, tth.const.not4)
    Tb_start, idx_start = 2.7255 * 51.0 * 0.4, 3500
    ref = jth._tb_march_impl(*(jnp.asarray(a) for a in (z, xe, H, rho_g, rho_b)), Tb_start,
                             idx_start, *consts[:3])
    cols = [torch.as_tensor(a) for a in (z, xe, H, rho_g, rho_b)]
    got = tth.tb_march(*cols, consts, Tb_start, idx_start)
    assert tth.const.m_H == jth.const.m_H and tth.const.not4 == jth.const.not4
    for a, b in zip(got, ref):   # dTb/dz is a difference of two terms: held to its scale
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-12,
                                   atol=1e-12 * np.abs(np.asarray(b)).max())
    if recfast_host is not None:
        Tb, d = torch.empty(n, dtype=torch.float64), torch.empty(n, dtype=torch.float64)
        cbuf = (ctypes.c_double * 6)(*consts)
        assert recfast_host.tb_march_host(*(c.data_ptr() for c in cols), cbuf, n, Tb_start,
                                          idx_start, Tb.data_ptr(), d.data_ptr()) == 0
        for a, b in zip((Tb, d), got):
            np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=1e-12,
                                       atol=1e-12 * b.abs().max().item())


def test_recfast_wrappers_take_the_plain_version_only_on_the_cpu(recfast_tables):
    _, _, rp, ctx = recfast_tables
    before = tth.recfast_launches, tth.tb_march_launches
    with pytest.raises(ValueError, match="unsupported device"):
        tth.recfast_history(rp.to("meta"), ctx.H_of_z, 10)
    z = torch.zeros(8, dtype=torch.float64, device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        tth.tb_march(z, z, z, z, z, (1.0,) * 6, 1.0, 4)
    assert (tth.recfast_launches, tth.tb_march_launches) == before


def test_bbn_table_is_the_ports_own_copy():
    assert tth.DATA_DIR == Path(tth.__file__).resolve().parents[1] / "data"
    assert (tth.DATA_DIR / TPrec().sBBN_file).is_file()
    assert tth.helium_from_bbn(0.0224, 3.046) == pytest.approx(
        jth.helium_from_bbn_np(0.0224, 3.046), rel=1e-14)

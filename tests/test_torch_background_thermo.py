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
"""

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
    with pytest.raises(NotImplementedError, match="HyRec"):
        tbg.compute_background(TParams(recombination="hyrec"), TPrec(**SMALL), device="cpu")

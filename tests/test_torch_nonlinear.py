"""classpp_public_torch halofit against classpp_public_tpu on shared inputs
(CPU, where the port runs the plain version of its Gaussian-window sums).

Inputs are made with numpy from a seed and handed to both sides: a smooth
BBKS-like linear spectrum for the sums and the one-redshift fit, and for the
whole stage a hand-made PerturbResult (36 k modes to 5/Mpc, 48 tau samples,
delta_m and delta_cb columns = transfer function x growth) on the JAX
background of a cosmology with one 0.06 eV neutrino, so that f_nu > 0 and the
cb spectrum differs from the total.

Tolerance 1e-8 relative on P_nl, k_nl and sigma8 (measured ~1e-12: both are
float64 and differ in the order of the trapezoid sums and in exp/log/pow last
bits; the sigma(R) = 1 root is polished by two Newton steps on both sides).
"""

import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from classpp_public_torch import interop
from classpp_public_torch.models import nonlinear as tnl
from classpp_public_torch.models.perturbations.indices import SrcIdx
from classpp_public_torch.models.primordial import compute_primordial as t_primordial
from classpp_public_tpu import CosmoParams, PrecisionParams
from classpp_public_tpu.models import background as jbg
from classpp_public_tpu.models import nonlinear as jnl
from classpp_public_tpu.models.perturbations.solve import PerturbResult as JPert
from classpp_public_tpu.models.primordial import compute_primordial as j_primordial
from test_torch_common import asdict, one_torch_thread  # noqa: F401

RTOL = 1e-8
H = 0.67556


def t64(a):
    return torch.as_tensor(np.asarray(a), dtype=torch.float64)


def bbks_pk(k, amp=2.0e4):
    """A smooth LambdaCDM-like linear P(k) [Mpc^3] (BBKS transfer function)."""
    q = k / (0.14 * H)
    T = np.log(1.0 + 2.34 * q) / (2.34 * q) * (
        1.0 + 3.89 * q + (16.1 * q) ** 2 + (5.46 * q) ** 3 + (6.71 * q) ** 4) ** -0.25
    return amp * (k / 0.02) ** 0.96 * T**2 / T[np.argmin(np.abs(k - 0.02))] ** 2


@pytest.fixture(scope="module")
def spectrum():
    rng = np.random.default_rng(5)
    k_hf = 1e-4 * 10.0 ** (np.arange(int(math.log10(5e4) * 80) + 1) / 80.0)
    pk = bbks_pk(k_hf) * (1.0 + 0.02 * rng.standard_normal())
    return k_hf, pk


def test_halofit_sums_plain_match_jax(spectrum):
    """(s1, s2, s3) on 3 redshifts x 160 radii against the JAX trapezoids
    (nonlinear.py:119-133), 1e-12 relative."""
    k_hf, pk = spectrum
    growth = np.array([1.0, 0.6, 0.25])
    base = growth[:, None] ** 2 * (pk * k_hf**2 / (2.0 * math.pi**2))[None, :]
    R = np.broadcast_to(10.0 ** np.linspace(-2.0, 2.0, 160), (3, 160)).copy()
    got = tnl.halofit_sums(t64(base), t64(k_hf), t64(R)).numpy()
    assert got.shape == (3, 160, 3)
    kj, lnk = jnp.asarray(k_hf), jnp.log(jnp.asarray(k_hf))
    for iz in range(3):
        b = jnp.asarray(base[iz])
        x2 = (kj[None, :] * jnp.asarray(R[iz])[:, None]) ** 2
        g = jnp.exp(-x2)
        ref = [jnp.trapezoid(b * g * kj, lnk, axis=-1),
               jnp.trapezoid(b * 2.0 * x2 * g * kj, lnk, axis=-1),
               jnp.trapezoid(b * 4.0 * x2 * (1.0 - x2) * g * kj, lnk, axis=-1)]
        for j in range(3):
            r = np.asarray(ref[j])
            assert np.max(np.abs(got[iz, :, j] - r)) <= 1e-12 * np.max(np.abs(r)), (iz, j)
    assert tnl.launches == 0


@pytest.mark.parametrize("fnu,growth", [(0.0, 1.0), (0.0045, 0.8)])
def test_halofit_one_z_matches_jax(spectrum, fnu, growth):
    k_hf, pk = spectrum
    pk = pk * growth**2
    k_out = np.geomspace(2e-4, 4.0, 57)
    pk_out = np.exp(np.interp(np.log(k_out), np.log(k_hf), np.log(pk)))
    args = (0.31 / (0.31 + 0.69 * growth**3), 0.69 * growth**3 / (0.31 + 0.69 * growth**3),
            -1.0, fnu, 0.31, H, 1e-4)
    pj, kj = jnl._halofit_one_z(jnp.asarray(k_hf), jnp.asarray(pk), jnp.asarray(k_out),
                                jnp.asarray(pk_out), *args)
    pt, kt = tnl._halofit_one_z(t64(k_hf), t64(pk), t64(k_out), t64(pk_out), *args)
    np.testing.assert_allclose(pt.numpy(), np.asarray(pj), rtol=RTOL)
    assert float(kt) == pytest.approx(float(kj), rel=RTOL)
    assert np.isfinite(pt.numpy()).all()
    assert np.max(pt.numpy() / pk_out) > 2.0     # the fit did boost small scales


@pytest.fixture(scope="module")
def stage_inputs():
    params = CosmoParams(m_ncdm=(0.06,), N_ur=2.0328)
    pr = PrecisionParams(background_Nloga=1024)
    bg, bidx = jbg.compute_background(params, pr)
    rng = np.random.default_rng(9)
    k = np.geomspace(1e-4, 5.0, 36)
    tau0 = float(bg.tau0)
    tau = np.linspace(0.02 * tau0, tau0, 48)
    a_tau = np.exp(np.interp(tau, np.asarray(bg.tau_of_loga), np.asarray(bg.loga)))
    growth = a_tau / a_tau[-1]
    pm = j_primordial(params)
    T = np.sqrt(bbks_pk(k) / (2.0 * math.pi**2 / k**3 * np.asarray(pm.scalar_pk(jnp.asarray(k)))))
    src = np.zeros((len(k), len(tau), SrcIdx.n))
    src[:, :, SrcIdx.ix["delta_m"]] = -T[:, None] * growth[None, :] \
        * (1.0 + 0.01 * rng.standard_normal((len(k), 1)))
    src[:, :, SrcIdx.ix["delta_cb"]] = src[:, :, SrcIdx.ix["delta_m"]] \
        * (1.0 + 0.004 * k / (k + 0.05))[:, None]
    pert = JPert(k=jnp.asarray(k), tau=jnp.asarray(tau), sources=jnp.asarray(src),
                 tau0=bg.tau0, k_size_cmb=len(k), stats_steps=jnp.zeros(len(k), jnp.int32),
                 k_np=k, tau_np=tau)
    return params, pr, bg, bidx, pm, pert


@pytest.mark.parametrize("z_pk", [(0.0,), (0.0, 0.5, 2.0, 7.0)])
def test_compute_nonlinear_matches_jax(stage_inputs, z_pk):
    import dataclasses

    params, pr, bg, bidx, pm, pert = stage_inputs
    ref = jnl.compute_nonlinear(pert, bg, bidx, pm, pr, params, z_pk=z_pk)
    tp = interop.cosmo_params(dataclasses.asdict(params))
    bgt, bit = interop.background(asdict(bg), "cpu", names=bidx.names)
    got = tnl.compute_nonlinear(interop.perturb(asdict(pert), "cpu"), bgt, bit, t_primordial(tp),
                                interop.precision_params(dataclasses.asdict(pr)), tp, z_pk=z_pk)
    want = interop.pk_result(asdict(ref), "cpu")
    for f in ("k", "z", "pk_lin", "pk_nl", "pk_cb_lin", "pk_cb_nl", "k_nl", "k_nl_cb"):
        np.testing.assert_allclose(getattr(got, f).numpy(), getattr(want, f).numpy(),
                                   rtol=RTOL, err_msg=f)
    assert got.sigma8 == pytest.approx(want.sigma8, rel=RTOL)
    assert got.pk_nl.shape == (len(z_pk), 36)
    assert not np.allclose(got.pk_cb_nl.numpy(), got.pk_nl.numpy(), rtol=1e-4)


def test_unported_methods_raise(stage_inputs):
    """The Pk_equal method is not ported (HMcode is, tests/test_torch_hmcode.py),
    and a method name neither halofit nor hmcode is refused."""
    import dataclasses

    params, pr, bg, bidx, pm, pert = stage_inputs
    tp = interop.cosmo_params(dataclasses.asdict(params))
    with pytest.raises(NotImplementedError, match="Pk_equal"):
        tnl.compute_nonlinear(None, None, None, None, None,
                              dataclasses.replace(tp, pk_eq=True, use_fld=True, wa_fld=0.1))
    with pytest.raises(ValueError, match="unknown non linear method"):
        tnl.compute_nonlinear(None, None, None, None, None, tp, method="bogus")

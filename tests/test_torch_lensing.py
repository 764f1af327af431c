"""The port's lensing (plain version of the CUDA kernel `lensing_wigner`)
against the JAX `_lensing_impl`, and the C_l quadrature against
`compute_spectra`, on identical seeded inputs at l <= 300 (fast and accurate
modes).

Tolerance 1e-10 of each column's scale: the same float64 recurrences and
sums, in another summation order. In the accurate mode BB is the small
difference 0.5 (ksi+ d22 - ksi- d2-2) of EE-sized terms, so its error is
measured against the EE scale.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from classpp_public_torch import interop
from classpp_public_torch.config.params import CosmoParams as TParams
from classpp_public_torch.config.precision import PrecisionParams as TPrec
from classpp_public_torch.models import lensing as tl
from classpp_public_torch.models import primordial as tpm
from classpp_public_torch.models import spectra as tsp
from classpp_public_torch.models import transfer as ttr
from classpp_public_tpu import CosmoParams as JParams
from classpp_public_tpu import PrecisionParams as JPrec
from classpp_public_tpu.models import lensing as jl
from classpp_public_tpu.models import primordial as jpm
from classpp_public_tpu.models import spectra as jsp
from classpp_public_tpu.models import transfer as jtr
from test_torch_common import one_torch_thread  # noqa: F401

TOL = 1e-10


def _t(a):
    return torch.as_tensor(np.asarray(a), dtype=torch.float64)


def _spectra(lmax, seed=0):
    """Smooth CMB-like unlensed C_l from l = 0 (rows 0, 1 zero), CT_TYPES order."""
    rng = np.random.default_rng(seed)
    l = np.arange(lmax + 1, dtype=np.float64)
    l[:2] = 1.0
    wob = 1.0 + 0.05 * rng.standard_normal(lmax + 1)
    cl = np.zeros((lmax + 1, 7))
    cl[:, 0] = 2e-9 / (l * (l + 1)) * np.exp(-(l / 900.0) ** 2) * wob
    cl[:, 1] = 0.02 * cl[:, 0] * (1.0 + np.sin(l / 40.0) ** 2)
    cl[:, 2] = 0.1 * cl[:, 0] * np.cos(l / 60.0)
    cl[:, 4] = 4e-8 / (l * (l + 1)) ** 2
    cl[:, 5] = 1e-2 * np.sqrt(cl[:, 0] * cl[:, 4])
    cl[:, 6] = 0.1 * cl[:, 5]
    cl[:2] = 0.0
    return cl


@pytest.mark.parametrize("accurate", [False, True])
def test_lensing_matches_jax(accurate):
    lmax, lout = 300, 250
    cl = _spectra(lmax)
    ref = np.asarray(jl._lensing_impl(jnp.asarray(cl), lmax, lout, accurate, 70))
    mu, w8 = tl.mu_grid(lmax, accurate, 70)
    got = tl.lensing_wigner_plain(_t(cl), _t(mu), _t(w8), lout, fast=not accurate).numpy()
    assert got.shape == ref.shape == (lout - 1, 7)
    for i, name in enumerate(tsp.CT_TYPES):
        scale = np.max(np.abs(ref[:, i if name != "bb" else tsp.CT_TYPES.index("ee")]))
        assert np.max(np.abs(got[:, i] - ref[:, i])) <= TOL * scale, name


def test_lensing_wrapper_on_cpu_is_the_plain_version():
    cl = _spectra(120, seed=3)
    mu, w8 = tl.mu_grid(120, False, 70)
    before = tl.launches
    a = tl.lensing_wigner(_t(cl), _t(mu), _t(w8), 100)
    b = tl.lensing_wigner_plain(_t(cl), _t(mu), _t(w8), 100)
    assert tl.launches == before
    assert torch.equal(a, b)


def test_lensing_wrapper_on_other_devices_raises():
    cl = _spectra(120, seed=3)
    mu, w8 = tl.mu_grid(120, False, 70)
    with pytest.raises(ValueError, match="unsupported device"):
        tl.lensing_wigner(_t(cl).to("meta"), _t(mu).to("meta"), _t(w8).to("meta"), 100)


def test_wigner_tables_match_jax():
    for m, mp in tl.PAIRS:
        B, S = tl.wigner_coeffs(m, mp, 50)
        Bj, Sj = jl._wigner_coeffs(m, mp, 50)
        np.testing.assert_array_equal(B, Bj)
        np.testing.assert_array_equal(S, Sj)
        mu = np.linspace(-0.9, 0.99, 7)
        np.testing.assert_allclose(tl.wigner_seed(m, mp, mu), jl._wigner_seed(m, mp, mu),
                                   rtol=1e-15)


def test_spectra_and_lensing_chain_match_jax():
    rng = np.random.default_rng(21)
    ls = ttr.get_l_list(TPrec(), 400)
    q = np.geomspace(2e-4, 0.07, 90)
    delta = rng.standard_normal((len(ls), 5, len(q))) * 1e-3
    trj = jtr.TransferResult(l=jnp.asarray(ls), q=jnp.asarray(q), delta=jnp.asarray(delta),
                             tau0=14000.0, k=jnp.asarray(q))
    trt = interop.transfer(dict(l=ls, q=q, delta=delta, tau0=14000.0, k=q), "cpu")
    pj = jpm.compute_primordial(JParams(A_s=2.1e-9, n_s=0.965))
    pt = tpm.compute_primordial(TParams(A_s=2.1e-9, n_s=0.965))
    spj = jsp.compute_spectra(trj, pj, l_max=400)
    spt = tsp.compute_spectra(trt, pt, l_max=400)
    np.testing.assert_allclose(tsp.cl_quad_weights(_t(q)).numpy(),
                               np.asarray(jsp.cl_quad_weights(jnp.asarray(q))), rtol=1e-11)
    a, b = spt.cl.numpy(), np.asarray(spj.cl)
    for i in (0, 1, 2, 4, 5, 6):
        assert np.max(np.abs(a[:, i] - b[:, i])) <= TOL * np.max(np.abs(b[:, i]))
    lj = np.asarray(jl.compute_lensing(spj, JPrec(), l_lensed_max=300).cl)
    lt = tl.compute_lensing(spt, TPrec(), l_lensed_max=300).cl.numpy()
    for i in range(7):
        assert np.max(np.abs(lt[:, i] - lj[:, i])) <= TOL * np.max(np.abs(lj[:, i])) + 1e-300

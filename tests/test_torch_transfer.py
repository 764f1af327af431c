"""The port's line-of-sight transfer stage (plain version of the CUDA kernel
`transfer_los`, plus the q-neglect masks and Limber rows) against the JAX
`_transfer_scan`, and the source weighting against `_weighted_sources`, on
identical seeded inputs at a small size (nq = 64, ntau = 80, l <= 300).

Tolerance 1e-6 of each transfer type's scale: both run the same float64
recurrence and differ in summation order and in the last bit of sin, cos,
lgamma, exp and the cube root (XLA vs libm; pow(x, 1/3) here). The upward
recurrence is unstable in the band x < l < x + 6 x^(1/3) + 2 that the
forbidden-region mask keeps, and amplifies those last-bit differences there
(measured 1.6e-7 of scale at l = 9); elsewhere the two agree to ~1e-13.
"""

import types

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from classpp_public_torch.config.precision import PrecisionParams as TPrec
from classpp_public_torch.models import transfer as tt
from classpp_public_tpu import PrecisionParams as JPrec
from classpp_public_tpu.models import transfer as jt
from test_torch_common import one_torch_thread  # noqa: F401

TOL = 1e-6


def _t(a):
    return torch.as_tensor(np.asarray(a), dtype=torch.float64)


@pytest.fixture(scope="module")
def inputs():
    rng = np.random.default_rng(42)
    ntau, nq = 80, 64
    tau0 = 14000.0
    taus = np.concatenate([np.geomspace(230.0, 13000.0, ntau - 1), [tau0]])
    q = np.geomspace(2e-4, 0.06, nq)
    env = np.exp(-((taus - 280.0) / 40.0) ** 2)[None, None, :] + 0.01
    Sq = rng.standard_normal((5, nq, ntau)) * env
    w = np.zeros(ntau)
    w[:-1] += np.diff(taus) / 2
    w[1:] += np.diff(taus) / 2
    W = Sq * w[None, None, :]
    ls = tt.get_l_list(TPrec(), 300)
    late_mask = rng.uniform(size=ntau) < 0.7
    return dict(W=W, Sq=Sq, taus=taus, tau0=tau0, q=q, ls=ls, late_mask=late_mask,
                l_late=100.0, ra_rec=tau0 - 280.0,
                neglect_dk=(0.15, 0.04, 0.15, 0.11), l_switch_limber=10.0)


def test_lists_match_jax():
    np.testing.assert_array_equal(tt.get_l_list(TPrec(), 3000), jt.get_l_list(JPrec(), 3000))
    np.testing.assert_array_equal(tt.get_l_list(TPrec(), 137), jt.get_l_list(JPrec(), 137))
    np.testing.assert_allclose(tt.get_q_list(TPrec(), 7e-6, 0.5, 14165.0, 280.0),
                               jt.get_q_list(JPrec(), 7e-6, 0.5, 14165.0, 280.0), rtol=1e-15)


def test_transfer_scan_matches_jax(inputs):
    d = inputs
    ls = d["ls"]
    emit_idx = np.full(ls[-1] + 1, -1, dtype=np.int32)
    emit_idx[ls] = np.arange(len(ls))
    ref = np.asarray(jt._transfer_scan(
        jnp.asarray(d["W"]), jnp.asarray(d["Sq"]), jnp.asarray(d["taus"]), d["tau0"],
        jnp.asarray(d["q"]), jnp.asarray(ls), jnp.asarray(emit_idx), int(ls[-1]), len(ls), 5,
        len(d["q"]), d["l_switch_limber"], d["neglect_dk"], d["l_late"],
        jnp.asarray(d["ra_rec"]), jnp.asarray(d["late_mask"])))
    got = tt.transfer_scan(_t(d["W"]), _t(d["Sq"]), _t(d["taus"]), d["tau0"], _t(d["q"]), ls,
                           d["l_late"], torch.as_tensor(d["late_mask"]), d["ra_rec"],
                           d["neglect_dk"], d["l_switch_limber"]).numpy()
    assert got.shape == ref.shape == (len(ls), 5, len(d["q"]))
    for i in range(5):
        scale = np.max(np.abs(ref[:, i]))
        assert scale > 0
        assert np.max(np.abs(got[:, i] - ref[:, i])) <= TOL * scale, tt.TT_TYPES[i]


def test_cpu_tensor_takes_the_plain_version(inputs):
    d = inputs
    before = tt.launches
    out = tt.transfer_los(_t(d["W"]), _t(d["taus"]), d["tau0"], _t(d["q"]), d["ls"],
                          d["l_late"], torch.as_tensor(d["late_mask"]))
    ref = tt.transfer_los_plain(_t(d["W"]), _t(d["taus"]), d["tau0"], _t(d["q"]), d["ls"],
                                d["l_late"], torch.as_tensor(d["late_mask"]))
    assert tt.launches == before
    assert torch.equal(out, ref)


def test_other_devices_never_take_the_plain_version(inputs):
    d = inputs
    with pytest.raises(ValueError, match="unsupported device"):
        tt.transfer_los(_t(d["W"]).to("meta"), _t(d["taus"]).to("meta"), d["tau0"],
                        _t(d["q"]).to("meta"), d["ls"], d["l_late"],
                        torch.as_tensor(d["late_mask"]).to("meta"))


def test_weighted_sources_match_jax():
    rng = np.random.default_rng(9)
    nk, ntau = 30, 80
    k = np.geomspace(1e-4, 0.1, nk)
    taus = np.concatenate([np.geomspace(230.0, 13000.0, ntau - 1), [14000.0]])
    S = rng.standard_normal((nk, ntau, 27))
    q = np.geomspace(1.1e-4, 0.08, 50)
    th = types.SimpleNamespace(tau_rec=280.0)
    pj = types.SimpleNamespace(tau=jnp.asarray(taus), tau0=14000.0, k=jnp.asarray(k),
                               sources=jnp.asarray(S), k_size_cmb=25)
    pt = types.SimpleNamespace(tau=_t(taus), tau0=14000.0, k=_t(k), sources=_t(S), k_size_cmb=25)
    Wj, Sqj, _ = jt._weighted_sources(pj, th, JPrec(), q)
    Wt, Sqt, _ = tt._weighted_sources(pt, th, _t(q))
    for a, b in ((Wt, Wj), (Sqt, Sqj)):
        b = np.asarray(b)
        assert np.max(np.abs(a.numpy() - b)) <= 1e-12 * np.max(np.abs(b))

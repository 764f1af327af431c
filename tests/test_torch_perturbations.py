"""classpp_public_torch perturbation integrator against the JAX solver
(`solve_one_k` vmapped, as __graft_entry__.entry runs it) on identical
inputs: the JAX background and thermodynamics tables moved across with
classpp_public_torch.interop, the JAX tau sampling and switch schedule, 8 k
modes from 1e-4 to 0.2/Mpc at rtol 1e-4 (the _small_setup precision).

Tolerance: 10 rtol of each source type's maximum. Both integrators take the
same adaptive steps up to round-off; a step decided differently at the
accept threshold would move a source by O(rtol).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from classpp_public_torch import interop
from classpp_public_torch.models.perturbations import equations as teq
from classpp_public_torch.models.perturbations import solve as tsolve
from classpp_public_torch.models.perturbations.indices import PtIdx as TIdx
from classpp_public_torch.models.perturbations.indices import SrcIdx
from classpp_public_tpu import CosmoParams, PrecisionParams
from classpp_public_tpu.models import background as jbg
from classpp_public_tpu.models import thermodynamics as jth
from classpp_public_tpu.models.perturbations import grids as jg
from classpp_public_tpu.models.perturbations import solve as jsolve
from classpp_public_tpu.models.perturbations.indices import PtIdx as JIdx
from test_torch_common import asdict, one_torch_thread  # noqa: F401

RTOL = 1e-4


@pytest.fixture(scope="module")
def setup():
    params = CosmoParams()
    pr = PrecisionParams(background_Nloga=1024, recfast_Nz0=4000, perturb_sampling_stepsize=1.0)
    bg, bidx = jbg.compute_background(params, pr)
    th = jth.compute_thermodynamics(params, pr, bg, bidx)
    taus = jg.get_tau_sampling(params, pr, bg, bidx, th)
    ks = np.geomspace(1e-4, 0.2, 8)
    sched = jg.get_k_schedule(ks, pr, bg, bidx, th, tau_first_sample=float(taus[0]))
    return params, pr, bg, bidx, th, taus, sched


@pytest.fixture(scope="module")
def jax_sources(setup):
    params, pr, bg, bidx, th, taus, sched = setup
    idx = JIdx(pr.l_max_g, pr.l_max_pol_g, pr.l_max_ur)

    def solve(k, ti, a, b, c, d):
        return jsolve.solve_one_k(k, ti, a, b, c, d, taus=jnp.asarray(taus),
                                  bg_spline=bg.lntau_spline, th_spline=th.lntau_spline,
                                  ncdm=None, bidx=bidx, idx=idx, rtol=RTOL)

    args = tuple(jnp.asarray(a) for a in (sched.k, sched.tau_ini, sched.tau_tca_off,
                                          sched.tau_ufa_on, sched.tau_rsa_on,
                                          sched.tau_ncdmfa_on))
    srcs, steps, _ = jax.jit(jax.vmap(solve))(*args)
    return np.asarray(srcs), np.asarray(steps)


@pytest.fixture(scope="module")
def torch_sources(setup):
    params, pr, bg, bidx, th, taus, sched = setup
    bgt, bit = interop.background(asdict(bg), "cpu", names=bidx.names)
    tht = interop.thermo(asdict(th), "cpu")
    tables = teq.make_tables(bgt, bit, tht, TIdx())

    def t(a):
        return torch.as_tensor(np.asarray(a), dtype=torch.float64)

    lanes = tsolve.Lanes(t(sched.k), t(sched.tau_ini), t(sched.tau_tca_off),
                         t(sched.tau_ufa_on), t(sched.tau_rsa_on))
    n = TIdx().size
    tol = (torch.full((len(sched.k), n), RTOL, dtype=torch.float64),
           torch.full((len(sched.k), n), 1e-11, dtype=torch.float64))
    S, steps = tsolve.integrate_sources(lanes, t(taus), tables, tol)
    return S.numpy(), steps.numpy()


def test_source_table_matches_jax(jax_sources, torch_sources):
    sj, nj = jax_sources
    st, nt = torch_sources
    assert st.shape == sj.shape == (8, sj.shape[1], SrcIdx.n)
    assert np.isfinite(st).all()
    for i, name in enumerate(SrcIdx.names):
        scale = np.max(np.abs(sj[:, :, i]))
        err = np.max(np.abs(st[:, :, i] - sj[:, :, i]))
        assert err <= 10 * RTOL * scale + 1e-300, (name, err / max(scale, 1e-300))
    assert np.all(np.abs(nt - nj) <= 0.02 * nj + 2), (nt, nj)


def test_state_layout_matches_jax():
    t, j = TIdx(), JIdx()
    for f in ("delta_g", "theta_g", "shear_g", "F_g", "n_F_g", "G_g", "n_G_g", "delta_b",
              "theta_b", "delta_cdm", "delta_ur", "theta_ur", "shear_ur", "F_ur", "n_F_ur",
              "eta", "size"):
        assert getattr(t, f) == getattr(j, f), f
    assert t.size == 46
    with pytest.raises(NotImplementedError):
        TIdx(n_ncdm=1)

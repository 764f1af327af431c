"""classpp_public_torch perturbation integrator against the JAX solver
(`solve_one_k` vmapped, as __graft_entry__.entry runs it) on identical
inputs: the JAX background and thermodynamics tables moved across with
classpp_public_torch.interop, the JAX tau sampling and switch schedule, 8 k
modes from 1e-4 to 0.2/Mpc at rtol 1e-4 (the _small_setup precision), without
and with one 0.06 eV massive-neutrino species (16 momenta x 18 multipoles,
state 46 -> 334; its modes stop at 0.1/Mpc), and with five species of 0.02 to
0.1 eV (state 1486; modes to 0.05/Mpc), whose frame buffer the kernel sizes
from the layout.

Tolerance: 10 rtol of each source type's maximum, step counts within 2%. Both
integrators take the same adaptive steps up to round-off; a step decided
differently at the accept threshold would move a source by O(rtol).

The per-lane program of the CUDA kernel (csrc/perturb_ark.cuh) also builds
for the host: where g++ is present it is held against the plain PyTorch
integrator on the same lanes (1e-9 of each column's maximum; measured 1e-13).
"""

import ctypes
import shutil
import subprocess
from pathlib import Path

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
from classpp_public_tpu.models.perturbations import equations as jeq
from classpp_public_tpu.models.perturbations import grids as jg
from classpp_public_tpu.models.perturbations import solve as jsolve
from classpp_public_tpu.models.perturbations.indices import PtIdx as JIdx
from test_torch_common import asdict, one_torch_thread  # noqa: F401

RTOL = 1e-4
PR = dict(background_Nloga=1024, recfast_Nz0=4000, perturb_sampling_stepsize=1.0)
CASES = {"lcdm": {}, "ncdm": dict(m_ncdm=(0.06,), N_ur=2.0328),
         "ncdm5": dict(m_ncdm=(0.02, 0.04, 0.06, 0.08, 0.1), N_ur=0.00641)}
# 1/Mpc; the wider states step slower here
K_MAX = {"lcdm": 0.2, "ncdm": 0.1, "ncdm5": 0.05}


def t64(a):
    return torch.as_tensor(np.asarray(a), dtype=torch.float64)


class Setup:
    """The JAX tables of one case and both packages' views of them."""

    def __init__(self, case):
        self.params = CosmoParams(**CASES[case])
        self.pr = pr = PrecisionParams(**PR)
        n = self.params.N_ncdm
        self.bg, self.bidx = jbg.compute_background(self.params, pr)
        self.th = jth.compute_thermodynamics(self.params, pr, self.bg, self.bidx)
        self.taus = jg.get_tau_sampling(self.params, pr, self.bg, self.bidx, self.th)
        ks = np.geomspace(1e-4, K_MAX[case], 8)
        self.sched = jg.get_k_schedule(ks, pr, self.bg, self.bidx, self.th,
                                       tau_first_sample=float(self.taus[0]), n_ncdm=n)
        self.jidx = JIdx(pr.l_max_g, pr.l_max_pol_g, pr.l_max_ur, n_ncdm=n)
        self.jncdm = jsolve.make_ncdm_ctx(self.params, self.bg, self.jidx, self.bidx) if n else None
        # the port's side
        self.tidx = TIdx(n_ncdm=n)
        bgt, bit = interop.background(asdict(self.bg), "cpu", names=self.bidx.names)
        tht = interop.thermo(asdict(self.th), "cpu")
        nct = interop.ncdm_ctx(asdict(self.jncdm), "cpu") if n else None
        self.tables = teq.make_tables(bgt, bit, tht, self.tidx, nct)
        s = self.sched
        t_ncfa = s.tau_ncdmfa_on if n else np.full_like(ks, np.inf)
        self.lanes = tsolve.Lanes(t64(s.k), t64(s.tau_ini), t64(s.tau_tca_off),
                                  t64(s.tau_ufa_on), t64(s.tau_rsa_on), t64(t_ncfa))
        self.tol = (torch.full((len(ks), self.tidx.size), RTOL, dtype=torch.float64),
                    torch.full((len(ks), self.tidx.size), 1e-11, dtype=torch.float64))

    def jax_ctx(self, i, tau):
        s = self.sched
        return jeq.PertCtx(
            k=jnp.asarray(s.k[i]), tca_on=jnp.asarray(tau < s.tau_tca_off[i]),
            rsa_on=jnp.asarray(tau >= s.tau_rsa_on[i]), ufa_on=jnp.asarray(tau >= s.tau_ufa_on[i]),
            bg_spline=self.bg.lntau_spline, th_spline=self.th.lntau_spline, bidx=self.bidx,
            idx=self.jidx, ncdmfa_on=jnp.asarray(tau >= s.tau_ncdmfa_on[i]), ncdm=self.jncdm,
            eta_off=jnp.asarray(float(s.k[i] < jsolve.K_ETA_SPLIT)))


@pytest.fixture(scope="module", params=list(CASES))
def setup(request):
    return Setup(request.param)


@pytest.fixture(scope="module")
def jax_sources(setup):
    s, taus = setup.sched, setup.taus

    def solve(k, ti, a, b, c, d):
        return jsolve.solve_one_k(k, ti, a, b, c, d, taus=jnp.asarray(taus),
                                  bg_spline=setup.bg.lntau_spline,
                                  th_spline=setup.th.lntau_spline, ncdm=setup.jncdm,
                                  bidx=setup.bidx, idx=setup.jidx, rtol=RTOL)

    args = tuple(jnp.asarray(a) for a in (s.k, s.tau_ini, s.tau_tca_off, s.tau_ufa_on,
                                          s.tau_rsa_on, s.tau_ncdmfa_on))
    srcs, steps, _ = jax.jit(jax.vmap(solve))(*args)
    return np.asarray(srcs), np.asarray(steps)


@pytest.fixture(scope="module")
def torch_sources(setup):
    S, steps = tsolve.integrate_sources(setup.lanes, t64(setup.taus), setup.tables, setup.tol)
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


def _random_states(setup, taus_at):
    """A random state per lane (seeded numpy) on both sides: the adiabatic
    state at taus_at scaled by (1 + 0.3 N(0, 1)) plus small noise in the empty
    slots, so every term of the right-hand side is exercised."""
    rng = np.random.default_rng(11)
    ctx = tsolve._ctx(setup.lanes, t64(taus_at), tsolve._eta_off(setup.lanes.k), setup.tables)
    y0 = teq.adiabatic_ic(teq.frame_at(t64(taus_at), setup.tables), ctx).numpy()
    scale = np.abs(y0).max(axis=1, keepdims=True)
    return y0 * (1.0 + 0.3 * rng.standard_normal(y0.shape)) \
        + 1e-3 * scale * rng.standard_normal(y0.shape), ctx


@pytest.mark.parametrize("when", ["early", "late"])
def test_rhs_matches_jax(setup, when):
    """dy/dtau and the stiff split on a random state, per lane, to 1e-11 of
    the largest |dy| of the lane: `early` has every approximation but TCA off
    (full hierarchies), `late` has UFA, RSA and the ncdm fluid on where the
    lane reaches them before today."""
    s = setup.sched
    taus_at = 0.5 * (s.tau_tca_off + np.minimum(s.tau_ufa_on, s.tau_tca_off * 3)) \
        if when == "early" else np.minimum(np.maximum(s.tau_rsa_on, s.tau_ncdmfa_on) * 1.5,
                                           0.9 * float(setup.bg.tau0))
    y, ctx = _random_states(setup, taus_at)
    fr = teq.frame_at(t64(taus_at), setup.tables)
    got = teq.rhs(fr, t64(y), ctx).numpy()
    got_stiff = teq.stiff_apply(fr, t64(y), ctx).numpy()
    for i in range(len(s.k)):
        jc = setup.jax_ctx(i, taus_at[i])
        ref = np.asarray(jeq.rhs(taus_at[i], jnp.asarray(y[i]), jc))
        ref_stiff = np.asarray(jeq.stiff_apply(taus_at[i], jnp.asarray(y[i]), jc))
        scale = np.abs(ref).max()
        assert np.abs(got[i] - ref).max() <= 1e-11 * scale, (when, i)
        assert np.abs(got_stiff[i] - ref_stiff).max() <= 1e-11 * scale, (when, i)


def test_adiabatic_ic_matches_jax(setup):
    """Initial state at tau_ini per lane (with the relativistic ncdm block),
    to 1e-13 of the lane's largest component."""
    s = setup.sched
    ctx = tsolve._ctx(setup.lanes, t64(s.tau_ini), tsolve._eta_off(setup.lanes.k), setup.tables)
    got = teq.adiabatic_ic(teq.frame_at(t64(s.tau_ini), setup.tables), ctx).numpy()
    assert got.shape == (8, setup.tidx.size)
    for i in range(len(s.k)):
        ref = np.asarray(jeq.adiabatic_ic(jnp.asarray(s.k[i]), s.tau_ini[i],
                                          setup.jax_ctx(i, s.tau_ini[i])))
        assert np.abs(got[i] - ref).max() <= 1e-13 * np.abs(ref).max(), i


def test_remap_ncdmfa_on_matches_jax(setup):
    """The collapse of the ncdm block to its fluid moments on a random state,
    to 1e-12 of the lane's largest component; lanes not selected keep theirs."""
    if not setup.params.N_ncdm:
        # without ncdm the switch never fires: its time is +inf on every lane
        assert torch.isinf(setup.lanes.t_ncfa).all()
        return
    s = setup.sched
    taus_at = np.minimum(s.tau_ncdmfa_on, 0.9 * float(setup.bg.tau0))
    y, ctx = _random_states(setup, taus_at)
    on = torch.as_tensor([True, False] * 4)
    fr = teq.frame_at(t64(taus_at), setup.tables)
    got = teq.remap_ncdmfa_on(t64(y), fr, ctx, on).numpy()
    for i in range(len(s.k)):
        ref = np.asarray(jeq.remap_ncdmfa_on(jnp.asarray(y[i]), taus_at[i],
                                             setup.jax_ctx(i, taus_at[i]))) \
            if on[i] else y[i]
        assert np.abs(got[i] - ref).max() <= 1e-12 * np.abs(ref).max(), i


def test_kernel_lane_program_on_host(setup, torch_sources, tmp_path):
    """csrc/perturb_ark.cuh built for the host against the plain integrator:
    sources to 1e-9 of each column's maximum, identical step counts."""
    gxx = shutil.which("g++")
    if gxx is None:
        pytest.skip("no g++ to build the host version of the kernel's lane program")
    src = Path(tsolve.cuda.CSRC_DIR) / "perturb_ark_host.cpp"
    so = tmp_path / "libperturb_ark_host.so"
    subprocess.run([gxx, "-O2", "-std=c++17", "-shared", "-fPIC", "-o", str(so), str(src)],
                   check=True)
    lib = ctypes.CDLL(str(so))
    P, I, D, L = ctypes.c_void_p, ctypes.c_int, ctypes.c_double, ctypes.c_longlong
    lib.perturb_ark_host.argtypes = [P, P, P, P, P, D, D, I, P, P, D, D, I, P, P, P, D, L, I, I,
                                     P, P, P, P]
    lib.perturb_ark_host_work_doubles.argtypes = [P]
    lib.perturb_ark_host_work_doubles.restype = L
    idx, tb = setup.tidx, setup.tables
    layout = (ctypes.c_int * tsolve.LAYOUT_INTS)(*tsolve._layout_ints(idx))
    assert lib.perturb_ark_host_work_doubles(layout) == tsolve.work_doubles(idx)
    nl, ntau = 8, len(setup.taus)
    lane_tab = torch.stack(list(setup.lanes)).contiguous()
    taus = t64(setup.taus)
    nc = torch.cat([v.reshape(-1) for v in tb.ncdm]) if idx.n_ncdm else None
    work = torch.empty(tsolve.work_doubles(idx), dtype=torch.float64)
    S = torch.empty((nl, ntau, SrcIdx.n), dtype=torch.float64)
    nsteps = torch.zeros(nl, dtype=torch.long)
    status = torch.ones(nl, dtype=torch.int32)
    rc = lib.perturb_ark_host(
        layout, lane_tab.data_ptr(), taus.data_ptr(), tb.bg.y.data_ptr(), tb.bg.y2.data_ptr(),
        tb.bg.x0, tb.bg.dx, tb.bg.n, tb.th.y.data_ptr(), tb.th.y2.data_ptr(), tb.th.x0, tb.th.dx,
        tb.th.n, nc.data_ptr() if idx.n_ncdm else None, setup.tol[0].data_ptr(),
        setup.tol[1].data_ptr(), tsolve.K_ETA_SPLIT, tsolve.MAX_ITERATIONS, nl, ntau,
        work.data_ptr(), S.data_ptr(), nsteps.data_ptr(), status.data_ptr())
    assert rc == 0 and not status.any()
    st, nt = torch_sources
    for i, name in enumerate(SrcIdx.names):
        scale = np.max(np.abs(st[:, :, i]))
        assert np.max(np.abs(S[:, :, i].numpy() - st[:, :, i])) <= 1e-9 * scale + 1e-300, name
    assert np.array_equal(nsteps.numpy(), nt)


def test_state_layout_matches_jax():
    t, j = TIdx(), JIdx()
    fields = ("delta_g", "theta_g", "shear_g", "F_g", "n_F_g", "G_g", "n_G_g", "delta_b",
              "theta_b", "delta_cdm", "delta_ur", "theta_ur", "shear_ur", "F_ur", "n_F_ur",
              "eta", "size")
    for f in fields:
        assert getattr(t, f) == getattr(j, f), f
    assert t.size == 46
    t, j = TIdx(n_ncdm=1), JIdx(n_ncdm=1)
    for f in fields + ("ncdm", "n_l_ncdm", "n_ncdm_block", "q_size_ncdm", "radiation_slices"):
        assert getattr(t, f) == getattr(j, f), f
    assert t.size == 46 + 16 * 18
    assert tsolve._layout_ints(t)[0] == t.size and len(tsolve._layout_ints(t)) == 26
    with pytest.raises(NotImplementedError):
        TIdx(has_fld=True)


def test_lane_scratch_limit():
    """The kernel's lane scratch is sized from the layout: five species fit
    one block's shared memory; a layout past 227 KB is refused by name before
    any launch, with N_ncdm, the scratch size and the limit in the message."""
    assert tsolve.check_lane_scratch(TIdx(n_ncdm=5)) == 8 * tsolve.work_doubles(TIdx(n_ncdm=5))
    big = TIdx(n_ncdm=12)
    need = 8 * tsolve.work_doubles(big)
    assert need > tsolve.MAX_LANE_SCRATCH_BYTES
    with pytest.raises(ValueError, match=rf"N_ncdm = 12 .*needs {need} bytes.*232448 bytes"):
        tsolve.check_lane_scratch(big)

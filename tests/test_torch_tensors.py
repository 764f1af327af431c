"""classpp_public_torch tensor modes against classpp_public_tpu on identical
inputs (CPU): the JAX background and thermodynamics tables moved across with
classpp_public_torch.interop at the small-host precision (background_Nloga =
1024, recfast_Nz0 = 4000), the JAX tau sampling and switch schedule.

- Tensor right-hand side, IC and remaps on seeded random states, methods
  `photons` and `massless` (with and without one 0.06 eV ncdm species, whose
  3 p_ncdm drives the neutrino hierarchy), tight coupling and streaming on
  and off: 1e-12 of each lane's largest derivative (the same float64
  expressions; the few that XLA reorders move the last bits).
- The plain tensor integrator against the JAX `solve_one_k`, vmapped, on 5 k
  lanes at l_max_tensors = 60 and rtol 1e-4: equal step counts, sources
  within 1e-8 of each source type's scale.
- The host build of the kernel's lane program (csrc/tensor_rkck.cuh) against
  the plain integrator: equal step counts, 1e-12 of scale.
- The tensor LOS scan (plain version of `transfer_tensor_los`) against the
  JAX `_tensor_scan` on seeded W (2, 40 q, 60 tau), l to 60, and the tensor
  transfer stage on the JAX tensor sources (the k -> q spline and the tau
  weights): 1e-6 of scale, as for the scalar scan (TOL_LOS; measured 7.7e-8
  of the T2 scale at l = 13, x = 0.2-2.8, and ~1e-13 away from that band).
- The tensor branch of the spectra against the JAX `compute_spectra` on the
  same transfer tables, and the lensing with a non-zero unlensed BB against
  the JAX `_lensing_impl`: 1e-10.
"""

import ctypes
import shutil
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from classpp_public_torch import interop
from classpp_public_torch.config.precision import PrecisionParams as TPrec
from classpp_public_torch.models import lensing as tl
from classpp_public_torch.models import primordial as tpm
from classpp_public_torch.models import spectra as tsp
from classpp_public_torch.models import transfer as ttr
from classpp_public_torch.models.perturbations import tensors as tt
from classpp_public_torch.ops import cuda
from classpp_public_tpu import CosmoParams, PrecisionParams
from classpp_public_tpu.models import background as jbg
from classpp_public_tpu.models import lensing as jl
from classpp_public_tpu.models import primordial as jpm
from classpp_public_tpu.models import spectra as jsp
from classpp_public_tpu.models import thermodynamics as jth
from classpp_public_tpu.models import transfer as jtr
from classpp_public_tpu.models.perturbations import grids as jg
from classpp_public_tpu.models.perturbations import tensors as jt
from test_torch_common import asdict, one_torch_thread  # noqa: F401

RTOL = 1e-4
L_TENSOR = 60
PR = dict(background_Nloga=1024, recfast_Nz0=4000, perturb_sampling_stepsize=2.0,
          tol_perturb_integration=RTOL)
NCDM = dict(m_ncdm=(0.06,), N_ur=2.0328)
# the tensor LOS: the upward Bessel recurrence amplifies the last-bit
# differences of sin/cos/exp/log/lgamma (XLA against libm) in the band
# x < l < x + 6 x^(1/3) + 2 that the forbidden-region mask keeps
TOL_LOS = 1e-6


def t64(a):
    return torch.as_tensor(np.asarray(a), dtype=torch.float64)


class Setup:
    """The JAX tables of one cosmology and both packages' views of them."""

    def __init__(self, **params):
        self.params = CosmoParams(r=0.1, **params)
        self.pr = pr = PrecisionParams(**PR)
        self.bg, self.bidx = jbg.compute_background(self.params, pr)
        self.th = jth.compute_thermodynamics(self.params, pr, self.bg, self.bidx)
        self.bgt, self.bit = interop.background(asdict(self.bg), "cpu", names=self.bidx.names)
        self.tht = interop.thermo(asdict(self.th), "cpu")

    def idx(self, method):
        n = self.params.N_ncdm
        return (jt.TnIdx(n_ncdm=n, method=method), tt.TnIdx(n_ncdm=n, method=method))


@pytest.fixture(scope="module")
def lcdm():
    return Setup()


@pytest.fixture(scope="module")
def ncdm():
    return Setup(**NCDM)


@pytest.fixture(scope="module")
def schedule(lcdm):
    """5 tensor lanes of the l_max_tensors = 60 grid, the JAX tau sampling."""
    s = lcdm
    ks_all = jg.get_k_list(s.params, s.pr, s.bg, s.th, l_scalar_max=L_TENSOR,
                           k_max_for_pk=0.0, has_cls=True, has_pk=False, m_mode=2)
    ks = ks_all[np.linspace(0, len(ks_all) - 1, 5).astype(int)]
    taus = np.asarray(jg.get_tau_sampling(s.params, s.pr, s.bg, s.bidx, s.th, has_cmb=True))
    sched = jg.get_k_schedule(ks, s.pr, s.bg, s.bidx, s.th, tau_first_sample=float(taus[0]))
    lanes = tt.TensorLanes(t64(sched.k), t64(sched.tau_ini), t64(sched.tau_tca_off),
                           t64(sched.tau_rsa_on))
    return sched, taus, lanes


@pytest.fixture(scope="module")
def jax_sources(lcdm, schedule):
    sched, taus, _ = schedule
    jidx, _ = lcdm.idx("massless")

    def solve(k, ti, a, b, c):
        return jt.solve_one_k(k, ti, a, b, c, jnp.asarray(taus), lcdm.bg.lntau_spline,
                              lcdm.th.lntau_spline, lcdm.bidx, jidx, RTOL)

    args = tuple(jnp.asarray(a) for a in (sched.k, sched.tau_ini, sched.tau_tca_off,
                                          sched.tau_ufa_on, sched.tau_rsa_on))
    srcs, steps = jax.jit(jax.vmap(solve))(*args)
    return np.asarray(srcs), np.asarray(steps)


@pytest.fixture(scope="module")
def torch_sources(lcdm, schedule):
    _, taus, lanes = schedule
    _, tidx = lcdm.idx("massless")
    tables = tt.make_tables(lcdm.bgt, lcdm.bit, lcdm.tht, tidx)
    S, steps = tt.tensor_rkck(lanes, t64(taus), tables, RTOL)
    return S.numpy(), steps.numpy(), tables


def _rhs_case(setup, method, flags, seed):
    """Seeded states at 6 lanes and times; both packages' dy and sources."""
    rng = np.random.default_rng(seed)
    jidx, tidx = setup.idx(method)
    n = tidx.size
    ks = np.geomspace(1e-3, 0.3, 6)
    taus = np.geomspace(200.0, 8000.0, 6)
    y = rng.standard_normal((6, n)) * 1e-3
    tca, rsa = flags
    ref_dy, ref_s = [], []
    for i in range(6):
        ctx = jt.TensorCtx(k=jnp.asarray(ks[i]), tca_on=jnp.asarray(tca), rsa_on=jnp.asarray(rsa),
                           bg_spline=setup.bg.lntau_spline, th_spline=setup.th.lntau_spline,
                           bidx=setup.bidx, idx=jidx, rho_rel_extra=jnp.asarray(0.0))
        dy, s = jt.rhs_full(jnp.asarray(taus[i]), jnp.asarray(y[i]), ctx)
        ref_dy.append(np.asarray(dy))
        ref_s.append(np.asarray(s))
    tables = tt.make_tables(setup.bgt, setup.bit, setup.tht, tidx)
    ctx = tt.TensorCtx(k=t64(ks), tca_on=torch.full((6,), tca), rsa_on=torch.full((6,), rsa),
                       idx=tidx)
    dy, s = tt.rhs_full(tt.frame_at(t64(taus), tables), t64(y), ctx)
    return (np.stack(ref_dy), np.stack(ref_s)), (dy.numpy(), torch.stack(s, dim=1).numpy())


@pytest.mark.parametrize("method,with_ncdm", [("photons", False), ("massless", False),
                                              ("massless", True)])
@pytest.mark.parametrize("flags", [(False, False), (True, False), (False, True)])
def test_rhs_matches_jax(lcdm, ncdm, method, with_ncdm, flags):
    (jdy, js), (tdy, ts) = _rhs_case(ncdm if with_ncdm else lcdm, method, flags, seed=7)
    assert tdy.shape == jdy.shape
    for i in range(6):
        scale = np.max(np.abs(jdy[i]))
        assert np.max(np.abs(tdy[i] - jdy[i])) <= 1e-12 * scale, i
    np.testing.assert_allclose(ts, js, rtol=1e-12, atol=1e-12 * np.max(np.abs(js)))
    if with_ncdm:   # the 3 p_ncdm term moves the gw source
        (jdy0, _), _ = _rhs_case(lcdm, method, flags, seed=7)
        assert np.max(np.abs(jdy[:, 1] - jdy0[:, 1])) > 0


def test_ic_and_remaps_match_jax(lcdm):
    rng = np.random.default_rng(3)
    jidx, tidx = lcdm.idx("massless")
    assert (tidx.size, tidx.F, tidx.G, tidx.ur, tidx.n_ur) == \
        (jidx.size, jidx.F, jidx.G, jidx.ur, jidx.n_ur) == (32, 2, 8, 14, 18)
    assert tt.TnIdx(method="photons").size == jt.TnIdx(method="photons").size == 14
    np.testing.assert_array_equal(tt.tensor_ic(tidx, 2)[0].numpy(),
                                  np.asarray(jt.tensor_ic(jidx)))
    y = rng.standard_normal((3, tidx.size))
    taus = np.array([250.0, 300.0, 400.0])
    tables = tt.make_tables(lcdm.bgt, lcdm.bit, lcdm.tht, tidx)
    on = torch.tensor([True, False, True])
    got = tt.remap_tca_off(t64(y), tt.frame_at(t64(taus), tables), tidx, on).numpy()
    got_r = tt.remap_rsa_on(t64(y), tidx, on).numpy()
    for i in range(3):
        ctx = jt.TensorCtx(k=jnp.asarray(0.01), tca_on=jnp.asarray(False),
                           rsa_on=jnp.asarray(False), bg_spline=lcdm.bg.lntau_spline,
                           th_spline=lcdm.th.lntau_spline, bidx=lcdm.bidx, idx=jidx,
                           rho_rel_extra=jnp.asarray(0.0))
        ref = np.asarray(jt.remap_tca_off(jnp.asarray(y[i]), jnp.asarray(taus[i]), ctx)) \
            if on[i] else y[i]
        np.testing.assert_allclose(got[i], ref, rtol=1e-14)
        ref_r = np.asarray(jt.remap_rsa_on(jnp.asarray(y[i]), ctx)) if on[i] else y[i]
        np.testing.assert_array_equal(got_r[i], ref_r)


def test_plain_solver_matches_jax(jax_sources, torch_sources):
    sj, nj = jax_sources
    st, nt, _ = torch_sources
    assert st.shape == sj.shape
    np.testing.assert_array_equal(nt, nj)
    for i in range(2):
        scale = np.max(np.abs(sj[:, :, i]))
        assert np.max(np.abs(st[:, :, i] - sj[:, :, i])) <= 1e-8 * scale, i


def test_kernel_lane_program_on_host(schedule, torch_sources, tmp_path):
    """csrc/tensor_rkck.cuh built for the host against the plain integrator."""
    gxx = shutil.which("g++")
    if gxx is None:
        pytest.skip("no g++ to build the host version of the kernel's lane program")
    so = tmp_path / "libtensor_rkck_host.so"
    subprocess.run([gxx, "-O2", "-std=c++17", "-shared", "-fPIC", "-o", str(so),
                    str(Path(cuda.CSRC_DIR) / "tensor_rkck_host.cpp")], check=True)
    lib = ctypes.CDLL(str(so))
    P, I, D, L = ctypes.c_void_p, ctypes.c_int, ctypes.c_double, ctypes.c_longlong
    lib.tensor_rkck_host.argtypes = [P, P, P, P, P, D, D, I, P, P, D, D, I, P, D, L, I, I,
                                     P, P, P, P]
    _, taus, lanes = schedule
    st, nt, tables = torch_sources
    idx, bg, th = tables.idx, tables.bg, tables.th
    nl, ntau = lanes.k.shape[0], len(taus)
    lane_tab = torch.stack(list(lanes)).contiguous()
    taus_t = t64(taus)
    work = torch.empty(tt.work_doubles(idx), dtype=torch.float64)
    S = torch.empty((nl, ntau, 2), dtype=torch.float64)
    nsteps = torch.zeros(nl, dtype=torch.long)
    status = torch.ones(nl, dtype=torch.int32)
    ints = tt._layout_ints(idx)
    layout = (ctypes.c_int * len(ints))(*ints)
    rc = lib.tensor_rkck_host(
        layout, lane_tab.data_ptr(), taus_t.data_ptr(), bg.y.data_ptr(), bg.y2.data_ptr(),
        bg.x0, bg.dx, bg.n, th.y.data_ptr(), th.y2.data_ptr(), th.x0, th.dx, th.n, None, RTOL,
        tt.MAX_INTERVAL_STEPS, nl, ntau, work.data_ptr(), S.data_ptr(), nsteps.data_ptr(),
        status.data_ptr())
    assert rc == 0 and not status.any()
    np.testing.assert_array_equal(nsteps.numpy(), nt)
    for i in range(2):
        scale = np.max(np.abs(st[:, :, i]))
        assert np.max(np.abs(S[:, :, i].numpy() - st[:, :, i])) <= 1e-12 * scale, i


def test_wrappers_take_the_plain_version_only_on_the_cpu(torch_sources, schedule):
    _, taus, lanes = schedule
    _, _, tables = torch_sources
    before = tt.launches, ttr.tensor_launches
    with pytest.raises(ValueError, match="unsupported device"):
        tt.tensor_rkck(lanes, t64(taus).to("meta"), tables, RTOL)
    W = torch.zeros((2, 3, 4), dtype=torch.float64, device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        ttr.transfer_tensor_los(W, W[0, 0], 1.0, W[0, :, 0], np.array([2, 3]), 1.0,
                                (0.1, 0.1, 0.1))
    assert (tt.launches, ttr.tensor_launches) == before


@pytest.fixture(scope="module")
def los_inputs():
    rng = np.random.default_rng(11)
    ntau, nq = 60, 40
    tau0 = 14000.0
    taus = np.concatenate([np.geomspace(230.0, 13000.0, ntau - 1), [tau0]])
    q = np.geomspace(2e-4, 0.02, nq)
    env = np.exp(-((taus - 280.0) / 40.0) ** 2)[None, None, :] + 0.05
    W = rng.standard_normal((2, nq, ntau)) * env
    ls = ttr.get_l_list(TPrec(), L_TENSOR)
    return W, taus, tau0, q, ls


def test_tensor_los_matches_jax(los_inputs):
    W, taus, tau0, q, ls = los_inputs
    emit_idx = np.full(ls[-1] + 1, -1, dtype=np.int32)
    emit_idx[ls] = np.arange(len(ls))
    dk = (0.2, 0.25, 0.1)
    ra_rec = tau0 - 280.0
    ref = np.asarray(jtr._tensor_scan(jnp.asarray(W), jnp.asarray(taus), tau0, jnp.asarray(q),
                                      jnp.asarray(ls), jnp.asarray(emit_idx), int(ls[-1]),
                                      len(ls), len(q), dk, jnp.asarray(ra_rec)))
    got = ttr.transfer_tensor_los(t64(W), t64(taus), tau0, t64(q), ls, ra_rec, dk).numpy()
    assert got.shape == ref.shape == (len(ls), 3, len(q))
    for i in range(3):
        scale = np.max(np.abs(ref[:, i]))
        assert scale > 0 and np.any(ref[:, i] == 0.0)   # the q-neglect masks cut
        assert np.max(np.abs(got[:, i] - ref[:, i])) <= TOL_LOS * scale, ttr.TT_TYPES_TENSOR[i]


@pytest.fixture(scope="module")
def jax_tensor_chain(lcdm):
    """The JAX tensor perturbations, transfer and spectra at l_max_tensors = 60."""
    tp = jt.compute_tensor_perturbations(lcdm.params, lcdm.pr, lcdm.bg, lcdm.bidx, lcdm.th,
                                         l_tensor_max=L_TENSOR)
    tr = jtr.compute_transfer_tensor(tp, lcdm.th, lcdm.pr, l_max=L_TENSOR)
    return tp, tr


def test_tensor_transfer_stage_matches_jax(lcdm, jax_tensor_chain):
    tp, tr = jax_tensor_chain
    got = ttr.compute_transfer_tensor(interop.tensor_perturb(asdict(tp), "cpu"), lcdm.tht,
                                      TPrec(**PR), l_max=L_TENSOR)
    np.testing.assert_array_equal(got.l.numpy(), np.asarray(tr.l))
    np.testing.assert_allclose(got.q.numpy(), np.asarray(tr.q), rtol=1e-14)
    ref = np.asarray(tr.delta)
    for i in range(3):
        scale = np.max(np.abs(ref[:, i]))
        assert np.max(np.abs(got.delta[:, i].numpy() - ref[:, i])) <= TOL_LOS * scale, i


def test_tensor_spectra_match_jax(lcdm, jax_tensor_chain):
    """The tensor branch on the JAX tensor transfer, with a seeded scalar
    transfer table beside it (the scalar part is held in test_torch_lensing)."""
    _, trt = jax_tensor_chain
    rng = np.random.default_rng(5)
    ls = jtr.get_l_list(PrecisionParams(), 100)
    q = np.geomspace(1e-4, 0.05, 50)
    delta = rng.standard_normal((len(ls), 5, len(q))) * 1e-3
    trj = jtr.TransferResult(l=jnp.asarray(ls), q=jnp.asarray(q), delta=jnp.asarray(delta),
                             tau0=14000.0, k=jnp.asarray(q))
    kw = dict(A_s=2.1e-9, n_s=0.965, r=0.1, n_t=-0.0127, alpha_t=-0.0004)
    ref = jsp.compute_spectra(trj, jpm.compute_primordial(CosmoParams(**kw)), l_max=100,
                              tr_tensor=trt)
    got = tsp.compute_spectra(interop.transfer(asdict(trj), "cpu"),
                              tpm.compute_primordial(interop.cosmo_params(kw)), l_max=100,
                              tr_tensor=interop.transfer(asdict(trt), "cpu"))
    for name in ("cl", "cl_tensor"):
        a, b = getattr(got, name).numpy(), np.asarray(getattr(ref, name))
        assert a.shape == b.shape
        for i, ct in enumerate(tsp.CT_TYPES):
            scale = np.max(np.abs(b[:, i]))
            assert np.max(np.abs(a[:, i] - b[:, i])) <= 1e-10 * max(scale, 1e-300), (name, ct)
    bb = got.cl_tensor[:, tsp.CT_TYPES.index("bb")].numpy()
    assert bb[: L_TENSOR - 1].min() > 0 and not bb[L_TENSOR - 1:].any()


def test_lensing_with_bb_matches_jax():
    """The unlensed BB column enters the lensing for the first time with
    tensors (ksi+ and ksi- take EE +- BB)."""
    lmax, lout = 300, 250
    rng = np.random.default_rng(9)
    l = np.arange(lmax + 1, dtype=np.float64)
    l[:2] = 1.0
    cl = np.zeros((lmax + 1, 7))
    cl[:, 0] = 2e-9 / (l * (l + 1)) * np.exp(-(l / 900.0) ** 2)
    cl[:, 1] = 0.02 * cl[:, 0] * (1.0 + np.sin(l / 40.0) ** 2)
    cl[:, 2] = 0.1 * cl[:, 0] * np.cos(l / 60.0)
    cl[:, 3] = 3e-12 / (l * (l + 1)) * np.exp(-(l / 120.0) ** 2) \
        * (1.0 + 0.05 * rng.standard_normal(lmax + 1))
    cl[:, 4] = 4e-8 / (l * (l + 1)) ** 2
    cl[:2] = 0.0
    for accurate in (False, True):
        ref = np.asarray(jl._lensing_impl(jnp.asarray(cl), lmax, lout, accurate, 70))
        mu, w8 = tl.mu_grid(lmax, accurate, 70)
        got = tl.lensing_wigner_plain(t64(cl), t64(mu), t64(w8), lout, fast=not accurate).numpy()
        noB = np.asarray(jl._lensing_impl(jnp.asarray(np.where(np.arange(7) == 3, 0.0, cl)),
                                          lmax, lout, accurate, 70))
        assert np.max(np.abs(ref[:, 1] - noB[:, 1])) > 0   # BB reaches lensed EE
        for i, name in enumerate(tsp.CT_TYPES[:4]):
            scale = np.max(np.abs(ref[:, i]))
            assert np.max(np.abs(got[:, i] - ref[:, i])) <= 1e-10 * scale, (accurate, name)


def test_port_opens_nothing_of_the_jax_package(tmp_path):
    """The port imports no jax and opens no file under classpp_public_tpu/:
    a fresh process records every file it opens (sys.addaudithook) while it
    imports the package and runs the background and thermodynamics, which
    read the BBN table."""
    code = (
        "import sys\n"
        "opened = []\n"
        "sys.addaudithook(lambda ev, a: opened.append(str(a[0])) if ev == 'open' else None)\n"
        "import classpp_public_torch as T\n"
        "from classpp_public_torch.config.precision import PrecisionParams\n"
        "from classpp_public_torch.models import background, thermodynamics\n"
        "pr = PrecisionParams(background_Nloga=512, recfast_Nz0=2000)\n"
        "bg, bi = background.compute_background(T.CosmoParams(), pr, device='cpu')\n"
        "thermodynamics.compute_thermodynamics(T.CosmoParams(), pr, bg, bi, device='cpu')\n"
        "assert 'jax' not in sys.modules, 'jax imported'\n"
        "bad = [p for p in opened if 'classpp_public_tpu' in p]\n"
        "assert not bad, bad\n"
        "assert any(p.endswith('sBBN_2017.dat') for p in opened), opened\n")
    root = Path(tt.__file__).resolve().parents[3]
    res = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         cwd=tmp_path, env={"PYTHONPATH": str(root), "PATH": "/usr/bin:/bin"})
    assert res.returncode == 0, res.stderr[-2000:]

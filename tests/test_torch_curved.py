"""classpp_public_torch in curved universes against classpp_public_tpu on
identical inputs (CPU): an open (Omega_k = +0.01) and a closed
(Omega_k = -0.01) model, each with one 0.06 eV massive-neutrino species, at
the reduced precision of __graft_entry__._small_setup; the hyperspherical
scans also at Omega_k = +-0.1.

- Background table, distances included: 1e-12 relative per column (closed
  forms and spline integrals on both sides). The thermodynamics scalars that
  carry the geometry (ra_rec, ra_star, angular_rescaling): 1e-8 relative, as
  the flat scalars in test_torch_background_thermo.py (the two RECFAST
  loops round exp/pow differently, which moves tau_rec in its ninth digit).
- k grids of both modes and the closed q list: equal arrays.
- Scalar right-hand side (photons, polarization, ur, ncdm with its fluid
  approximation), the stiff split, the adiabatic initial state and the TCA
  remap on seeded random states; the tensor right-hand side and the curved
  initial gw: 1e-12 of the lane's largest term.
- The kernels' lane programs (csrc/perturb_ark.cuh, csrc/tensor_rkck.cuh)
  built for the host against the plain integrators on the lowest-k lane (the
  closed k_min, nu = 3), a CMB lane and a higher one: equal step counts,
  1e-11 of each source column's maximum.
- The plain hyperspherical scans against `_transfer_scan_curved` and
  `_tensor_scan_curved` on seeded weights, with q at integer nu next to
  scanned l (closed): 1e-6 of each row's maximum, the flat scans' limit. The
  upward recurrence through the band beta sin_K < l < beta sin_K +
  6 (beta sin_K)^(1/3) + 2 that the mask keeps amplifies last-bit
  differences of sin/cos/tan/exp (XLA against libm): measured up to 3.5e-7,
  and the JAX scan alone moves by 1.7e-7 when tau moves by 2e-16.
- The closed C_l quadrature weights: 1e-11 relative.
- The closed slice (scalars and tensors, lensed; coarse k and tau steps)
  from the JAX background and thermodynamics through Class(device="cpu"):
  raw and lensed C_l to 1e-6 relative (measured ~2e-9), the tensor BB to
  1e-6.
"""

import ctypes
import dataclasses
import math
import shutil
import subprocess
from functools import partial
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import classpp_public_torch as T
from classpp_public_torch import interop
from classpp_public_torch.config.params import CosmoParams as TParams
from classpp_public_torch.config.precision import PrecisionParams as TPrec
from classpp_public_torch.models import background as tbg
from classpp_public_torch.models import spectra as tsp
from classpp_public_torch.models import thermodynamics as tth
from classpp_public_torch.models import transfer as ttr
from classpp_public_torch.models.perturbations import equations as teq
from classpp_public_torch.models.perturbations import grids as tg
from classpp_public_torch.models.perturbations import solve as tsolve
from classpp_public_torch.models.perturbations import tensors as tt
from classpp_public_torch.models.perturbations.indices import PtIdx as TIdx
from classpp_public_torch.models.perturbations.indices import SrcIdx
from classpp_public_torch.models.spectra import CT_TYPES
from classpp_public_torch.ops import cuda
import classpp_public_tpu as J
from classpp_public_tpu import CosmoParams, PrecisionParams
from classpp_public_tpu.models import background as jbg
from classpp_public_tpu.models import spectra as jsp
from classpp_public_tpu.models import thermodynamics as jth
from classpp_public_tpu.models import transfer as jtr
from classpp_public_tpu.models.perturbations import equations as jeq
from classpp_public_tpu.models.perturbations import grids as jg
from classpp_public_tpu.models.perturbations import solve as jsolve
from classpp_public_tpu.models.perturbations import tensors as jt
from classpp_public_tpu.models.perturbations.indices import PtIdx as JIdx
from test_torch_common import asdict, one_torch_thread  # noqa: F401

RTOL = 1e-4
PR = dict(background_Nloga=1024, recfast_Nz0=4000, perturb_sampling_stepsize=2.0,
          tol_perturb_integration=RTOL)
NCDM = dict(m_ncdm=(0.06,), N_ur=2.0328)
OMEGA_K = {"open": 0.01, "closed": -0.01}
H0 = 67.556 / 299792.458   # the default h, in 1/Mpc


def t64(a):
    return torch.as_tensor(np.asarray(a), dtype=torch.float64)


class Setup:
    """One curved cosmology with one ncdm species: the JAX stages, the port's
    own background and thermodynamics, and the port's views of the JAX ones."""

    def __init__(self, omega_k):
        kw = dict(Omega_k=omega_k, **NCDM)
        self.params = CosmoParams(**kw)
        self.pr = pr = PrecisionParams(**PR)
        self.bg, self.bidx = jbg.compute_background(self.params, pr)
        self.th = jth.compute_thermodynamics(self.params, pr, self.bg, self.bidx)
        self.K = -omega_k * float(self.bg.H0) ** 2
        self.sgnK = 1 if self.K > 0 else -1
        self.own_bg, _ = tbg.compute_background(TParams(**kw), TPrec(**PR), device="cpu")
        self.own_th = tth.compute_thermodynamics(TParams(**kw), TPrec(**PR), self.own_bg, _,
                                                 device="cpu")
        self.bgt, self.bit = interop.background(asdict(self.bg), "cpu", names=self.bidx.names)
        self.tht = interop.thermo(asdict(self.th), "cpu")
        # 8 scalar lanes of the l_scalar_max = 100 grid from the curved k_min
        # (nu = 3 when closed) to 0.1/Mpc, on the JAX tau sampling
        ks_all = jg.get_k_list(self.params, pr, self.bg, self.th, l_scalar_max=100,
                               k_max_for_pk=0.1)
        ks = ks_all[np.unique(np.geomspace(1, len(ks_all), 8).astype(int) - 1)]
        self.taus = np.asarray(jg.get_tau_sampling(self.params, pr, self.bg, self.bidx, self.th))
        self.sched = jg.get_k_schedule(ks, pr, self.bg, self.bidx, self.th,
                                       tau_first_sample=float(self.taus[0]), n_ncdm=1)
        self.jidx = JIdx(pr.l_max_g, pr.l_max_pol_g, pr.l_max_ur, n_ncdm=1, sgnK=self.sgnK)
        self.jncdm = jsolve.make_ncdm_ctx(self.params, self.bg, self.jidx, self.bidx)
        self.tidx = TIdx(n_ncdm=1, sgnK=self.sgnK)
        self.tables = teq.make_tables(self.bgt, self.bit, self.tht, self.tidx,
                                      interop.ncdm_ctx(asdict(self.jncdm), "cpu"), self.K)
        s = self.sched
        self.lanes = tsolve.Lanes(*(t64(a) for a in (s.k, s.tau_ini, s.tau_tca_off, s.tau_ufa_on,
                                                     s.tau_rsa_on, s.tau_ncdmfa_on)))

    def jax_ctx(self, i, tau):
        s = self.sched
        return jeq.PertCtx(
            k=jnp.asarray(s.k[i]), tca_on=jnp.asarray(tau < s.tau_tca_off[i]),
            rsa_on=jnp.asarray(tau >= s.tau_rsa_on[i]), ufa_on=jnp.asarray(tau >= s.tau_ufa_on[i]),
            bg_spline=self.bg.lntau_spline, th_spline=self.th.lntau_spline, bidx=self.bidx,
            idx=self.jidx, ncdmfa_on=jnp.asarray(tau >= s.tau_ncdmfa_on[i]), ncdm=self.jncdm,
            eta_off=jnp.asarray(float(s.k[i] < jsolve.K_ETA_SPLIT)), K=self.K)


@pytest.fixture(scope="module", params=list(OMEGA_K))
def setup(request):
    return Setup(OMEGA_K[request.param])


def test_background_distances(setup):
    """Every background column (H, H', the distances) and the scalars."""
    bgj, bij, bgt = setup.bg, setup.bidx, setup.own_bg
    for i, name in enumerate(tbg.BgIdx(1).names):
        a = np.asarray(bgj.table[:, bij[name]])
        b = bgt.table[:, i].numpy()
        assert np.max(np.abs(a - b)) <= 1e-12 * np.max(np.abs(a)), name
    for f in ("tau0", "age", "Omega0_lambda"):
        assert getattr(bgt, f) == pytest.approx(float(getattr(bgj, f)), rel=1e-12), f
    # comoving angular distance today-to-recombination against the flat chi
    chi = bgt.tau0 - bgt.tau_of_loga.numpy()
    r = bgt.table[:, tbg.BgIdx(1).ix["ang_distance"]].numpy() / bgt.table[:, 0].numpy()
    sab = math.sqrt(abs(setup.K))
    ref = np.sinh(sab * chi) / sab if setup.K < 0 else np.sin(sab * chi) / sab
    assert np.max(np.abs(r - ref)) <= 1e-12 * np.max(ref)


def test_angular_rescaling(setup):
    thj, tht = setup.th, setup.own_th
    for f in ("ra_rec", "ra_star", "angular_rescaling", "tau_rec"):
        assert getattr(tht, f) == pytest.approx(float(getattr(thj, f)), rel=1e-8), f
    # open: sinh stretches, closed: sin shrinks the distance to recombination
    assert (tht.angular_rescaling - 1.0) * setup.K < 0.0


@pytest.mark.parametrize("m_mode", [0, 2])
def test_k_and_q_lists(setup, m_mode):
    kw = dict(l_scalar_max=400, k_max_for_pk=0.5, m_mode=m_mode)
    ref = jg.get_k_list(setup.params, setup.pr, setup.bg, setup.th, **kw)
    got = tg.get_k_list(interop.cosmo_params(dataclasses.asdict(setup.params)),
                        TPrec(**PR), setup.bgt, setup.tht, **kw)
    np.testing.assert_array_equal(got, ref)
    if setup.K > 0:
        args = (setup.pr, 0.3, float(setup.bg.tau0), float(setup.th.tau_rec), setup.K)
        q = ttr.get_q_list_closed(TPrec(**PR), *args[1:])
        np.testing.assert_array_equal(q, jtr.get_q_list_closed(*args))
        nu = q / math.sqrt(setup.K)
        assert nu[0] == pytest.approx(3.0) and np.all(np.diff(nu) > 0.99)


def _random_states(setup, taus_at):
    """A random state per lane (seeded numpy): the adiabatic state at taus_at
    scaled by (1 + 0.3 N(0, 1)) plus small noise in the empty slots."""
    rng = np.random.default_rng(7)
    ctx = tsolve._ctx(setup.lanes, t64(taus_at), tsolve._eta_off(setup.lanes.k), setup.tables)
    y0 = teq.adiabatic_ic(teq.frame_at(t64(taus_at), setup.tables), ctx).numpy()
    scale = np.abs(y0).max(axis=1, keepdims=True)
    return y0 * (1.0 + 0.3 * rng.standard_normal(y0.shape)) \
        + 1e-3 * scale * rng.standard_normal(y0.shape), ctx


@pytest.mark.parametrize("when", ["tca", "early", "late"])
def test_scalar_rhs_matches_jax(setup, when):
    """dy/dtau, the stiff split J_s y and its solve, per lane, to 1e-12 of
    the lane's largest |dy| (|r|): `tca` under tight coupling, `early` with
    the full hierarchies, `late` with the ur fluid, radiation streaming and
    the ncdm fluid on where the lane reaches them before today."""
    s = setup.sched
    taus_at = {"tca": 0.5 * s.tau_tca_off,
               "early": 0.5 * (s.tau_tca_off + np.minimum(s.tau_ufa_on, s.tau_tca_off * 3)),
               "late": np.minimum(np.maximum(s.tau_rsa_on, s.tau_ncdmfa_on) * 1.5,
                                  0.9 * float(setup.bg.tau0))}[when]
    y, ctx = _random_states(setup, taus_at)
    fr = teq.frame_at(t64(taus_at), setup.tables)
    got = teq.rhs(fr, t64(y), ctx).numpy()
    got_stiff = teq.stiff_apply(fr, t64(y), ctx).numpy()
    gh = 0.1 * t64(taus_at)
    got_solve = teq.stiff_solve(fr, gh, t64(y), ctx).numpy()
    for i in range(len(s.k)):
        jc = setup.jax_ctx(i, taus_at[i])
        ref = np.asarray(jeq.rhs(taus_at[i], jnp.asarray(y[i]), jc))
        ref_stiff = np.asarray(jeq.stiff_apply(taus_at[i], jnp.asarray(y[i]), jc))
        ref_solve = np.asarray(jeq.stiff_solve(taus_at[i], float(gh[i]), jnp.asarray(y[i]), jc))
        scale = np.abs(ref).max()
        assert np.abs(got[i] - ref).max() <= 1e-12 * scale, (when, i)
        assert np.abs(got_stiff[i] - ref_stiff).max() <= 1e-12 * scale, (when, i)
        assert np.abs(got_solve[i] - ref_solve).max() <= 1e-12 * np.abs(y[i]).max(), (when, i)


def test_initial_state_and_tca_remap(setup):
    """The curved adiabatic initial state at tau_ini and the photon hierarchy
    filled at the TCA switch, to 1e-12 of the lane's largest component."""
    s = setup.sched
    ctx = tsolve._ctx(setup.lanes, t64(s.tau_ini), tsolve._eta_off(setup.lanes.k), setup.tables)
    got = teq.adiabatic_ic(teq.frame_at(t64(s.tau_ini), setup.tables), ctx).numpy()
    y, ctx_sw = _random_states(setup, s.tau_tca_off)
    got_sw = teq.remap_tca_off(t64(y), teq.frame_at(t64(s.tau_tca_off), setup.tables),
                               ctx_sw).numpy()
    for i in range(len(s.k)):
        ref = np.asarray(jeq.adiabatic_ic(jnp.asarray(s.k[i]), s.tau_ini[i],
                                          setup.jax_ctx(i, s.tau_ini[i])))
        assert np.abs(got[i] - ref).max() <= 1e-12 * np.abs(ref).max(), i
        ref_sw = np.asarray(jeq.remap_tca_off(jnp.asarray(y[i]), s.tau_tca_off[i],
                                              setup.jax_ctx(i, s.tau_tca_off[i])))
        assert np.abs(got_sw[i] - ref_sw).max() <= 1e-12 * np.abs(ref_sw).max(), i


def _tensor_setup(setup):
    """Tensor lanes (the curved tensor k grid from its k_min) and both layouts."""
    ks_all = jg.get_k_list(setup.params, setup.pr, setup.bg, setup.th, l_scalar_max=60,
                           k_max_for_pk=0.0, has_cls=True, has_pk=False, m_mode=2)
    ks = ks_all[np.unique(np.geomspace(1, len(ks_all), 4).astype(int) - 1)]
    sched = jg.get_k_schedule(ks, setup.pr, setup.bg, setup.bidx, setup.th,
                              tau_first_sample=float(setup.taus[0]))
    jidx = jt.TnIdx(n_ncdm=1, sgnK=setup.sgnK)
    tidx = tt.TnIdx(n_ncdm=1, sgnK=setup.sgnK)
    tables = tt.make_tables(setup.bgt, setup.bit, setup.tht, tidx, setup.K)
    lanes = tt.TensorLanes(t64(sched.k), t64(sched.tau_ini), t64(sched.tau_tca_off),
                           t64(sched.tau_rsa_on))
    return sched, jidx, tidx, tables, lanes


def test_tensor_rhs_and_ic_match_jax(setup):
    sched, jidx, tidx, tables, lanes = _tensor_setup(setup)
    ks = sched.k
    assert tidx.size == jidx.size
    got_ic = tt.tensor_ic(tidx, len(ks), k=t64(ks), K=setup.K).numpy()
    rng = np.random.default_rng(5)
    y = rng.standard_normal((len(ks), tidx.size))
    taus = np.minimum(sched.tau_tca_off * 2.0, 0.9 * float(setup.bg.tau0))
    ctx = tt.TensorCtx(k=t64(ks), tca_on=torch.zeros(len(ks), dtype=torch.bool),
                       rsa_on=torch.zeros(len(ks), dtype=torch.bool), idx=tidx, K=setup.K)
    dy, (s_t2, s_p) = tt.rhs_full(tt.frame_at(t64(taus), tables), t64(y), ctx)
    for i in range(len(ks)):
        ref_ic = np.asarray(jt.tensor_ic(jidx, k=jnp.asarray(ks[i]), K=setup.K))
        np.testing.assert_allclose(got_ic[i], ref_ic, rtol=1e-12, atol=0.0)
        jc = jt.TensorCtx(k=jnp.asarray(ks[i]), tca_on=jnp.asarray(False),
                          rsa_on=jnp.asarray(False), bg_spline=setup.bg.lntau_spline,
                          th_spline=setup.th.lntau_spline, bidx=setup.bidx, idx=jidx,
                          rho_rel_extra=jnp.asarray(0.0), K=setup.K)
        ref, (rt2, rp) = jt.rhs_full(jnp.asarray(taus[i]), jnp.asarray(y[i]), jc)
        ref = np.asarray(ref)
        assert np.abs(dy[i].numpy() - ref).max() <= 1e-12 * np.abs(ref).max(), i
        assert float(s_t2[i]) == pytest.approx(float(rt2), rel=1e-12)
        assert float(s_p[i]) == pytest.approx(float(rp), rel=1e-12)


def _host_lib(name, tmp_path):
    gxx = shutil.which("g++")
    if gxx is None:
        pytest.skip("no g++ to build the host version of the kernel's lane program")
    so = tmp_path / f"lib{name}.so"
    subprocess.run([gxx, "-O2", "-std=c++17", "-shared", "-fPIC", "-o", str(so),
                    str(Path(cuda.CSRC_DIR) / f"{name}.cpp")], check=True)
    return ctypes.CDLL(str(so))


P, I, D, L = ctypes.c_void_p, ctypes.c_int, ctypes.c_double, ctypes.c_longlong


def test_perturb_ark_lane_program_on_host(setup, tmp_path):
    """csrc/perturb_ark.cuh built for the host against the plain integrator
    on the lowest-k lane (nu = 3 when closed), and lanes at 0.002 and
    0.005/Mpc, at rtol 1e-3 on every other sample time (the plain integrator
    steps all lanes in lockstep, ~25 ms a step here)."""
    lib = _host_lib("perturb_ark_host", tmp_path)
    lib.perturb_ark_host_curved.argtypes = [P, P, P, P, P, D, D, I, P, P, D, D, I, P, P, P, D,
                                            D, I, L, I, I, P, P, P, P]
    k = setup.lanes.k
    sel = torch.as_tensor([0, int(torch.searchsorted(k, 0.002)),
                           int(torch.searchsorted(k, 0.005))])
    lanes = setup.lanes.take(sel)
    idx, tb = setup.tidx, setup.tables
    taus = t64(np.ascontiguousarray(setup.taus[::2]))
    nl, ntau = len(sel), len(taus)
    tol = (torch.full((nl, idx.size), 1e-3, dtype=torch.float64),
           torch.full((nl, idx.size), 1e-11, dtype=torch.float64))
    St, nt = tsolve.integrate_sources(lanes, taus, tb, tol)
    lane_tab = torch.stack(list(lanes)).contiguous()
    nc = torch.cat([v.reshape(-1) for v in tb.ncdm])
    work = torch.empty(tsolve.work_doubles(idx), dtype=torch.float64)
    S = torch.empty((nl, ntau, SrcIdx.n), dtype=torch.float64)
    nsteps = torch.zeros(nl, dtype=torch.long)
    status = torch.ones(nl, dtype=torch.int32)
    layout = (ctypes.c_int * tsolve.LAYOUT_INTS)(*tsolve._layout_ints(idx))
    rc = lib.perturb_ark_host_curved(
        layout, lane_tab.data_ptr(), taus.data_ptr(), tb.bg.y.data_ptr(), tb.bg.y2.data_ptr(),
        tb.bg.x0, tb.bg.dx, tb.bg.n, tb.th.y.data_ptr(), tb.th.y2.data_ptr(), tb.th.x0, tb.th.dx,
        tb.th.n, nc.data_ptr(), tol[0].data_ptr(), tol[1].data_ptr(), tsolve.K_ETA_SPLIT,
        setup.K, setup.sgnK, tsolve.MAX_ITERATIONS, nl, ntau, work.data_ptr(), S.data_ptr(),
        nsteps.data_ptr(), status.data_ptr())
    assert rc == 0 and not status.any()
    np.testing.assert_array_equal(nsteps.numpy(), nt.numpy())
    for i, name in enumerate(SrcIdx.names):
        scale = float(St[:, :, i].abs().max())
        assert float((S[:, :, i] - St[:, :, i]).abs().max()) <= 1e-11 * scale + 1e-300, name


def test_tensor_rkck_lane_program_on_host(setup, tmp_path):
    """csrc/tensor_rkck.cuh built for the host against the plain integrator
    on four curved tensor lanes, the tensor k_min among them."""
    lib = _host_lib("tensor_rkck_host", tmp_path)
    lib.tensor_rkck_host_curved.argtypes = [P, P, P, P, P, D, D, I, P, P, D, D, I, P, D, D, I,
                                            L, I, I, P, P, P, P]
    _, _, idx, tb, lanes = _tensor_setup(setup)
    taus = t64(setup.taus)
    St, nt = tt.tensor_rkck(lanes, taus, tb, RTOL)
    nl, ntau = lanes.k.shape[0], len(setup.taus)
    lane_tab = torch.stack(list(lanes)).contiguous()
    work = torch.empty(tt.work_doubles(idx), dtype=torch.float64)
    S = torch.empty((nl, ntau, 2), dtype=torch.float64)
    nsteps = torch.zeros(nl, dtype=torch.long)
    status = torch.ones(nl, dtype=torch.int32)
    ints = tt._layout_ints(idx)
    layout = (ctypes.c_int * len(ints))(*ints)
    rc = lib.tensor_rkck_host_curved(
        layout, lane_tab.data_ptr(), taus.data_ptr(), tb.bg.y.data_ptr(), tb.bg.y2.data_ptr(),
        tb.bg.x0, tb.bg.dx, tb.bg.n, tb.th.y.data_ptr(), tb.th.y2.data_ptr(), tb.th.x0, tb.th.dx,
        tb.th.n, None, RTOL, setup.K, setup.sgnK, tt.MAX_INTERVAL_STEPS, nl, ntau, work.data_ptr(),
        S.data_ptr(), nsteps.data_ptr(), status.data_ptr())
    assert rc == 0 and not status.any()
    np.testing.assert_array_equal(nsteps.numpy(), nt.numpy())
    for i in range(2):
        scale = float(St[:, :, i].abs().max())
        assert float((S[:, :, i] - St[:, :, i]).abs().max()) <= 1e-11 * scale, i


# --- the hyperspherical scans on seeded weights --------------------------

L_EMIT = np.array([2, 3, 4, 5, 6, 8, 10, 11, 12, 15, 20, 25, 30, 31, 40, 50, 51, 60])
NU = np.array([3.0, 4.0, 7.0, 10.0, 11.0, 20.0, 31.0, 45.0, 51.0, 80.0, 120.0, 190.0])
SCAN_TOL = 1e-6


def _scan_inputs(omega_k, ntt):
    """Seeded weights on a tau grid ending at tau0, q at integer nu (closed;
    nu + 0.37 open) and k(q)."""
    K = -omega_k * H0**2
    sgnK = 1 if K > 0 else -1
    rng = np.random.default_rng(3)
    tau0 = 14000.0
    taus = np.concatenate([np.geomspace(200.0, 13000.0, 60), [13500.0, 13900.0, 13990.0, tau0]])
    q = (NU if sgnK > 0 else NU + 0.37) * math.sqrt(abs(K))
    kq = np.sqrt(q * q - (1.0 if ntt == 5 else 3.0) * K)
    W = rng.standard_normal((ntt, len(q), len(taus)))
    late = rng.random(len(taus)) < 0.7
    return K, sgnK, taus, tau0, q, kq, W, late


@partial(jax.jit, static_argnums=(5, 6, 7, 8))
def _jax_scalar_scan(W, taus, tau0, q, late, sgnK, lmax, n_l, nq, K, kq, l_emit, emit_idx):
    # ra_rec = 0: no q-neglect mask; Limber for the lcmb row above l = 10
    return jtr._transfer_scan_curved(W, W, taus, tau0, q, l_emit, emit_idx, lmax, n_l, 5, nq,
                                     10.0, (0.0, 0.0, 0.0, 0.0), 25.0, 0.0, late, sgnK, K, kq)


@partial(jax.jit, static_argnums=(4, 5, 6, 7))
def _jax_tensor_scan(W, taus, tau0, q, sgnK, lmax, n_l, nq, K, kq, l_emit, emit_idx, ra_rec):
    return jtr._tensor_scan_curved(W, taus, tau0, q, l_emit, emit_idx, lmax, n_l, nq,
                                   (0.0, 0.001, 0.002), ra_rec, sgnK, K, kq)


def _emit_idx():
    e = np.full(L_EMIT[-1] + 1, -1, dtype=np.int32)
    e[L_EMIT] = np.arange(len(L_EMIT), dtype=np.int32)
    return jnp.asarray(e)


@pytest.mark.parametrize("omega_k", [0.01, -0.01, 0.1, -0.1])
def test_scalar_scan_matches_jax(omega_k):
    """The plain scan (rows before masks), then the stage's Limber row."""
    K, sgnK, taus, tau0, q, kq, W, late = _scan_inputs(omega_k, 5)
    ref = np.asarray(_jax_scalar_scan(jnp.asarray(W), jnp.asarray(taus), tau0, jnp.asarray(q),
                                      jnp.asarray(late), sgnK, int(L_EMIT[-1]), len(L_EMIT),
                                      len(q), K, jnp.asarray(kq), jnp.asarray(L_EMIT),
                                      _emit_idx()))
    got = ttr.transfer_los_curved(t64(W), t64(taus), tau0, t64(q), t64(kq), L_EMIT, 25.0,
                                  torch.as_tensor(late), K, sgnK).numpy()
    assert np.isfinite(got).all() and np.abs(got).max() > 0
    for c in range(4):
        assert np.abs(got[:, c] - ref[:, c]).max() <= SCAN_TOL * np.abs(ref[:, c]).max(), c
    low = L_EMIT <= 10      # the lcmb row before the Limber switch
    assert np.abs(got[low, 4] - ref[low, 4]).max() <= SCAN_TOL * np.abs(ref[low, 4]).max()
    staged = ttr.transfer_scan(t64(W), t64(W), t64(taus), tau0, t64(q), L_EMIT, 25.0,
                               torch.as_tensor(late), 0.0, (0.0,) * 4, 10.0, K, sgnK,
                               t64(kq)).numpy()
    assert np.abs(staged[:, 4] - ref[:, 4]).max() <= SCAN_TOL * np.abs(ref[:, 4]).max()


@pytest.mark.parametrize("omega_k", [0.01, -0.01, 0.1, -0.1])
def test_tensor_scan_matches_jax(omega_k):
    K, sgnK, taus, tau0, q, kq, W, _ = _scan_inputs(omega_k, 2)
    ra_rec = 1.5e4
    ref = np.asarray(_jax_tensor_scan(jnp.asarray(W), jnp.asarray(taus), tau0, jnp.asarray(q),
                                      sgnK, int(L_EMIT[-1]), len(L_EMIT), len(q), K,
                                      jnp.asarray(kq), jnp.asarray(L_EMIT), _emit_idx(),
                                      ra_rec))
    got = ttr.transfer_tensor_los_curved(t64(W), t64(taus), tau0, t64(q), t64(kq), L_EMIT,
                                         ra_rec, (0.0, 0.001, 0.002), K, sgnK).numpy()
    assert np.isfinite(got).all()
    for c in range(3):
        assert np.abs(got[:, c] - ref[:, c]).max() <= SCAN_TOL * np.abs(ref[:, c]).max(), c


def test_closed_quadrature_weights():
    K = 0.01 * H0**2
    q = ttr.get_q_list_closed(TPrec(hyper_flat_approximation_nu=40.0), 0.02, 14000.0, 280.0, K)
    k = np.sqrt(q * q - K)
    kw = dict(sgnK=1, q0_over_k0=q[0] / k[0], sqrtK=math.sqrt(K),
              q_flat_idx=int(np.searchsorted(q, 40.0 * math.sqrt(K))))
    assert 0 < kw["q_flat_idx"] < len(q) - 1
    np.testing.assert_allclose(tsp.cl_quad_weights(t64(k), **kw).numpy(),
                               np.asarray(jsp.cl_quad_weights(jnp.asarray(k), **kw)), rtol=1e-11)


# --- the closed slice -------------------------------------------------------

SLICE_PR = dict(background_Nloga=1024, recfast_Nz0=4000, perturb_sampling_stepsize=5.0,
                tol_perturb_integration=1e-3, k_step_super=0.02, k_step_sub=0.1,
                k_step_super_reduction=1.0, delta_l_max=40)
SLICE_KEYS = {"Omega_k": -0.01, "modes": "s,t", "r": 0.1, "output": "tCl,pCl,lCl",
              "lensing": "yes", "l_max_scalars": 60, "l_max_tensors": 40}


@pytest.fixture(scope="module")
def closed_slice():
    """The closed model through the JAX Cosmology and through the port's
    Class(device="cpu"), the port seeded with the JAX background and
    thermodynamics."""
    cj = J.Class()
    cj.set(dict(SLICE_KEYS, **SLICE_PR))
    cj.compute(["lensing"])
    ct = T.Class(device="cpu")
    ct.set(dict(SLICE_KEYS, **SLICE_PR))
    bg, bidx = cj.cosmo.background
    ct.cosmo.set_stage("background", interop.background(asdict(bg), "cpu", names=bidx.names))
    ct.cosmo.set_stage("thermodynamics", interop.thermo(asdict(cj.cosmo.thermodynamics), "cpu"))
    ct.compute(["lensing"])
    return cj, ct


def test_closed_slice_matches_jax(closed_slice):
    cj, ct = closed_slice
    cosmo_j, cosmo_t = cj.cosmo, ct.cosmo
    assert cosmo_t.sgnK == cosmo_j.sgnK == 1
    for a, b in ((cosmo_t.transfer, cosmo_j.transfer),
                 (cosmo_t.tensor_transfer, cosmo_j.tensor_transfer)):
        np.testing.assert_array_equal(a.q.numpy(), np.asarray(b.q))
        np.testing.assert_allclose(a.k.numpy(), np.asarray(b.k), rtol=1e-15)
    for got, ref in ((ct.raw_cl(60), cj.raw_cl(60)), (ct.lensed_cl(60), cj.lensed_cl(60))):
        for name in ("tt", "ee", "bb", "pp"):
            if name not in got or name not in ref:
                continue
            r, g = np.asarray(ref[name])[2:], np.asarray(got[name])[2:]
            m = r != 0.0
            assert m.any() and not g[~m].any(), name
            assert np.max(np.abs(g[m] / r[m] - 1.0)) <= 1e-6, name
        den = np.sqrt(np.abs(np.asarray(ref["tt"]) * np.asarray(ref["ee"])))[2:]
        assert np.max(np.abs(np.asarray(got["te"])[2:] - np.asarray(ref["te"])[2:]) / den) <= 1e-6
    ix = CT_TYPES.index("bb")
    tb_t = cosmo_t.spectra.cl_tensor.numpy()[:39, ix]
    tb_j = np.asarray(cosmo_j.spectra.cl_tensor)[:39, ix]
    assert np.max(np.abs(tb_t / tb_j - 1.0)) <= 1e-6


def test_open_class_on_the_cpu():
    """Class(device="cpu") computes an open model with scalars and tensors
    through the plain versions (coarse steps: a run-through, held to finite
    spectra and to the curved kernels' launch counters staying at 0)."""
    before = (ttr.curved_launches, ttr.tensor_curved_launches, tsolve.launches, tt.launches)
    c = T.Class(device="cpu")
    c.set(dict(SLICE_KEYS, Omega_k=0.01, n_t="scc", l_max_scalars=20, l_max_tensors=20,
               output="tCl,pCl", lensing="no", **dict(SLICE_PR, delta_l_max=0)))
    c.compute(["spectra"])
    cl = c.raw_cl(20)
    assert c.cosmo.sgnK == -1 and c.Omega0_k() == 0.01
    for name in ("tt", "ee", "te", "bb"):
        assert np.isfinite(cl[name]).all() and np.abs(cl[name][2:]).min() > 0, name
    assert (ttr.curved_launches, ttr.tensor_curved_launches, tsolve.launches,
            tt.launches) == before


def test_curved_wrappers_take_the_plain_version_only_on_the_cpu():
    W = torch.zeros((5, 3, 4), dtype=torch.float64, device="meta")
    v = W[0, :, 0]
    before = ttr.curved_launches, ttr.tensor_curved_launches
    with pytest.raises(ValueError, match="unsupported device"):
        ttr.transfer_los_curved(W, W[0, 0], 1.0, v, v, np.array([2, 3]), 1.0,
                                torch.ones(4, dtype=torch.bool), -1e-8, 1)
    with pytest.raises(ValueError, match="unsupported device"):
        ttr.transfer_tensor_los_curved(W[:2], W[0, 0], 1.0, v, v, np.array([2, 3]), 1.0,
                                       (0.1, 0.1, 0.1), -1e-8, 1)
    assert (ttr.curved_launches, ttr.tensor_curved_launches) == before


@pytest.mark.parametrize("name", ["g8_curved", "g18_closed", "g29_open01", "g30_closed01"])
def test_curved_configurations_parse_as_in_jax(name):
    """The curvature goldens' keys (tests/golden/gen/<name>.ini) read as the
    JAX classy reads them; Omega_k outside (-0.95, 0.95) is refused."""
    from classpp_public_torch.tools.configs import CONFIGS, GOLDEN_ONLY

    keys = {**CONFIGS, **GOLDEN_ONLY}[name]
    ct, cj = T.Class(device="cpu"), J.Class()
    ct.set(dict(keys))
    cj.set(dict(keys))
    pt, pj = ct.cosmo.params, cj.cosmo.params
    for f in ("Omega_k", "r", "n_t", "alpha_t", "h", "omega_b", "omega_cdm", "A_s", "n_s"):
        assert getattr(pt, f) == getattr(pj, f), f
    assert ct.cosmo.out.modes == cj.cosmo.out.modes == ("s", "t")
    assert ct.cosmo.out.P_k_max == cj.cosmo.out.P_k_max == 1.0
    c = T.Class(device="cpu")
    c.set(dict(keys, Omega_k=-0.96))
    with pytest.raises(T.CosmoSevereError, match="Omega_k"):
        c.cosmo

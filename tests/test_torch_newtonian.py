"""The port in the Newtonian gauge against classpp_public_tpu on identical
inputs (CPU), at small size.

- The state layout: PtIdx(gauge="newtonian") offsets equal the JAX ones,
  with and without ncdm (theta_cdm after delta_cdm, the rest shifted by one).
- The right-hand side `rhs_full` on seeded random states, with every
  combination of the (tca, rsa, ufa, ncdm fluid) flags forced on both sides,
  in the tight-coupling era, at recombination and late: flat without ncdm,
  with one and with three ncdm species, and closed with one; 1e-12 of the
  largest |dy| of the lane. The same states' source rows (`compute_sources`,
  the Newtonian efficient form) at recombination and late: 1e-12 of each
  column's maximum.
- The initial state (`initial_conditions`: adiabatic, then
  `ic_to_newtonian`) against JAX `initial_conditions("ad", ...)`, flat and
  closed, with ncdm: 1e-12 of the lane's largest component.
- The kernel's lane program (csrc/perturb_ark.cuh) built for the host, the
  Newtonian instance, against the plain integrator on three lanes (the lowest
  k, a CMB lane and a P(k)-tail lane under the tight Newtonian tail
  tolerances), flat without ncdm and closed with it: 1e-12 of each source
  column's maximum, equal step counts.
- `Class(device="cpu")` against the JAX `Class` in the Newtonian gauge
  (tCl,pCl,lCl,mPk,nCl, one Gaussian bin; l_max 60, P(k) to 0.2/Mpc), the
  port seeded with the JAX background and thermodynamics: every raw C_l, the
  number counts and their crosses, and P(k), to 1e-6 of each spectrum's
  maximum. On the same point the port's raw TT in the two
  gauges agree within tests/test_gauge.py's 1.5e-2.
- The JAX classy's gauge parsing: new/newt read as newtonian, an unknown gauge
  is a CosmoSevereError, and the N-body gauge raises NotImplementedError; the
  four Newtonian configurations of tools/configs.py parse as in JAX.

Coarse precision throughout (perturb_sampling_stepsize 2, rtol 1e-4), as the
other test_torch_* files.
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

import classpp_public_torch as T
from classpp_public_torch import interop
from classpp_public_torch.config.precision import PrecisionParams as TPrec
from classpp_public_torch.models.perturbations import equations as teq
from classpp_public_torch.models.perturbations import solve as tsolve
from classpp_public_torch.models.perturbations.indices import PtIdx as TIdx
from classpp_public_torch.models.perturbations.indices import SrcIdx
from classpp_public_torch.ops import cuda
import classpp_public_tpu as J
from classpp_public_tpu import CosmoParams, PrecisionParams
from classpp_public_tpu.models import background as jbg
from classpp_public_tpu.models import thermodynamics as jth
from classpp_public_tpu.models.perturbations import equations as jeq
from classpp_public_tpu.models.perturbations import grids as jg
from classpp_public_tpu.models.perturbations import solve as jsolve
from classpp_public_tpu.models.perturbations.indices import PtIdx as JIdx
from test_torch_common import asdict, one_torch_thread  # noqa: F401

RTOL = 1e-4
PR = dict(background_Nloga=1024, recfast_Nz0=4000, perturb_sampling_stepsize=2.0,
          tol_perturb_integration=RTOL)
CASES = {"lcdm": {}, "ncdm1": dict(m_ncdm=(0.06,), N_ur=2.0328),
         "ncdm3": dict(m_ncdm=(0.02, 0.04, 0.06), N_ur=0.00641),
         "closed_ncdm1": dict(m_ncdm=(0.06,), N_ur=2.0328, Omega_k=-0.01)}
RHS_TOL, SRC_TOL, IC_TOL, HOST_TOL = 1e-12, 1e-12, 1e-12, 1e-12
GAUGE_TOL = 1.5e-2     # tests/test_gauge.py
SLICE_TOL = 1e-6


def t64(a):
    return torch.as_tensor(np.asarray(a), dtype=torch.float64)


def test_state_layout_matches_jax():
    fields = ("delta_g", "theta_g", "shear_g", "F_g", "n_F_g", "G_g", "n_G_g", "delta_b",
              "theta_b", "delta_cdm", "theta_cdm", "n_theta_cdm", "delta_ur", "theta_ur",
              "shear_ur", "F_ur", "n_F_ur", "ncdm", "n_l_ncdm", "n_ncdm_block", "eta", "size",
              "radiation_slices")
    for n in (0, 1, 3):
        t, j = TIdx(n_ncdm=n, gauge="newtonian"), JIdx(n_ncdm=n, gauge="newtonian")
        for f in fields:
            assert getattr(t, f) == getattr(j, f), (n, f)
        assert t.size == TIdx(n_ncdm=n).size + 1 and t.theta_cdm == t.delta_cdm + 1
        ints = tsolve._layout_ints(t)
        assert len(ints) == tsolve.LAYOUT_INTS and ints[11] == t.theta_cdm
    assert tsolve._layout_ints(TIdx())[11] == -1


class Setup:
    """One cosmology: the JAX stages and the port's views of them, eight
    lanes from 1e-4 to 0.3/Mpc on the JAX schedule, Newtonian layouts."""

    def __init__(self, case):
        kw = CASES[case]
        self.params = CosmoParams(**kw)
        self.pr = pr = PrecisionParams(**PR)
        n = self.params.N_ncdm
        self.bg, self.bidx = jbg.compute_background(self.params, pr)
        self.th = jth.compute_thermodynamics(self.params, pr, self.bg, self.bidx)
        ok = kw.get("Omega_k", 0.0)
        self.K = -ok * float(self.bg.H0) ** 2
        self.sgnK = 0 if ok == 0.0 else (1 if self.K > 0 else -1)
        self.taus = np.asarray(jg.get_tau_sampling(self.params, pr, self.bg, self.bidx,
                                                   self.th))
        ks = np.geomspace(1e-4 if not self.sgnK else 5e-4, 0.3, 8)
        self.sched = jg.get_k_schedule(ks, pr, self.bg, self.bidx, self.th,
                                       tau_first_sample=float(self.taus[0]), n_ncdm=n)
        self.jidx = JIdx(pr.l_max_g, pr.l_max_pol_g, pr.l_max_ur, n_ncdm=n, gauge="newtonian",
                         sgnK=self.sgnK)
        self.jncdm = jsolve.make_ncdm_ctx(self.params, self.bg, self.jidx, self.bidx) if n \
            else None
        self.tidx = TIdx(n_ncdm=n, gauge="newtonian", sgnK=self.sgnK)
        bgt, bit = interop.background(asdict(self.bg), "cpu", names=self.bidx.names)
        tht = interop.thermo(asdict(self.th), "cpu")
        nct = interop.ncdm_ctx(asdict(self.jncdm), "cpu") if n else None
        self.tables = teq.make_tables(bgt, bit, tht, self.tidx, nct, self.K)
        s = self.sched
        t_ncfa = s.tau_ncdmfa_on if n else np.full_like(ks, np.inf)
        self.lanes = tsolve.Lanes(t64(s.k), t64(s.tau_ini), t64(s.tau_tca_off),
                                  t64(s.tau_ufa_on), t64(s.tau_rsa_on), t64(t_ncfa))
        self._jax_rows = None

    def ctx(self, tau):
        """The port's context at tau per lane."""
        return tsolve._ctx(self.lanes, t64(tau), tsolve._eta_off(self.lanes.k, "newtonian"),
                           self.tables)

    def jax_rows(self):
        """jit(vmap) of (dy, source row) of the JAX Newtonian rhs_full and
        compute_sources per lane, flags forced."""
        if self._jax_rows is None:
            def one(tau, y, k, tca, rsa, ufa, ncfa):
                c = jeq.PertCtx(k=k, tca_on=tca, rsa_on=rsa, ufa_on=ufa,
                                bg_spline=self.bg.lntau_spline, th_spline=self.th.lntau_spline,
                                bidx=self.bidx, idx=self.jidx, ncdmfa_on=ncfa, ncdm=self.jncdm,
                                eta_off=0.0, K=self.K)
                return jeq.rhs(tau, y, c), jeq.compute_sources(tau, y, c)
            self._jax_rows = jax.jit(jax.vmap(one))
        return self._jax_rows


_SETUPS = {}


def get_setup(case):
    if case not in _SETUPS:
        _SETUPS[case] = Setup(case)
    return _SETUPS[case]


@pytest.fixture(scope="module", params=list(CASES))
def setup(request):
    return get_setup(request.param)


def _random_states(setup, tau):
    """The Newtonian initial state at tau per lane scaled by (1 + 0.3 N(0, 1))
    plus small noise in every slot (seeded numpy)."""
    rng = np.random.default_rng(19)
    y0 = teq.initial_conditions(teq.frame_at(t64(tau), setup.tables), setup.ctx(tau)).numpy()
    scale = np.abs(y0).max(axis=1, keepdims=True)
    return y0 * (1.0 + 0.3 * rng.standard_normal(y0.shape)) \
        + 1e-3 * scale * rng.standard_normal(y0.shape)


# every (tca, rsa, ufa, ncdm fluid) combination: 16 per lane
FLAGS = np.array([[(c >> b) & 1 for b in range(4)] for c in range(16)], dtype=bool)


@pytest.mark.parametrize("when", ["early", "recombination", "late"])
def test_rhs_and_sources_match_jax(setup, when):
    """`early` lies in the tight-coupling era, where the visibility g is
    ~1e-47 and the source columns it weights are the spline's noise of a
    vanishing quantity: there only the right-hand side is held."""
    s = setup.sched
    tau = {"early": np.sqrt(s.tau_ini * s.tau_tca_off),
           "recombination": np.full(len(s.k), float(setup.th.tau_rec)),
           "late": np.minimum(np.maximum(s.tau_rsa_on, s.tau_tca_off) * 1.5,
                              0.9 * float(setup.bg.tau0))}[when]
    y = _random_states(setup, tau)
    nl, nf = y.shape[0], len(FLAGS)
    # lane-major: row i * 16 + c is lane i under flag combination c
    yy, tt = np.repeat(y, nf, axis=0), np.repeat(tau, nf)
    fl = np.tile(FLAGS, (nl, 1))
    lanes = setup.lanes.take(torch.arange(nl).repeat_interleave(nf))
    ctx = tsolve._ctx(lanes, t64(tt), torch.zeros(nl * nf, dtype=torch.float64), setup.tables)
    ctx = ctx._replace(**{f: torch.as_tensor(fl[:, i]) for i, f in
                          enumerate(("tca_on", "rsa_on", "ufa_on", "ncdmfa_on"))})
    fr = teq.frame_at(t64(tt), setup.tables)
    dy = teq.rhs(fr, t64(yy), ctx).numpy()
    src = teq.compute_sources(fr, t64(yy), ctx).numpy()
    ref_dy, ref_src = (np.asarray(a) for a in setup.jax_rows()(
        jnp.asarray(tt), jnp.asarray(yy), jnp.asarray(np.repeat(s.k, nf)),
        *(jnp.asarray(fl[:, i]) for i in range(4))))
    assert np.isfinite(dy).all() and np.isfinite(src).all()
    err = np.abs(dy - ref_dy).max(axis=1) / np.abs(ref_dy).max(axis=1)
    print(f"rhs ({when}): worst {err.max():.3e} of the lane's largest |dy|")
    assert err.max() <= RHS_TOL, (int(err.argmax()) // nf, FLAGS[int(err.argmax()) % nf])
    if when == "early":
        return
    # the Newtonian gauge's own columns are live
    assert np.abs(src[:, SrcIdx.ix["theta_cdm"]]).max() > 0.0
    assert not src[:, SrcIdx.ix["h_prime"]].any()
    worst = {}
    for i, name in enumerate(SrcIdx.names):
        scale = np.abs(ref_src[:, i]).max()
        worst[name] = float(np.abs(src[:, i] - ref_src[:, i]).max() / max(scale, 1e-300))
    print(f"sources ({when}): worst {max(worst.values()):.3e} ({max(worst, key=worst.get)})")
    assert max(worst.values()) <= SRC_TOL, worst


def test_initial_conditions_match_jax(setup):
    s = setup.sched
    fr = teq.frame_at(t64(s.tau_ini), setup.tables)
    got = teq.initial_conditions(fr, setup.ctx(s.tau_ini)).numpy()
    assert got.shape == (8, setup.tidx.size)
    jc = jeq.PertCtx(k=None, tca_on=True, rsa_on=False, ufa_on=False,
                     bg_spline=setup.bg.lntau_spline, th_spline=setup.th.lntau_spline,
                     bidx=setup.bidx, idx=setup.jidx, ncdm=setup.jncdm, eta_off=0.0, K=setup.K)
    for i in range(8):
        ref = np.asarray(jeq.initial_conditions("ad", jnp.asarray(s.k[i]), s.tau_ini[i],
                                                jc._replace(k=jnp.asarray(s.k[i]))))
        assert ref[setup.jidx.theta_cdm] != 0.0
        assert np.abs(got[i] - ref).max() <= IC_TOL * np.abs(ref).max(), i


@pytest.mark.parametrize("case", ["lcdm", "closed_ncdm1"])
def test_kernel_lane_program_on_host(case, tmp_path):
    """The Newtonian instance of csrc/perturb_ark.cuh built for the host
    against the plain integrator, flat without ncdm and closed with one ncdm
    species: the lowest-k lane, one at 0.02/Mpc under the CMB tolerances and
    the next-to-highest (0.095 / 0.12/Mpc) under the Newtonian P(k)-tail
    tolerances (radiation rows at atol 1e-11, the others at 3e-8), on every
    third sample time."""
    setup = get_setup(case)
    gxx = shutil.which("g++")
    if gxx is None:
        pytest.skip("no g++ to build the host version of the kernel's lane program")
    so = tmp_path / "libperturb_ark_host.so"
    subprocess.run([gxx, "-O2", "-std=c++17", "-shared", "-fPIC", "-o", str(so),
                    str(Path(cuda.CSRC_DIR) / "perturb_ark_host.cpp")], check=True)
    lib = ctypes.CDLL(str(so))
    P, I, D, L = ctypes.c_void_p, ctypes.c_int, ctypes.c_double, ctypes.c_longlong
    lib.perturb_ark_host_gauge.argtypes = [P, P, P, P, P, D, D, I, P, P, D, D, I, P, P, P, D, D,
                                           I, I, L, I, I, P, P, P, P]
    k = setup.lanes.k
    sel = torch.as_tensor([0, int(torch.searchsorted(k, 0.02)), len(k) - 2])
    lanes = setup.lanes.take(sel)
    idx, tb = setup.tidx, setup.tables
    pr = TPrec(**PR)
    kn = lanes.k.numpy()
    rt_c, at_c = tsolve._tolerances(kn[:2], idx, pr, False, 0.0)
    rt_t, at_t = tsolve._tolerances(kn[2:], idx, pr, True, 0.0)
    assert at_t[0, idx.delta_g] == 1e-11 and at_t[0, idx.delta_cdm] == 3e-8
    assert (rt_t == RTOL).all()
    tol = (t64(np.concatenate([rt_c, rt_t])), t64(np.concatenate([at_c, at_t])))
    taus = t64(np.ascontiguousarray(setup.taus[::3]))
    nl, ntau = len(sel), len(taus)
    St, nt = tsolve.integrate_sources(lanes, taus, tb, tol)
    lane_tab = torch.stack(list(lanes)).contiguous()
    nc = torch.cat([v.reshape(-1) for v in tb.ncdm]) if idx.n_ncdm else None
    work = torch.empty(tsolve.work_doubles(idx), dtype=torch.float64)
    S = torch.empty((nl, ntau, SrcIdx.n), dtype=torch.float64)
    nsteps = torch.zeros(nl, dtype=torch.long)
    status = torch.ones(nl, dtype=torch.int32)
    layout = (ctypes.c_int * tsolve.LAYOUT_INTS)(*tsolve._layout_ints(idx))
    rc = lib.perturb_ark_host_gauge(
        layout, lane_tab.data_ptr(), taus.data_ptr(), tb.bg.y.data_ptr(), tb.bg.y2.data_ptr(),
        tb.bg.x0, tb.bg.dx, tb.bg.n, tb.th.y.data_ptr(), tb.th.y2.data_ptr(), tb.th.x0, tb.th.dx,
        tb.th.n, nc.data_ptr() if idx.n_ncdm else None, tol[0].data_ptr(), tol[1].data_ptr(),
        tsolve.K_ETA_SPLIT, setup.K, setup.sgnK, tsolve.GAUGES["newtonian"],
        tsolve.MAX_ITERATIONS, nl, ntau, work.data_ptr(), S.data_ptr(), nsteps.data_ptr(),
        status.data_ptr())
    assert rc == 0 and not status.any()
    np.testing.assert_array_equal(nsteps.numpy(), nt.numpy())
    worst = {}
    for i, name in enumerate(SrcIdx.names):
        scale = float(St[:, :, i].abs().max())
        worst[name] = float((S[:, :, i] - St[:, :, i]).abs().max()) / max(scale, 1e-300)
    print(f"host build vs plain: steps {nt.tolist()}, worst {max(worst.values()):.3e} "
          f"({max(worst, key=worst.get)})")
    assert max(worst.values()) <= HOST_TOL, worst
    # the synchronous entry point refuses the Newtonian layout
    assert lib.perturb_ark_host_gauge(
        layout, lane_tab.data_ptr(), taus.data_ptr(), tb.bg.y.data_ptr(), tb.bg.y2.data_ptr(),
        tb.bg.x0, tb.bg.dx, tb.bg.n, tb.th.y.data_ptr(), tb.th.y2.data_ptr(), tb.th.x0, tb.th.dx,
        tb.th.n, nc.data_ptr() if idx.n_ncdm else None, tol[0].data_ptr(), tol[1].data_ptr(),
        tsolve.K_ETA_SPLIT, setup.K, setup.sgnK, 0, tsolve.MAX_ITERATIONS, nl, ntau,
        work.data_ptr(), S.data_ptr(), nsteps.data_ptr(), status.data_ptr()) != 0


# --- the whole slice --------------------------------------------------------

SLICE = {"h": 0.67810, "omega_b": 0.02238280, "omega_cdm": 0.1201075, "N_ur": 3.046,
         "A_s": 2.100549e-09, "n_s": 0.9660499, "tau_reio": 0.05430842,
         "output": "tCl,pCl,lCl,mPk,nCl", "l_max_scalars": 60,
         "P_k_max_1/Mpc": 0.2, "z_pk": "0.", "selection": "gaussian", "selection_mean": "1.0",
         "selection_width": "0.1", "l_max_lss": 40, "k_step_sub": 0.3,
         "k_step_super": 0.02, "k_step_super_reduction": 1.0, "selection_sampling": 12.5,
         "selection_sampling_bessel": 5.0, "selection_sampling_bessel_los": 5.0, **PR}


def _port(keys, cj):
    ct = T.Class(device="cpu")
    ct.set(dict(keys))
    bg, bidx = cj.cosmo.background
    ct.cosmo.set_stage("background", interop.background(asdict(bg), "cpu", names=bidx.names))
    ct.cosmo.set_stage("thermodynamics", interop.thermo(asdict(cj.cosmo.thermodynamics), "cpu"))
    ct.compute(["lensing"])
    return ct


@pytest.fixture(scope="module")
def slice_pair():
    """The Newtonian point through the JAX Class and through the port's
    Class(device="cpu") seeded with the JAX background and thermodynamics;
    and the port's synchronous run of the same point."""
    keys = dict(SLICE, gauge="newt")
    cj = J.Class()
    cj.set(dict(keys))
    cj.compute(["lensing"])
    return cj, _port(keys, cj), _port(dict(SLICE, gauge="synchronous"), cj)


def test_slice_matches_jax(slice_pair):
    cj, ct, _ = slice_pair
    assert ct.cosmo.params.gauge == cj.cosmo.params.gauge == "newtonian"
    np.testing.assert_array_equal(ct.cosmo.perturbations.k_np, cj.cosmo.perturbations.k_np)
    worst = {}
    for tag, got, ref in (("raw", ct.raw_cl(60), cj.raw_cl(60)),):
        assert sorted(got) == sorted(ref)
        for key in ref:
            r = np.asarray(ref[key])
            if key == "ell" or not np.abs(r).max():
                np.testing.assert_array_equal(got[key], r)
                continue
            worst[f"{tag} {key}"] = float(np.abs(np.asarray(got[key]) - r).max() / np.abs(r).max())
    assert {"raw dens[1]-dens[1]", "raw phi-dens[1]", "raw T-dens[1]"} <= set(worst)
    ks = np.geomspace(1e-3, 0.18, 12)
    pj = np.array([cj.pk_lin(k, 0.0) for k in ks])
    worst["pk_lin"] = float(np.max(np.abs(np.array([ct.pk_lin(k, 0.0) for k in ks]) / pj - 1)))
    print(f"Newtonian slice, port vs JAX relative to each spectrum's max: "
          f"worst {max(worst.values()):.3e} ({max(worst, key=worst.get)})")
    assert max(worst.values()) <= SLICE_TOL, worst


def test_gauges_agree_on_raw_tt(slice_pair):
    _, newt, sync = slice_pair
    a, b = sync.raw_cl(60)["tt"][2:], newt.raw_cl(60)["tt"][2:]
    rel = float(np.abs(b / a - 1.0).max())
    print(f"port raw TT, Newtonian against synchronous: {rel:.3e}")
    assert rel < GAUGE_TOL


# --- the classy surface -----------------------------------------------------


@pytest.mark.parametrize("value,want", [("new", "newtonian"), ("newt", "newtonian"),
                                        ("Newtonian", "newtonian"),
                                        ("synchronous", "synchronous")])
def test_gauge_parses_as_in_jax(value, want):
    for cls in (J.Class, T.Class):
        c = cls(device="cpu") if cls is T.Class else cls()
        c.set({"output": "tCl", "gauge": value})
        assert c.cosmo.params.gauge == want


@pytest.mark.parametrize("name", ["g9_newt", "row2_newt", "g8_newt", "g18_newt"])
def test_newtonian_configurations_parse_as_in_jax(name):
    """The configurations the card drives in the Newtonian gauge
    (tools/configs.py) read as the JAX classy reads them."""
    from classpp_public_torch.tools.configs import CONFIGS

    ct, cj = T.Class(device="cpu"), J.Class()
    ct.set(dict(CONFIGS[name]))
    cj.set(dict(CONFIGS[name]))
    pt, pj = ct.cosmo.params, cj.cosmo.params
    assert pt.gauge == pj.gauge == "newtonian"
    for f in ("h", "omega_b", "omega_cdm", "A_s", "n_s", "N_ur", "Omega_k", "tau_reio"):
        assert getattr(pt, f) == getattr(pj, f), f
    np.testing.assert_allclose(pt.m_ncdm, pj.m_ncdm, rtol=1e-7)
    for f in ("tCl", "pCl", "lCl", "mPk", "lensing", "modes", "l_scalar_max", "P_k_max"):
        assert getattr(ct.cosmo.out, f) == getattr(cj.cosmo.out, f), f


def test_gauge_refusals_mirror_jax():
    for cls, exc in ((J.Class, J.CosmoSevereError), (T.Class, T.CosmoSevereError)):
        c = cls(device="cpu") if cls is T.Class else cls()
        c.set({"output": "tCl", "gauge": "conformal"})
        with pytest.raises(exc, match="unknown gauge 'conformal'"):
            c.cosmo
    c = T.Class(device="cpu")
    c.set({"output": "tCl,mPk", "gauge": "newtonian", "Nbody gauge transfer functions": "yes"})
    with pytest.raises(NotImplementedError, match=r"classpp_public_tpu/classy\.py:462"):
        c.cosmo
    with pytest.raises(NotImplementedError,
                       match=r"nbody is not ported .*perturbations/indices\.py:89"):
        TIdx(gauge="newtonian", nbody=True)
    with pytest.raises(ValueError, match="unknown gauge"):
        TIdx(gauge="conformal")

"""Scalar-field dark energy (quintessence) in the port against
classpp_public_tpu on identical inputs (CPU), at small size.

- The Klein-Gordon march: `scf_march_plain` against the JAX `_integrate_scf`
  on a seeded background (1024 ln a nodes), with attractor and free initial
  conditions, alpha = 0 and alpha != 0: 1e-12 of each column's maximum
  (measured ~4e-15); the host build of the kernel's code (csrc/scf_march.cuh)
  on the same four chains in one batch against the plain loop: equal to the
  last bit (both run libm and the same order of operations, without FMA
  contraction).
- The background against JAX `compute_background` at background_Nloga =
  1024 for three points: tests/golden/gen/g13_scf.ini's (the field closes the
  budget, attractor initial conditions, lambda found by bisection: 2.085983,
  the reference's shooting), tests/test_class_matrix.py's Scalar_field case
  (Omega_scf = 0.1, "10, 0, 0, 0", bisection) and a free start tuned by the
  secant (Omega_scf = 0.2, lambda from 1.0, phi_ini = 17): every table column
  to 1e-10 of its maximum (rho_lambda, ~1e-17 when the field closes the
  budget, to 1e-20 absolute) and the tuned parameter to 1e-9.
- The state layout (the (delta phi, delta phi') rows after the ncdm block, as
  JAX's), and the scf right-hand side and sources: `rhs_full` on seeded random
  states, every combination of the (tca, rsa, ufa, ncdm fluid) flags forced on
  both sides, and `compute_sources`, on interop tables, flat g13 and a closed
  point with one ncdm species: 1e-12 of the lane's largest |dy| and of each
  source column's maximum.
- The host build of perturb_ark's scf instance against the plain integrator
  on three lanes (the lowest k, a CMB lane, a P(k)-tail lane whose scf rows
  keep the tight rtol), flat and closed: 1e-12 of each source column's
  maximum, equal step counts.
- `Class(device="cpu")` at g13_scf's parameters (tCl, pCl and P(k): l_max
  60, P(k) to 0.1/Mpc, the k steps of tests/test_torch_newtonian.py's point;
  without lCl, whose l_max_lss of 300 would sample k to 0.27/Mpc, where each
  lane's delta phi takes ~4 000 steps) against the JAX `Class`, seeded with
  the JAX background and thermodynamics: raw TT, EE, TE and P(k) on the CMB
  lanes (k <= 0.017/Mpc) to 1e-6 of each spectrum's maximum; P(k) on the
  P(k)-tail lanes to 1e-3 (10 rtol): their loosened radiation rows, and delta
  phi below their 3e-8 atol, let two integrations part by their tolerance
  (measured 5.8e-4; 5.1e-5 without the field).
- The classy surface (the keys parse as in JAX, JAX's refusals), scf with
  gauge = newtonian raising NotImplementedError with the JAX lines it needs,
  and the `scf_march` wrapper raising rather than falling back off the CPU.
"""

import ctypes
import math
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
from classpp_public_torch.config.params import CosmoParams as TParams
from classpp_public_torch.config.precision import PrecisionParams as TPrec
from classpp_public_torch.models import background as tbg
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
MARCH_TOL, BG_TOL, TUNE_TOL = 1e-12, 1e-10, 1e-9
RHS_TOL, SRC_TOL, HOST_TOL, SLICE_TOL, TAIL_TOL = 1e-12, 1e-12, 1e-12, 1e-6, 1e-3
G13 = dict(h=0.67810, omega_b=0.02238280, omega_cdm=0.1201075, N_ur=3.046, Omega_scf=-1.0,
           scf_parameters=(10.0, 0.0, 0.0, 0.0, 100.0, 0.0), scf_tuning_index=0,
           attractor_ic_scf=True)
BACKGROUNDS = {"g13": G13,
               "matrix": dict(Omega_scf=0.1, scf_parameters=(10.0, 0.0, 0.0, 0.0)),
               "secant": dict(Omega_scf=0.2, scf_parameters=(1.0, 0.0, 0.0, 0.0, 17.0, 0.0),
                              attractor_ic_scf=False)}
CASES = {"g13": G13,
         "closed_ncdm1": dict(BACKGROUNDS["matrix"], m_ncdm=(0.06,), N_ur=2.0328,
                              Omega_k=-0.01)}


def t64(a):
    return torch.as_tensor(np.ascontiguousarray(a), dtype=torch.float64)


def _host_lib(src, tmp_path):
    gxx = shutil.which("g++")
    if gxx is None:
        pytest.skip("no g++ to build the host version of the kernel's code")
    so = tmp_path / f"lib{src}.so"
    subprocess.run([gxx, "-O2", "-std=c++17", "-shared", "-fPIC", "-o", str(so),
                    str(Path(cuda.CSRC_DIR) / f"{src}.cpp")], check=True)
    return ctypes.CDLL(str(so))


P, I, D, L = ctypes.c_void_p, ctypes.c_int, ctypes.c_double, ctypes.c_longlong

# --- the Klein-Gordon march --------------------------------------------------

# (lambda, alpha, A, B), phi_ini, phi_prime_ini, attractor
CHAINS = {"attractor": ((3.0, 0.0, 0.0, 0.0), 1.0, 1.0, True),
          "attractor_alpha": ((4.0, 2.0, 0.3, 2.0), 1.0, 1.0, True),
          "free": ((1.0, 0.0, 0.0, 0.0), 17.0, 0.0, False),
          "free_alpha": ((1.0, 2.0, 1.0, 15.0), 17.0, 1e-9, False)}


@pytest.fixture(scope="module")
def march_inputs():
    """A background on 1024 uniform ln a nodes from a = 1e-14: radiation and
    matter densities with 1e-3 seeded noise (numpy), and a small curvature."""
    rng = np.random.default_rng(13)
    loga = np.linspace(math.log(1e-14), 0.0, 1024)
    a = np.exp(loga)
    H0 = 2.26e-4
    rho_base = H0**2 * (9e-5 * a**-4 + 0.31 * a**-3) * (1.0 + 1e-3 * rng.standard_normal(1024))
    return loga, a, rho_base, -0.01 * H0**2, float(rho_base[0])


@pytest.mark.parametrize("chain", list(CHAINS))
def test_scf_march_plain_matches_jax(march_inputs, chain):
    loga, a, rho_base, rhoK0, rho_rad = march_inputs
    p4, phi_ini, phip_ini, att = CHAINS[chain]
    ref = np.asarray(jbg._integrate_scf(jnp.asarray(p4), jnp.asarray(loga), jnp.asarray(a),
                                        jnp.asarray(rho_base), rhoK0, rho_rad, phi_ini, phip_ini,
                                        att))
    got = tbg.scf_march_plain(t64([p4]), t64(loga), t64(a), torch.log(t64(rho_base)), rhoK0,
                              rho_rad, phi_ini, phip_ini, att)
    assert got.shape == (1, len(loga), 2) and np.isfinite(ref).all()
    got = got[0].numpy()
    err = [np.abs(got[:, i] - ref[:, i]).max() / np.abs(ref[:, i]).max() for i in range(2)]
    print(f"{chain}: plain against JAX, phi {err[0]:.3e}, phi' {err[1]:.3e}")
    assert max(err) <= MARCH_TOL
    # rho_scf and p_scf of the table follow from (phi, phi') as in JAX :356-363
    V = tbg._scf_potential(t64(got[:, 0]), *p4)[0].numpy()
    kin = got[:, 1] ** 2 / (2.0 * a * a)
    for col, mine in ((2, (kin + V) / 3.0), (3, (kin - V) / 3.0)):
        assert np.abs(mine - ref[:, col]).max() <= MARCH_TOL * np.abs(ref[:, col]).max()


def test_scf_march_on_host(march_inputs, tmp_path):
    """csrc/scf_march.cuh built for the host: the four chains, a batch of two
    per initial-condition kind as the kernel takes them (one attractor flag a
    launch), against the plain loop."""
    loga, a, rho_base, rhoK0, rho_rad = march_inputs
    lib = _host_lib("scf_march_host", tmp_path)
    lib.scf_march_host.argtypes = [P, P, P, I, D, P, I, D, D, D, I, P, P]
    lib.scf_march_coef_doubles.restype = ctypes.c_long
    lnrho = torch.log(t64(rho_base))
    n = len(loga)
    for att in (True, False):
        names = [c for c, v in CHAINS.items() if v[3] == att]
        p4 = t64([CHAINS[c][0] for c in names])
        _, phi_ini, phip_ini, _ = CHAINS[names[0]]
        if not att:   # one start for the batch: the second chain's
            phi_ini, phip_ini = CHAINS[names[1]][1:3]
        coef = torch.empty(lib.scf_march_coef_doubles(n), dtype=torch.float64)
        Y = torch.empty((len(names), n, 2), dtype=torch.float64)
        la, aa = t64(loga), t64(a)
        rc = lib.scf_march_host(la.data_ptr(), aa.data_ptr(), lnrho.data_ptr(), n, rhoK0,
                                p4.data_ptr(), len(names), rho_rad, phi_ini, phip_ini, int(att),
                                coef.data_ptr(), Y.data_ptr())
        assert rc == 0
        plain = tbg.scf_march_plain(p4, la, aa, lnrho, rhoK0, rho_rad, phi_ini, phip_ini, att)
        assert torch.isfinite(plain).all()
        assert torch.equal(Y, plain), float((Y - plain).abs().max())
    # more chains than a warp is refused
    assert lib.scf_march_host(la.data_ptr(), aa.data_ptr(), lnrho.data_ptr(), n, rhoK0,
                              p4.data_ptr(), 33, rho_rad, phi_ini, phip_ini, 0,
                              coef.data_ptr(), Y.data_ptr()) != 0


def test_scf_march_wrapper_does_not_fall_back(march_inputs):
    """On a CPU tensor the wrapper is the plain version and launches nothing;
    on any other device it launches the kernel or raises."""
    loga, a, rho_base, rhoK0, rho_rad = march_inputs
    p4, phi_ini, phip_ini, att = CHAINS["attractor"]
    args = (t64(loga), t64(a), torch.log(t64(rho_base)), rhoK0, rho_rad, phi_ini, phip_ini, att)
    before = tbg.scf_launches
    assert torch.equal(tbg.scf_march(t64([p4]), *args), tbg.scf_march_plain(t64([p4]), *args))
    assert tbg.scf_launches == before
    meta = [v.to("meta") if torch.is_tensor(v) else v for v in args]
    with pytest.raises(ValueError, match="unsupported device"):
        tbg.scf_march(t64([p4]).to("meta"), *meta)


# --- the background ----------------------------------------------------------

_BG = {}


def backgrounds(case):
    """The JAX and the port's background of a case (computed once)."""
    if case not in _BG:
        kw = BACKGROUNDS.get(case) or CASES[case]
        jb = jbg.compute_background(CosmoParams(**kw), PrecisionParams(**PR))
        tb = tbg.compute_background(TParams(**kw), TPrec(**PR), device="cpu")
        _BG[case] = jb, tb
    return _BG[case]


@pytest.mark.parametrize("case", list(BACKGROUNDS))
def test_background_matches_jax(case):
    (bj, ij), (bt, it) = backgrounds(case)
    assert list(ij.names) == it.names and it.has_scf
    kw = BACKGROUNDS[case]
    ti = kw.get("scf_tuning_index", 0)
    tab_j, tab_t = np.asarray(bj.table), bt.table.numpy()
    worst = {}
    for name in it.names:
        c = it[name]
        if name == "rho_lambda" and kw["Omega_scf"] < 0:
            assert np.abs(tab_t[:, c] - tab_j[:, c]).max() <= 1e-20
            continue
        scale = np.abs(tab_j[:, c]).max()
        worst[name] = float(np.abs(tab_t[:, c] - tab_j[:, c]).max() / max(scale, 1e-300))
    print(f"{case}: a walk of {len(bt.scf_walk)} shots, tuned {bt.scf_parameters[ti]!r}; worst column "
          f"{max(worst, key=worst.get)} {max(worst.values()):.3e}")
    assert max(worst.values()) <= BG_TOL, worst
    # the tuned parameter: JAX's is the one inside its table's potential
    Om = float(tab_j[-1, ij["rho_scf"]]) / float(bj.H0) ** 2
    assert abs(bt.tau0 / float(bj.tau0) - 1.0) <= BG_TOL
    phi = t64(tab_j[:, ij["phi_scf"]])
    pars = list(bt.scf_parameters[:4])
    V_jax = tab_j[:, ij["V_scf"]]
    assert np.abs(tbg._scf_potential(phi, *pars)[0].numpy() - V_jax).max() \
        <= TUNE_TOL * np.abs(V_jax).max()
    target = kw["Omega_scf"] if kw["Omega_scf"] > 0 else Om
    assert abs(float(tab_t[-1, it["rho_scf"]]) / bt.H0**2 / target - 1.0) <= 1e-8
    if case == "g13":
        # the reference's shooting found lambda = 2.085983, Omega_scf = 0.690026
        # (tests/test_scf.py)
        assert abs(bt.scf_parameters[0] / 2.085983 - 1.0) < 1e-6
        assert abs(Om / 0.690026 - 1.0) < 1e-4
    if case == "secant":
        assert len(bt.scf_walk) < 10 and bt.scf_parameters[0] != 1.0


# --- the perturbations -------------------------------------------------------


def test_state_layout_matches_jax():
    for n in (0, 1, 3):
        t, j = TIdx(n_ncdm=n, has_scf=True), JIdx(n_ncdm=n, has_scf=True)
        for f in ("phi_scf_pt", "phi_prime_scf_pt", "ncdm", "eta", "size", "radiation_slices"):
            assert getattr(t, f) == getattr(j, f), (n, f)
        ints = tsolve._layout_ints(t)
        assert len(ints) == tsolve.LAYOUT_INTS and ints[-1] == t.phi_scf_pt
        assert tsolve.work_doubles(t) == tsolve.work_doubles(TIdx(n_ncdm=n)) + 9 * 2 + 4
    assert tsolve._layout_ints(TIdx())[-1] == -1
    with pytest.raises(NotImplementedError, match="equations.py:401-407"):
        TIdx(has_scf=True, gauge="newtonian")


class Setup:
    """One scf cosmology: the JAX stages and the port's views of them, eight
    lanes from 1e-4 (closed: 5e-4) to 0.3/Mpc on the JAX schedule."""

    def __init__(self, case):
        kw = CASES[case]
        self.params = CosmoParams(**kw)
        self.pr = pr = PrecisionParams(**PR)
        n = self.params.N_ncdm
        (self.bg, self.bidx), _ = backgrounds(case) if case in BACKGROUNDS else (
            jbg.compute_background(self.params, pr), None)
        self.th = jth.compute_thermodynamics(self.params, pr, self.bg, self.bidx)
        ok = kw.get("Omega_k", 0.0)
        self.K = -ok * float(self.bg.H0) ** 2
        self.sgnK = 0 if ok == 0.0 else (1 if self.K > 0 else -1)
        self.taus = np.asarray(jg.get_tau_sampling(self.params, pr, self.bg, self.bidx,
                                                   self.th))
        ks = np.geomspace(1e-4 if not self.sgnK else 5e-4, 0.3, 8)
        self.sched = jg.get_k_schedule(ks, pr, self.bg, self.bidx, self.th,
                                       tau_first_sample=float(self.taus[0]), n_ncdm=n)
        self.jidx = JIdx(pr.l_max_g, pr.l_max_pol_g, pr.l_max_ur, n_ncdm=n, has_scf=True,
                         sgnK=self.sgnK)
        self.jncdm = jsolve.make_ncdm_ctx(self.params, self.bg, self.jidx, self.bidx) if n \
            else None
        self.tidx = TIdx(n_ncdm=n, has_scf=True, sgnK=self.sgnK)
        bgt, bit = interop.background(asdict(self.bg), "cpu", names=self.bidx.names)
        assert bit.has_scf
        tht = interop.thermo(asdict(self.th), "cpu")
        nct = interop.ncdm_ctx(asdict(self.jncdm), "cpu") if n else None
        self.tables = teq.make_tables(bgt, bit, tht, self.tidx, nct, self.K)
        s = self.sched
        t_ncfa = s.tau_ncdmfa_on if n else np.full_like(ks, np.inf)
        self.lanes = tsolve.Lanes(t64(s.k), t64(s.tau_ini), t64(s.tau_tca_off),
                                  t64(s.tau_ufa_on), t64(s.tau_rsa_on), t64(t_ncfa))
        self.eta_off = tsolve._eta_off(self.lanes.k)

        def one(tau, y, k, tca, rsa, ufa, ncfa, eta_off):
            c = jeq.PertCtx(k=k, tca_on=tca, rsa_on=rsa, ufa_on=ufa,
                            bg_spline=self.bg.lntau_spline, th_spline=self.th.lntau_spline,
                            bidx=self.bidx, idx=self.jidx, ncdmfa_on=ncfa, ncdm=self.jncdm,
                            eta_off=eta_off, K=self.K)
            return jeq.rhs(tau, y, c), jeq.compute_sources(tau, y, c)

        self.jax_rows = jax.jit(jax.vmap(one))


_SETUPS = {}


@pytest.fixture(scope="module", params=list(CASES))
def setup(request):
    if request.param not in _SETUPS:
        _SETUPS[request.param] = Setup(request.param)
    return _SETUPS[request.param]


FLAGS = np.array([[(c >> b) & 1 for b in range(4)] for c in range(16)], dtype=bool)


@pytest.mark.parametrize("when", ["early", "recombination", "late"])
def test_rhs_and_sources_match_jax(setup, when):
    """Seeded random states (the initial state scaled by 1 + 0.3 N(0, 1) plus
    noise in every slot, the scf rows included) under every flag combination;
    `early` (tight coupling, where the visibility is ~1e-47) holds the
    right-hand side only."""
    s = setup.sched
    tau = {"early": np.sqrt(s.tau_ini * s.tau_tca_off),
           "recombination": np.full(len(s.k), float(setup.th.tau_rec)),
           "late": np.minimum(np.maximum(s.tau_rsa_on, s.tau_tca_off) * 1.5,
                              0.9 * float(setup.bg.tau0))}[when]
    rng = np.random.default_rng(31)
    ctx0 = tsolve._ctx(setup.lanes, t64(tau), setup.eta_off, setup.tables)
    y0 = teq.initial_conditions(teq.frame_at(t64(tau), setup.tables), ctx0).numpy()
    assert not y0[:, setup.tidx.phi_scf_pt:setup.tidx.eta].any()   # delta phi = 0 at the start
    scale = np.abs(y0).max(axis=1, keepdims=True)
    y = y0 * (1.0 + 0.3 * rng.standard_normal(y0.shape)) \
        + 1e-3 * scale * rng.standard_normal(y0.shape)
    nl, nf = y.shape[0], len(FLAGS)
    yy, tt = np.repeat(y, nf, axis=0), np.repeat(tau, nf)
    fl = np.tile(FLAGS, (nl, 1))
    lanes = setup.lanes.take(torch.arange(nl).repeat_interleave(nf))
    eo = setup.eta_off.repeat_interleave(nf)
    ctx = tsolve._ctx(lanes, t64(tt), eo, setup.tables)
    ctx = ctx._replace(**{f: torch.as_tensor(fl[:, i]) for i, f in
                          enumerate(("tca_on", "rsa_on", "ufa_on", "ncdmfa_on"))})
    fr = teq.frame_at(t64(tt), setup.tables)
    dy = teq.rhs(fr, t64(yy), ctx).numpy()
    src = teq.compute_sources(fr, t64(yy), ctx).numpy()
    ref_dy, ref_src = (np.asarray(v) for v in setup.jax_rows(
        jnp.asarray(tt), jnp.asarray(yy), jnp.asarray(np.repeat(s.k, nf)),
        *(jnp.asarray(fl[:, i]) for i in range(4)), jnp.asarray(eo.numpy())))
    assert np.isfinite(dy).all() and np.isfinite(src).all()
    # the Klein-Gordon rows are live
    assert np.abs(ref_dy[:, setup.tidx.phi_prime_scf_pt]).max() > 0.0
    err = np.abs(dy - ref_dy).max(axis=1) / np.abs(ref_dy).max(axis=1)
    print(f"rhs ({when}): worst {err.max():.3e} of the lane's largest |dy|")
    assert err.max() <= RHS_TOL, (int(err.argmax()) // nf, FLAGS[int(err.argmax()) % nf])
    if when == "early":
        return
    worst = {}
    for i, name in enumerate(SrcIdx.names):
        sc = np.abs(ref_src[:, i]).max()
        worst[name] = float(np.abs(src[:, i] - ref_src[:, i]).max() / max(sc, 1e-300))
    print(f"sources ({when}): worst {max(worst.values()):.3e} ({max(worst, key=worst.get)})")
    assert max(worst.values()) <= SRC_TOL, worst


def test_kernel_lane_program_on_host(setup, tmp_path):
    """The scf instance of csrc/perturb_ark.cuh built for the host against the
    plain integrator: the lowest-k lane and one at 0.02/Mpc under the CMB
    tolerances, the next-to-highest (0.12-0.15/Mpc) under the P(k)-tail ones
    (the radiation rows loosened, the scf rows at the tight rtol), on every
    third sample time. On the closed point with ncdm only the two CMB lanes:
    there the tail's 3e-8 atol leaves delta phi (below it) unresolved on the
    tail lane, and the two integrations' last bits lead its noise apart
    (measured 6.7e-5 of theta_tot's maximum with equal step counts, and none
    above 1e-12 with the scf rows at atol 1e-16)."""
    lib = _host_lib("perturb_ark_host", tmp_path)
    lib.perturb_ark_host_scf.argtypes = [P, P, P, P, P, D, D, I, P, P, D, D, I, P, P, P, D, D,
                                         I, L, I, I, P, P, P, P]
    k = setup.lanes.k
    sel = torch.as_tensor([0, int(torch.searchsorted(k, 0.02))] + ([] if setup.sgnK
                                                                     else [len(k) - 2]))
    lanes = setup.lanes.take(sel)
    idx, tb = setup.tidx, setup.tables
    kn = lanes.k.numpy()
    rt_c, at_c = tsolve._tolerances(kn[:2], idx, TPrec(**PR), False, 0.0)
    # a tail lane within the lensing potential's reach (k_pp_max 1/Mpc)
    rt_t, at_t = tsolve._tolerances(kn[-1:], idx, TPrec(**PR), True, 1.0)
    assert rt_t[0, idx.delta_g] > RTOL and rt_t[0, idx.phi_scf_pt] == RTOL \
        and rt_t[0, idx.phi_prime_scf_pt] == RTOL
    tol = (t64(np.concatenate([rt_c, rt_t[:len(kn) - 2]])),
           t64(np.concatenate([at_c, at_t[:len(kn) - 2]])))
    taus = t64(setup.taus[::3])
    nl, ntau = len(sel), len(taus)
    St, nt = tsolve.integrate_sources(lanes, taus, tb, tol)
    lane_tab = torch.stack(list(lanes)).contiguous()
    nc = torch.cat([v.reshape(-1) for v in tb.ncdm]) if idx.n_ncdm else None
    work = torch.empty(tsolve.work_doubles(idx), dtype=torch.float64)
    S = torch.empty((nl, ntau, SrcIdx.n), dtype=torch.float64)
    nsteps = torch.zeros(nl, dtype=torch.long)
    status = torch.ones(nl, dtype=torch.int32)
    layout = (ctypes.c_int * tsolve.LAYOUT_INTS)(*tsolve._layout_ints(idx))
    args = (lane_tab.data_ptr(), taus.data_ptr(), tb.bg.y.data_ptr(), tb.bg.y2.data_ptr(),
            tb.bg.x0, tb.bg.dx, tb.bg.n, tb.th.y.data_ptr(), tb.th.y2.data_ptr(), tb.th.x0,
            tb.th.dx, tb.th.n, nc.data_ptr() if idx.n_ncdm else None, tol[0].data_ptr(),
            tol[1].data_ptr(), tsolve.K_ETA_SPLIT, setup.K, setup.sgnK, tsolve.MAX_ITERATIONS,
            nl, ntau, work.data_ptr(), S.data_ptr(), nsteps.data_ptr(), status.data_ptr())
    assert lib.perturb_ark_host_scf(layout, *args) == 0 and not status.any()
    np.testing.assert_array_equal(nsteps.numpy(), nt.numpy())
    worst = {}
    for i, name in enumerate(SrcIdx.names):
        sc = float(St[:, :, i].abs().max())
        worst[name] = float((S[:, :, i] - St[:, :, i]).abs().max()) / max(sc, 1e-300)
    print(f"host build vs plain: steps {nt.tolist()}, worst {max(worst.values()):.3e} "
          f"({max(worst, key=worst.get)})")
    assert max(worst.values()) <= HOST_TOL, worst
    # the scf entry refuses a layout without the field
    plain = (ctypes.c_int * tsolve.LAYOUT_INTS)(*tsolve._layout_ints(
        TIdx(n_ncdm=idx.n_ncdm, sgnK=idx.sgnK)))
    assert lib.perturb_ark_host_scf(plain, *args) != 0


# --- the whole slice ---------------------------------------------------------

SLICE = {"h": 0.67810, "omega_b": 0.02238280, "omega_cdm": 0.1201075, "N_ur": 3.046,
         "A_s": 2.100549e-09, "n_s": 0.9660499, "tau_reio": 0.05430842, "YHe": 0.2454006,
         "Omega_Lambda": 0, "Omega_fld": 0, "Omega_scf": -1, "attractor_ic_scf": "yes",
         "scf_parameters": "10.0, 0.0, 0.0, 0.0, 100.0, 0.0", "scf_tuning_index": 0,
         "output": "tCl,pCl,mPk", "l_max_scalars": 60, "P_k_max_1/Mpc": 0.1, "z_pk": "0.",
         "k_step_sub": 0.3, "k_step_super": 0.02, "k_step_super_reduction": 1.0, **PR}


def test_slice_matches_jax():
    """g13_scf's parameters at small size through the JAX Class and through the
    port's Class(device="cpu") seeded with the JAX background and
    thermodynamics (the tau sampling follows the last bits of the
    thermodynamics table)."""
    cj = J.Class()
    cj.set(dict(SLICE))
    cj.compute(["spectra"])
    ct = T.Class(device="cpu")
    ct.set(dict(SLICE))
    bg, bidx = cj.cosmo.background
    ct.cosmo.set_stage("background", interop.background(asdict(bg), "cpu", names=bidx.names))
    ct.cosmo.set_stage("thermodynamics", interop.thermo(asdict(cj.cosmo.thermodynamics), "cpu"))
    ct.compute(["spectra"])
    assert ct.cosmo.params.Omega_scf == -1.0
    np.testing.assert_array_equal(ct.cosmo.perturbations.k_np, cj.cosmo.perturbations.k_np)
    worst = {}
    for tag, got, ref in (("raw", ct.raw_cl(60), cj.raw_cl(60)),):
        for key in ("tt", "ee", "te"):
            r = np.asarray(ref[key])
            worst[f"{tag} {key}"] = float(np.abs(np.asarray(got[key]) - r).max()
                                          / np.abs(r).max())
    pt = ct.cosmo.perturbations
    k_cmb = float(pt.k_np[pt.k_size_cmb - 1])
    ks = np.geomspace(1e-3, 0.09, 12)
    pj = np.array([cj.pk_lin(k, 0.0) for k in ks])
    rel = np.abs(np.array([ct.pk_lin(k, 0.0) for k in ks]) / pj - 1)
    worst["pk_lin"] = float(rel[ks <= k_cmb].max())
    tail = float(rel[ks > k_cmb].max())
    print(f"scf slice, port vs JAX relative to each spectrum's max: worst "
          f"{max(worst.values()):.3e} ({max(worst, key=worst.get)}); P(k) beyond the CMB lanes "
          f"(k > {k_cmb:.4g}/Mpc) {tail:.3e}")
    assert 0.01 < k_cmb < 0.05 and (ks > k_cmb).sum() >= 4
    assert max(worst.values()) <= SLICE_TOL, worst
    assert tail <= TAIL_TOL


# --- the classy surface ------------------------------------------------------


def test_scf_parses_as_in_jax():
    from classpp_public_torch.tools.configs import CONFIGS

    ct, cj = T.Class(device="cpu"), J.Class()
    ct.set(dict(CONFIGS["g13_scf"]))
    cj.set(dict(CONFIGS["g13_scf"]))
    pt, pj = ct.cosmo.params, cj.cosmo.params
    for f in ("Omega_scf", "scf_parameters", "scf_tuning_index", "attractor_ic_scf", "use_fld",
              "h", "omega_b", "omega_cdm", "A_s", "tau_reio", "YHe"):
        assert getattr(pt, f) == getattr(pj, f), f
    for f in ("tCl", "pCl", "lCl", "mPk", "lensing", "l_scalar_max", "P_k_max"):
        assert getattr(ct.cosmo.out, f) == getattr(cj.cosmo.out, f), f
    ct = T.Class(device="cpu")
    ct.set({"Omega_scf": 0.1, "scf_parameters": "10, 0, 0, 0", "attractor_ic_scf": "no"})
    assert ct.cosmo.params.attractor_ic_scf is False


@pytest.mark.parametrize("keys,match", [
    ({"Omega_scf": 0.1}, "Omega_scf requires scf_parameters"),
    ({"Omega_scf": -1, "scf_parameters": "10, 0, 0, 0", "Omega_Lambda": 0.7},
     "requires Omega_Lambda = 0 and Omega_fld = 0"),
    ({"scf_lambda": 3.0}, "not implemented yet: 'scf_lambda'")])
def test_scf_refusals_mirror_jax(keys, match):
    for cls, exc in ((J.Class, J.CosmoSevereError), (T.Class, T.CosmoSevereError)):
        c = cls(device="cpu") if cls is T.Class else cls()
        c.set(dict(keys, output="tCl"))
        with pytest.raises(exc, match=match):
            c.compute()


def test_scf_in_the_newtonian_gauge_raises():
    c = T.Class(device="cpu")
    c.set(dict(SLICE, gauge="newtonian"))
    with pytest.raises(NotImplementedError,
                       match=r"equations\.py:401-407.*:1374-1385"):
        c.compute(["lensing"])

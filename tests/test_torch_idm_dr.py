"""Interacting dark matter with interacting dark radiation (ETHOS idm_dr) in
the port against classpp_public_tpu on identical inputs (CPU), at small size.

- The classy surface: every input form (N_idr or xi_idr; Omega_idm_dr,
  omega_idm_dr or f_idm_dr, the last with the synchronous gauge's cdm floor;
  the *_dark aliases, the canonical name winning; short alpha/beta lists)
  gives the JAX Class's parameter fields; idr_nature = nonsense raises as in
  JAX; idm_dr in the Newtonian gauge and idm_dr with a scalar field raise
  NotImplementedError naming the JAX lines.
- The background against JAX `compute_background` at background_Nloga =
  1024 for tests/golden/gen/g17_idm_dr.ini's point: every column to 1e-10 of
  its maximum.
- The T_idm march: `idm_march_plain` on the very grid, H, T_idr and heating
  rate of JAX's thermodynamics against the idm sound speed JAX tabulates
  (thermodynamics.py:1007-1027). In the tight-coupling era T_idr - T_idm is
  below T's last bit and the sound speed multiplies it by Gamma/H (up to
  ~1e17), so there each implementation's c^2 is its own rounding noise (JAX's
  column jumps from 13.5 to 214 and back between neighbouring nodes): c^2 is
  held per node to 1e-12 max(1, 1e-3 Gamma/H) of its value, which is 1e-12
  wherever Gamma/H <= 1e3 (measured 1.1e-13 there); T_idm is held to T_idr
  to 1e-12 where Gamma/H >= 1e6. The host build of csrc/idm_march.cuh equals
  the plain loop to the last bit (both round every operation alone).
- The state layout with idm_dr, free-streaming and fluid, with and without
  one ncdm species, equals JAX's.
- `rhs_full`, `compute_sources`, `stiff_apply` and `stiff_solve` on seeded
  random states under every (tca, rsa, ufa, ncdm fluid) combination, and the
  adiabatic initial conditions, on interop tables of g17 (the g34 alpha/beta
  lists) and of a fluid-idr point with one ncdm species: 1e-12 of the lane's
  largest |dy| and of each source column's maximum; (I - gh J) stiff_solve(r)
  = r for gh in {1e-4, 1, 1e4} with non-uniform alpha_l.
- The host build of perturb_ark's idm instance against the plain integrator
  on three lanes (the lowest k, one at the dark-acoustic scale k ~ 0.03/Mpc,
  one on the P(k) tail), on both points: 1e-12 of each source column's
  maximum (measured 0 and 2.4e-14), equal step counts.
- `Class(device="cpu")` at g17's physics (tCl, pCl, P(k) to 0.08/Mpc, l_max
  60, the k steps of tests/test_torch_newtonian.py's point) against the JAX
  Class, seeded with the JAX background and thermodynamics: raw TT, EE, TE
  to 1e-6 of each spectrum's maximum and P(k) at the CMB lanes' k to 1e-6
  (measured 1.9e-7), P(k) at the P(k)-tail lanes' k to 1e-3 (their loosened
  radiation and idr rows; measured 3.1e-4); and the dark acoustic
  suppression that JAX's
  tests/test_idm_dr.py::test_pk_suppression means to check, with a valid
  input (no `lensing` beside mPk): P_idm(k) < 0.95 P_LCDM(k) at the largest
  k of the run (measured 0.92).
"""

import ctypes
import dataclasses
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
from classpp_public_torch.models import background as tbg
from classpp_public_torch.models import thermodynamics as tth
from classpp_public_torch.models.perturbations import equations as teq
from classpp_public_torch.models.perturbations import solve as tsolve
from classpp_public_torch.models.perturbations.indices import PtIdx as TIdx
from classpp_public_torch.models.perturbations.indices import SrcIdx
from classpp_public_torch.ops import cuda
import classpp_public_tpu as J
from classpp_public_tpu import PrecisionParams
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
BG_TOL, MARCH_TOL = 1e-10, 1e-12
RHS_TOL, SRC_TOL, HOST_TOL, SLICE_TOL, TAIL_TOL = 1e-12, 1e-12, 1e-12, 1e-6, 1e-3
# tests/golden/gen/g17_idm_dr.ini and g34_idmdr_l.ini
G17_KEYS = {"h": 0.67810, "T_cmb": 2.7255, "omega_b": 0.02238280, "omega_cdm": 0.1201075,
            "N_ur": 3.046, "A_s": 2.100549e-09, "n_s": 0.9660499, "tau_reio": 0.05430842,
            "YHe": 0.2454006, "N_idr": 0.5, "f_idm_dr": 1.0, "a_idm_dr": 1.0e3,
            "nindex_idm_dr": 4, "m_idm": 1.0e9}
G34_LISTS = {"alpha_idm_dr": "1.0, 1.2, 1.4", "beta_idr": "0.5, 1.0"}


def t64(a):
    return torch.as_tensor(np.array(a, dtype=np.float64))


def _host_lib(src, tmp_path):
    gxx = shutil.which("g++")
    if gxx is None:
        pytest.skip("no g++ to build the host version of the kernel's code")
    so = tmp_path / f"lib{src}.so"
    subprocess.run([gxx, "-O2", "-std=c++17", "-shared", "-fPIC", "-o", str(so),
                    str(Path(cuda.CSRC_DIR) / f"{src}.cpp")], check=True)
    return ctypes.CDLL(str(so))


P, I, D, L = ctypes.c_void_p, ctypes.c_int, ctypes.c_double, ctypes.c_longlong

# --- the classy surface ------------------------------------------------------

FORMS = {
    "g17": G17_KEYS,
    "g34_lists": dict(G17_KEYS, **G34_LISTS),
    "xi_omega": dict(G17_KEYS, xi_idr=0.3, omega_idm_dr=0.02, f_idm_dr=None, N_idr=None),
    "Omega_fluid": dict(G17_KEYS, Omega_idm_dr=0.05, f_idm_dr=None, idr_nature="fluid",
                        stat_f_idr=1.0, b_idr=2.0, nindex_idm_dr=2),
    "dark_aliases": dict(G17_KEYS, a_idm_dr=None, nindex_idm_dr=None, a_dark=500.0,
                         b_dark=1.0, nindex_dark=2, alpha_dark="1.1, 1.3", beta_dark=0.8),
    "canonical_wins": dict(G17_KEYS, a_dark=5.0, nindex_dark=2, alpha_dark="9, 9",
                           alpha_idm_dr="1.5, 1.2"),
    "half_fraction": dict(G17_KEYS, f_idm_dr=0.5),
}
PARAM_FIELDS = ("Omega_idm_dr", "xi_idr", "stat_f_idr", "a_idm_dr", "b_idr", "nindex_idm_dr",
                "m_idm", "idr_nature", "alpha_idm_dr", "beta_idr", "omega_cdm", "h", "omega_b")


@pytest.mark.parametrize("form", list(FORMS))
def test_idm_parses_as_in_jax(form):
    keys = {k: v for k, v in FORMS[form].items() if v is not None}
    ct, cj = T.Class(device="cpu"), J.Class()
    ct.set(dict(keys, output="tCl"))
    cj.set(dict(keys, output="tCl"))
    pt, pj = ct.cosmo.params, cj._build().params
    for f in PARAM_FIELDS:
        assert getattr(pt, f) == getattr(pj, f), (f, getattr(pt, f), getattr(pj, f))
    if form == "g17":
        # f_idm_dr = 1 moves all of omega_cdm over; the synchronous gauge keeps
        # the floor Omega0_cdm_min_synchronous = 1e-10 of it
        assert pt.omega_cdm == 1e-10 * 0.67810**2 and pt.Omega_idm_dr < 0.1201075 / 0.67810**2
    if form == "g34_lists":
        idx = TIdx(has_idm_dr=True, l_max_idr=6, alpha_idm_dr=pt.alpha_idm_dr,
                   beta_idr=pt.beta_idr)
        assert idx.idr_damping_coeffs() == ((1.0, 1.2, 1.4, 1.4, 1.4), (0.5, 1.0, 1.0, 1.0, 1.0))
        assert idx.idr_damping_coeffs() == JIdx(
            has_idm_dr=True, l_max_idr=6, alpha_idm_dr=pj.alpha_idm_dr,
            beta_idr=pj.beta_idr).idr_damping_coeffs()


@pytest.mark.parametrize("keys,match", [
    ({"idr_nature": "nonsense"}, "unknown idr_nature"),
    ({"N_idr": None, "xi_idr": None}, "requires N_idr or xi_idr"),
    ({"f_idm_dr": None}, "requires Omega_idm_dr, omega_idm_dr or f_idm_dr")])
def test_idm_errors_mirror_jax(keys, match):
    kw = {k: v for k, v in dict(G17_KEYS, **keys).items() if v is not None}
    if "N_idr" not in kw and "xi_idr" not in kw:
        kw["Omega_idm_dr"] = 0.05
    for cls, exc in ((J.Class, J.CosmoSevereError), (T.Class, T.CosmoSevereError)):
        c = cls(device="cpu") if cls is T.Class else cls()
        c.set(dict(kw, output="tCl"))
        with pytest.raises(exc, match=match):
            c.compute(["background"])


@pytest.mark.parametrize("extra,match", [
    ({"gauge": "newtonian"}, r"equations\.py:1369-1373"),
    ({"Omega_Lambda": 0, "Omega_fld": 0, "Omega_scf": -1,
      "scf_parameters": "10.0, 0.0, 0.0, 0.0, 100.0, 0.0"}, r"equations\.py:301-318")])
def test_idm_refusals_name_the_jax_lines(extra, match):
    c = T.Class(device="cpu")
    c.set(dict(G17_KEYS, output="tCl", **extra))
    with pytest.raises(NotImplementedError, match=match):
        c.compute(["perturbations"])
    with pytest.raises(NotImplementedError, match=match):
        TIdx(has_idm_dr=True, **({"gauge": "newtonian"} if "gauge" in extra
                                 else {"has_scf": True}))


# --- the background and the T_idm march --------------------------------------

_STAGES = {}


def jax_stages():
    """g17's JAX parameters, background and thermodynamics (computed once)."""
    if not _STAGES:
        cj = J.Class()
        cj.set(dict(G17_KEYS, output="mPk", **PR))
        b = cj._build()
        bg, bidx = jbg.compute_background(b.params, b.pr)
        _STAGES.update(params=b.params, pr=b.pr, bg=bg, bidx=bidx,
                       th=jth.compute_thermodynamics(b.params, b.pr, bg, bidx))
    return _STAGES


def test_background_matches_jax():
    st = jax_stages()
    tparams = interop.cosmo_params(dataclasses.asdict(st["params"]))
    bt, it = tbg.compute_background(tparams, TPrec(**PR), device="cpu")
    bj, ij = st["bg"], st["bidx"]
    assert list(ij.names) == it.names and it.has_idm_dr
    tab_j, tab_t = np.asarray(bj.table), bt.table.numpy()
    worst = {n: float(np.abs(tab_t[:, it[n]] - tab_j[:, ij[n]]).max()
                      / max(np.abs(tab_j[:, ij[n]]).max(), 1e-300)) for n in it.names}
    print(f"g17 background: worst column {max(worst, key=worst.get)} {max(worst.values()):.3e}")
    assert max(worst.values()) <= BG_TOL, worst
    for f in ("Omega0_m", "Omega0_r", "Omega0_lambda", "tau0", "z_eq"):
        assert abs(getattr(bt, f) / float(getattr(bj, f)) - 1.0) <= BG_TOL, f


def march_inputs():
    """The T_idm march's grid, H, T_idr and heating rate as JAX's
    thermodynamics computes them (thermodynamics.py:933-1016, eager jnp)."""
    st = jax_stages()
    p, bg, bidx = st["params"], st["bg"], st["bidx"]
    lntau_u = jnp.linspace(jnp.log(bg.tau_of_loga[0]), jnp.log(bg.tau0), 32768)
    bgvals = bg.lntau_spline.eval(lntau_u)
    z_u = 1.0 / bgvals[:, bidx["a"]] - 1.0
    O_idr = p.stat_f_idr * p.xi_idr ** 4 * float(bg.Omega0_g)
    gam = (2.0 * O_idr * p.h * p.h * p.a_idm_dr * (1.0 + z_u) ** (p.nindex_idm_dr + 1.0)
           / 1.0e7 ** p.nindex_idm_dr)
    return [t64(v) for v in (z_u, bgvals[:, bidx["H"]], p.xi_idr * p.T_cmb * (1.0 + z_u), gam)]


def test_idm_march_plain_matches_jax():
    st = jax_stages()
    z, H, T_idr, gam = march_inputs()
    T_idm, c2 = tth.idm_march_plain(z, H, T_idr, gam, st["params"].m_idm)
    ref = np.asarray(st["th"].lntau_spline.y)[:, tth.ThIdx.ix["cidm_dr2"]]
    gh = (gam / H).numpy()
    rel = np.abs(c2.numpy() - ref) / np.abs(ref)
    calm = gh <= 1e3
    print(f"T_idm march: c^2 against JAX per node, worst {rel[calm].max():.3e} where Gamma/H "
          f"<= 1e3 ({calm.sum()} nodes), {rel.max():.3e} overall (Gamma/H up to {gh.max():.2e})")
    assert calm.sum() > 10000 and rel[calm].max() <= MARCH_TOL
    assert np.all(rel <= MARCH_TOL * np.maximum(1.0, 1e-3 * gh))
    tight = gh >= 1e6
    assert tight.sum() > 1000
    assert np.abs(T_idm.numpy() / T_idr.numpy() - 1.0)[tight].max() <= MARCH_TOL
    # late times: the idm decoupled and cooling adiabatically, T_idm << T_idr
    assert float(T_idm[-1]) < 1e-3 * float(T_idr[-1])


def test_idm_march_on_host(tmp_path):
    """csrc/idm_march.cuh built for the host against the plain loop, on JAX's
    g17 inputs and on a seeded perturbation of them (m_idm 1e9 and 1e6 eV)."""
    lib = _host_lib("idm_march_host", tmp_path)
    lib.idm_march_host.argtypes = [P, P, P, P, I, D, D, D, P, P]
    z, H, T_idr, gam = march_inputs()
    rng = np.random.default_rng(7)
    noisy = [v * t64(1.0 + 1e-3 * rng.standard_normal(len(v))) for v in (H, gam)]
    n = len(z)
    for (Hc, gc), m in (((H, gam), 1.0e9), (tuple(noisy), 1.0e6)):
        Th, ch = torch.empty(n, dtype=torch.float64), torch.empty(n, dtype=torch.float64)
        assert lib.idm_march_host(z.data_ptr(), Hc.data_ptr(), T_idr.data_ptr(), gc.data_ptr(),
                                  n, tth.const.k_B, tth.const.eV_SI, m, Th.data_ptr(),
                                  ch.data_ptr()) == 0
        Tp, cp = tth.idm_march_plain(z, Hc, T_idr, gc, m)
        assert torch.isfinite(Tp).all() and torch.equal(Th, Tp) and torch.equal(ch, cp)
    assert lib.idm_march_host(z.data_ptr(), H.data_ptr(), T_idr.data_ptr(), gam.data_ptr(), 1,
                              1.0, 1.0, 1.0, Th.data_ptr(), ch.data_ptr()) != 0


def test_idm_march_wrapper_does_not_fall_back():
    """On a CPU tensor the wrapper is the plain version and launches nothing;
    on any other device it launches the kernel or raises."""
    z, H, T_idr, gam = (v[:64].contiguous() for v in march_inputs())
    before = tth.idm_march_launches
    got, ref = tth.idm_march(z, H, T_idr, gam, 1e9), tth.idm_march_plain(z, H, T_idr, gam, 1e9)
    assert all(torch.equal(a, b) for a, b in zip(got, ref)) and tth.idm_march_launches == before
    with pytest.raises(ValueError, match="unsupported device"):
        tth.idm_march(*(v.to("meta") for v in (z, H, T_idr, gam)), 1e9)


# --- the perturbations -------------------------------------------------------


@pytest.mark.parametrize("fluid", [False, True])
def test_state_layout_matches_jax(fluid):
    for n in (0, 1):
        kw = dict(n_ncdm=n, has_idm_dr=True, idr_fluid=fluid)
        t, j = TIdx(**kw), JIdx(**kw)
        for f in ("delta_idm_dr", "theta_idm_dr_pt", "delta_idr", "theta_idr", "shear_idr",
                  "F_idr", "n_F_idr", "n_idm_dr", "ncdm", "eta", "size", "radiation_slices"):
            assert getattr(t, f) == getattr(j, f), (n, f)
        ints = tsolve._layout_ints(t)
        assert len(ints) == tsolve.LAYOUT_INTS and ints[22:] == [t.delta_idm_dr, t.n_F_idr,
                                                                 int(fluid), -1]
        # the implicit range ends with the idr block, where the ncdm block begins
        assert tsolve.stiff_count(t) == t.F_idr + t.n_F_idr == t.ncdm
        assert tsolve.work_doubles(t) == (9 * t.size + 7 * t.ncdm + 21 + 3 * n
                                          + tsolve.sl_count(t))
    assert tsolve._layout_ints(TIdx())[22:25] == [-1, 0, 0]


def case_params(case):
    """(JAX CosmoParams, port CosmoParams) of a case: g34's lists at g17's
    point, or a fluid idr with one 0.06 eV ncdm species."""
    keys = dict(G17_KEYS, **G34_LISTS) if case == "g34" else dict(
        G17_KEYS, f_idm_dr=0.5, idr_nature="fluid", b_idr=50.0, N_ur=2.0328, N_ncdm=1,
        m_ncdm=0.06)
    cj = J.Class()
    cj.set(dict(keys, output="mPk", **PR))
    pj = cj._build().params
    return pj, interop.cosmo_params(dataclasses.asdict(pj))


class Setup:
    """One idm_dr cosmology: the JAX stages and the port's views of them, eight
    lanes from 1e-4 to 0.3/Mpc on the JAX schedule plus one at 0.03/Mpc."""

    def __init__(self, case):
        self.params, tparams = case_params(case)
        self.pr = pr = PrecisionParams(**PR)
        n = self.params.N_ncdm
        if case == "g34":
            st = jax_stages()
            self.bg, self.bidx = st["bg"], st["bidx"]
        else:
            self.bg, self.bidx = jbg.compute_background(self.params, pr)
        self.th = jth.compute_thermodynamics(self.params, pr, self.bg, self.bidx)
        self.taus = np.asarray(jg.get_tau_sampling(self.params, pr, self.bg, self.bidx, self.th))
        ks = np.sort(np.concatenate([np.geomspace(1e-4, 0.3, 8), [0.03]]))
        self.sched = jg.get_k_schedule(ks, pr, self.bg, self.bidx, self.th,
                                       tau_first_sample=float(self.taus[0]), n_ncdm=n)
        kw = dict(has_idm_dr=True, l_max_idr=pr.l_max_idr,
                  idr_fluid=self.params.idr_nature == "fluid",
                  alpha_idm_dr=tuple(self.params.alpha_idm_dr),
                  beta_idr=tuple(self.params.beta_idr), n_ncdm=n)
        self.jidx = JIdx(pr.l_max_g, pr.l_max_pol_g, pr.l_max_ur, **kw)
        self.jncdm = jsolve.make_ncdm_ctx(self.params, self.bg, self.jidx, self.bidx) if n \
            else None
        self.tidx = TIdx(**kw)
        bgt, bit = interop.background(asdict(self.bg), "cpu", names=self.bidx.names)
        assert bit.has_idm_dr
        nct = interop.ncdm_ctx(asdict(self.jncdm), "cpu") if n else None
        self.tables = teq.make_tables(bgt, bit, interop.thermo(asdict(self.th), "cpu"),
                                      self.tidx, nct)
        s = self.sched
        t_ncfa = s.tau_ncdmfa_on if n else np.full_like(ks, np.inf)
        self.lanes = tsolve.Lanes(t64(s.k), t64(s.tau_ini), t64(s.tau_tca_off),
                                  t64(s.tau_ufa_on), t64(s.tau_rsa_on), t64(t_ncfa))
        self.eta_off = tsolve._eta_off(self.lanes.k)

        def ctx_of(k, tca, rsa, ufa, ncfa, eta_off):
            return jeq.PertCtx(k=k, tca_on=tca, rsa_on=rsa, ufa_on=ufa,
                               bg_spline=self.bg.lntau_spline, th_spline=self.th.lntau_spline,
                               bidx=self.bidx, idx=self.jidx, ncdmfa_on=ncfa, ncdm=self.jncdm,
                               eta_off=eta_off)

        def one(tau, y, r, gh, k, tca, rsa, ufa, ncfa, eta_off):
            c = ctx_of(k, tca, rsa, ufa, ncfa, eta_off)
            return (jeq.rhs(tau, y, c), jeq.compute_sources(tau, y, c),
                    jeq.stiff_apply(tau, y, c), jeq.stiff_solve(tau, gh, r, c))

        def ic(tau, k, eta_off):
            f = jnp.asarray(False)
            return jeq.adiabatic_ic(k, tau, ctx_of(k, f, f, f, f, eta_off))

        self.jax_rows = jax.jit(jax.vmap(one))
        self.jax_ic = jax.jit(jax.vmap(ic))


_SETUPS = {}


@pytest.fixture(scope="module", params=["g34", "fluid_ncdm1"])
def setup(request):
    if request.param not in _SETUPS:
        _SETUPS[request.param] = Setup(request.param)
    return _SETUPS[request.param]


FLAGS = np.array([[(c >> b) & 1 for b in range(4)] for c in range(16)], dtype=bool)


def _scaled(got, ref):
    return np.abs(got - ref).max(axis=1) / np.abs(ref).max(axis=1)


@pytest.mark.parametrize("when", ["early", "recombination", "late"])
def test_equations_match_jax(setup, when):
    """Seeded random states (the initial state scaled by 1 + 0.3 N(0, 1) plus
    noise in every slot) under every flag combination: the right-hand side,
    the stiff part and its solve at gh = 0.25 h for h = 0.05 tau, and (past
    `early`, where the visibility is ~1e-47) the sources; at `early` also the
    adiabatic initial conditions."""
    s = setup.sched
    tau = {"early": np.sqrt(s.tau_ini * s.tau_tca_off),
           "recombination": np.full(len(s.k), float(setup.th.tau_rec)),
           "late": np.minimum(np.maximum(s.tau_rsa_on, s.tau_tca_off) * 1.5,
                              0.9 * float(setup.bg.tau0))}[when]
    rng = np.random.default_rng(17)
    ctx0 = tsolve._ctx(setup.lanes, t64(tau), setup.eta_off, setup.tables)
    y0 = teq.initial_conditions(teq.frame_at(t64(tau), setup.tables), ctx0).numpy()
    if when == "early":
        ref = np.asarray(setup.jax_ic(jnp.asarray(tau), jnp.asarray(s.k),
                                      jnp.asarray(setup.eta_off.numpy())))
        err = _scaled(y0, ref)
        print(f"adiabatic ICs: worst {err.max():.3e} of the lane's largest entry")
        assert err.max() <= RHS_TOL
        idx = setup.tidx
        assert np.all(y0[:, idx.theta_idm_dr_pt] == y0[:, idx.theta_ur])
    scale = np.abs(y0).max(axis=1, keepdims=True)
    y = y0 * (1.0 + 0.3 * rng.standard_normal(y0.shape)) \
        + 1e-3 * scale * rng.standard_normal(y0.shape)
    r = rng.standard_normal(y0.shape) * scale
    nl, nf = y.shape[0], len(FLAGS)
    yy, rr, tt = np.repeat(y, nf, axis=0), np.repeat(r, nf, axis=0), np.repeat(tau, nf)
    gh = 0.25 * 0.05 * tt
    fl = np.tile(FLAGS, (nl, 1))
    lanes = setup.lanes.take(torch.arange(nl).repeat_interleave(nf))
    eo = setup.eta_off.repeat_interleave(nf)
    ctx = tsolve._ctx(lanes, t64(tt), eo, setup.tables)
    ctx = ctx._replace(**{f: torch.as_tensor(fl[:, i]) for i, f in
                          enumerate(("tca_on", "rsa_on", "ufa_on", "ncdmfa_on"))})
    fr = teq.frame_at(t64(tt), setup.tables)
    got = (teq.rhs(fr, t64(yy), ctx), teq.compute_sources(fr, t64(yy), ctx),
           teq.stiff_apply(fr, t64(yy), ctx), teq.stiff_solve(fr, t64(gh), t64(rr), ctx))
    got = [v.numpy() for v in got]
    ref = [np.asarray(v) for v in setup.jax_rows(
        jnp.asarray(tt), jnp.asarray(yy), jnp.asarray(rr), jnp.asarray(gh),
        jnp.asarray(np.repeat(s.k, nf)), *(jnp.asarray(fl[:, i]) for i in range(4)),
        jnp.asarray(eo.numpy()))]
    assert all(np.isfinite(v).all() for v in got)
    idx = setup.tidx
    # the idm block is live: its scattering is in the stiff part
    assert np.abs(ref[2][:, idx.theta_idm_dr_pt]).max() > 0.0
    for name, i in (("rhs", 0), ("stiff_apply", 2), ("stiff_solve", 3)):
        err = _scaled(got[i], ref[i])
        print(f"{name} ({when}): worst {err.max():.3e} of the lane's largest entry")
        assert err.max() <= RHS_TOL, (name, int(err.argmax()) // nf,
                                      FLAGS[int(err.argmax()) % nf])
    if when == "early":
        return
    worst = {}
    for i, name in enumerate(SrcIdx.names):
        sc = np.abs(ref[1][:, i]).max()
        worst[name] = float(np.abs(got[1][:, i] - ref[1][:, i]).max() / max(sc, 1e-300))
    print(f"sources ({when}): worst {max(worst.values()):.3e} ({max(worst, key=worst.get)})")
    assert max(worst.values()) <= SRC_TOL, worst


def test_stiff_solve_inverts_with_nonuniform_alpha():
    """(I - gh J) stiff_solve(r) = r with per-l alpha_l (tests/test_idm_dr.py::
    test_alpha_beta_stiff_consistency on the port), and the damping follows
    alpha_l down the F_idr block."""
    st = jax_stages()
    alpha = tuple(1.5 - 0.05 * i for i in range(16))
    idx = TIdx(has_idm_dr=True, alpha_idm_dr=alpha, beta_idr=(0.7,))
    bgt, bit = interop.background(asdict(st["bg"]), "cpu", names=st["bidx"].names)
    tables = teq.make_tables(bgt, bit, interop.thermo(asdict(st["th"]), "cpu"), idx)
    rng = np.random.default_rng(2)
    r = t64(rng.normal(size=(3, idx.size)))
    tau = t64([30.0, 30.0, 30.0])
    gh = t64([1e-4, 1.0, 1e4])
    ctx = teq.PertCtx(k=t64([0.3] * 3), tca_on=torch.zeros(3, dtype=torch.bool),
                      rsa_on=torch.zeros(3, dtype=torch.bool),
                      ufa_on=torch.zeros(3, dtype=torch.bool), eta_off=t64([0.0] * 3),
                      tables=tables)
    fr = teq.frame_at(tau, tables)
    x = teq.stiff_solve(fr, gh, r, ctx)
    resid = x - gh[:, None] * teq.stiff_apply(fr, x, ctx) - r
    assert float(resid.abs().max(dim=1).values.div(torch.clamp(gh, min=1.0)).max()) < 1e-9
    ones = torch.eye(idx.size, dtype=torch.float64)[idx.F_idr: idx.F_idr + idx.n_F_idr]
    diag = teq.stiff_apply(teq.frame_at(tau[:1].repeat(idx.n_F_idr), tables), ones,
                           ctx._replace(**{f: getattr(ctx, f)[:1].repeat(idx.n_F_idr)
                                           for f in ("k", "tca_on", "rsa_on", "ufa_on",
                                                     "eta_off")}))
    dF = diag[torch.arange(idx.n_F_idr), idx.F_idr + torch.arange(idx.n_F_idr)].numpy()
    assert np.all(np.diff(dF) > 0), dF


def test_kernel_lane_program_on_host(setup, tmp_path):
    """The idm instance of csrc/perturb_ark.cuh built for the host against
    the plain integrator on three lanes, on every sixth sample time: the
    lowest k and the dark-acoustic lane (0.03/Mpc) under the CMB tolerances,
    the next-to-highest (0.09/Mpc) under the P(k)-tail ones (radiation and
    idr rows loosened)."""
    lib = _host_lib("perturb_ark_host", tmp_path)
    lib.perturb_ark_host_idm.argtypes = [P, P, P, P, P, D, D, I, P, P, D, D, I, P, P, P, D, D,
                                         I, L, I, I, P, P, P, P]
    k = setup.lanes.k
    sel = torch.as_tensor([0, int(torch.argmin((k - 0.03).abs())), len(k) - 2])
    lanes = setup.lanes.take(sel)
    idx, tb = setup.tidx, setup.tables
    kn = lanes.k.numpy()
    rt_c, at_c = tsolve._tolerances(kn[:2], idx, TPrec(**PR), False, 0.0)
    rt_t, at_t = tsolve._tolerances(kn[2:], idx, TPrec(**PR), True, 0.0)
    assert rt_t[0, idx.theta_idr] > RTOL and rt_t[0, idx.delta_idm_dr] > RTOL
    tol = (t64(np.concatenate([rt_c, rt_t])), t64(np.concatenate([at_c, at_t])))
    taus = t64(setup.taus[::6])
    nl, ntau = len(sel), len(taus)
    St, nt = tsolve.integrate_sources(lanes, taus, tb, tol)
    lane_tab = torch.stack(list(lanes)).contiguous()
    packed = tsolve.kernel_ncdm(tb)
    work = torch.empty(tsolve.work_doubles(idx), dtype=torch.float64)
    S = torch.empty((nl, ntau, SrcIdx.n), dtype=torch.float64)
    nsteps = torch.zeros(nl, dtype=torch.long)
    status = torch.ones(nl, dtype=torch.int32)
    layout = (ctypes.c_int * tsolve.LAYOUT_INTS)(*tsolve._layout_ints(idx))
    lib.perturb_ark_host_work_doubles.restype = ctypes.c_longlong
    assert lib.perturb_ark_host_work_doubles(layout) == tsolve.work_doubles(idx)
    args = (lane_tab.data_ptr(), taus.data_ptr(), tb.bg.y.data_ptr(), tb.bg.y2.data_ptr(),
            tb.bg.x0, tb.bg.dx, tb.bg.n, tb.th.y.data_ptr(), tb.th.y2.data_ptr(), tb.th.x0,
            tb.th.dx, tb.th.n, packed.data_ptr(), tol[0].data_ptr(), tol[1].data_ptr(),
            tsolve.K_ETA_SPLIT, 0.0, 0, tsolve.MAX_ITERATIONS, nl, ntau, work.data_ptr(),
            S.data_ptr(), nsteps.data_ptr(), status.data_ptr())
    assert lib.perturb_ark_host_idm(layout, *args) == 0 and not status.any()
    np.testing.assert_array_equal(nsteps.numpy(), nt.numpy())
    worst = {}
    for i, name in enumerate(SrcIdx.names):
        sc = float(St[:, :, i].abs().max())
        worst[name] = float((S[:, :, i] - St[:, :, i]).abs().max()) / max(sc, 1e-300)
    print(f"host build vs plain: steps {nt.tolist()}, worst {max(worst.values()):.3e} "
          f"({max(worst, key=worst.get)})")
    assert max(worst.values()) <= HOST_TOL, worst
    # the idm entry refuses a layout without idm_dr
    plain = (ctypes.c_int * tsolve.LAYOUT_INTS)(*tsolve._layout_ints(TIdx(n_ncdm=idx.n_ncdm)))
    assert lib.perturb_ark_host_idm(plain, *args) != 0


# --- the whole slice ---------------------------------------------------------

SLICE = dict(G17_KEYS, output="tCl,pCl,mPk", l_max_scalars=60, z_pk="0.",
             k_step_sub=0.3, k_step_super=0.02, k_step_super_reduction=1.0,
             **{"P_k_max_1/Mpc": 0.08}, **PR)


def test_slice_matches_jax():
    """g17's physics at small size through the JAX Class and through the
    port's Class(device="cpu") seeded with the JAX background and
    thermodynamics (the tau sampling follows the last bits of the
    thermodynamics table); then the port's P(k) against its LambdaCDM twin."""
    cj = J.Class()
    cj.set(dict(SLICE))
    cj.compute(["spectra"])
    ct = T.Class(device="cpu")
    ct.set(dict(SLICE))
    bg, bidx = cj.cosmo.background
    ct.cosmo.set_stage("background", interop.background(asdict(bg), "cpu", names=bidx.names))
    ct.cosmo.set_stage("thermodynamics", interop.thermo(asdict(cj.cosmo.thermodynamics), "cpu"))
    ct.compute(["spectra"])
    assert ct.cosmo.params.Omega_idm_dr > 0.26
    pt = ct.cosmo.perturbations
    np.testing.assert_array_equal(pt.k_np, cj.cosmo.perturbations.k_np)
    worst = {}
    for key in ("tt", "ee", "te"):
        r = np.asarray(cj.raw_cl(60)[key])
        worst[f"raw {key}"] = float(np.abs(np.asarray(ct.raw_cl(60)[key]) - r).max()
                                    / np.abs(r).max())
    # P(k) at the lanes' own k (a k between a CMB lane and a tail lane
    # would carry the tail lane's tolerance into the CMB comparison); the lane
    # at k_np[k_size_cmb - 1] is the first with the tail's tolerances
    k_cmb = float(pt.k_np[pt.k_size_cmb - 1])
    ks = pt.k_np[(pt.k_np >= 1e-3) & (pt.k_np <= 0.08)]
    pj = np.array([cj.pk_lin(k, 0.0) for k in ks])
    p_idm = np.array([ct.pk_lin(k, 0.0) for k in ks])
    rel = np.abs(p_idm / pj - 1)
    worst["pk_lin"] = float(rel[ks < k_cmb].max())
    tail = float(rel[ks >= k_cmb].max())
    print(f"idm_dr slice, port vs JAX relative to each spectrum's max: worst "
          f"{max(worst.values()):.3e} ({max(worst, key=worst.get)}); P(k) beyond the CMB lanes "
          f"(k >= {k_cmb:.4g}/Mpc) {tail:.3e}")
    assert 0.005 < k_cmb < 0.03 and (ks > k_cmb).sum() >= 20
    assert max(worst.values()) <= SLICE_TOL, worst
    assert tail <= TAIL_TOL
    # the dark acoustic damping against LambdaCDM (the same point without idm_dr)
    c0 = T.Class(device="cpu")
    c0.set({k: v for k, v in SLICE.items() if k not in G17_KEYS or k in (
        "h", "T_cmb", "omega_b", "omega_cdm", "N_ur", "A_s", "n_s", "tau_reio", "YHe")})
    c0.compute(["spectra"])
    ratio = p_idm / np.array([c0.pk_lin(k, 0.0) for k in ks])
    print(f"P_idm / P_LCDM at k = {ks[-1]:.3f}/Mpc: {ratio[-1]:.4f} (at k = {ks[0]:.3f}: "
          f"{ratio[0]:.4f})")
    assert ratio[-1] < 0.95 and abs(ratio[0] - 1.0) < 0.05

"""The port's isocurvature initial conditions against classpp_public_tpu on
identical inputs (CPU), at small size.

- The initial state (`initial_conditions` with each lane's IC code: bi, cdi,
  nid, niv) against JAX `initial_conditions(kind, ...)`, both gauges, without
  and with one ncdm species: 1e-13 of the lane's largest component.
- The isocurvature source tables of the plain integrator (a mode's lanes and
  an adiabatic lane in one call) against the JAX `solve_one_k` of the mode on
  the same tables, niv synchronous and bi Newtonian with one ncdm species:
  10 rtol of each source column's maximum, step counts within 2%
  (tests/test_torch_perturbations.py's contract).
- The kernel's lane program (csrc/perturb_ark.cuh) built for the host, with
  the IC code per lane, against the plain integrator: synchronous without
  ncdm and Newtonian with one species; 1e-12 of each column's maximum, equal
  step counts.
- `iso_pk` and `cross_pk` against JAX to 1e-14; the pair C_l (`cl_pairs`) and
  the total from the JAX transfers to 1e-12; the pair-summed P(k) and the
  halofit stage on the folded delta from the JAX source tables.
- `Class(device="cpu")` against the JAX `Class` (ad, cdi, nid correlated,
  l_max 300, P(k) to 0.5/Mpc), the port seeded with the JAX background and
  thermodynamics: raw and lensed C_l, P(k) and sigma8; and on the port's run
  the sum identity total = sum diag + 2 sum cross to 1e-10. The same for
  row2_iso at small size (ad, bi and niv with one ncdm species and halofit;
  l_max 100, P(k) to 0.5/Mpc): the bi and niv sources, raw and lensed C_l,
  the linear and halofit P(k) and sigma8.
- The classy parse of `ic` and its refusals, with the JAX messages, and the
  port's own two refusals (no "ad"; Omega_k != 0).

Coarse precision throughout (perturb_sampling_stepsize 2, rtol 1e-4), as the
other test_torch_* files.
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
from classpp_public_torch.models import nonlinear as tnl
from classpp_public_torch.models import spectra as tsp
from classpp_public_torch.models.perturbations import equations as teq
from classpp_public_torch.models.perturbations import solve as tsolve
from classpp_public_torch.models.perturbations.indices import PtIdx as TIdx
from classpp_public_torch.models.perturbations.indices import SrcIdx
from classpp_public_torch.ops import cuda
from classpp_public_torch.tools import golden_check
import classpp_public_tpu as J
from classpp_public_tpu import CosmoParams, PrecisionParams
from classpp_public_tpu.models import background as jbg
from classpp_public_tpu.models import nonlinear as jnl
from classpp_public_tpu.models import spectra as jsp
from classpp_public_tpu.models import thermodynamics as jth
from classpp_public_tpu.models.perturbations import equations as jeq
from classpp_public_tpu.models.perturbations import grids as jg
from classpp_public_tpu.models.perturbations import solve as jsolve
from classpp_public_tpu.models.perturbations.indices import PtIdx as JIdx
from classpp_public_tpu.models.primordial import compute_primordial as jprim
from test_torch_common import asdict, one_torch_thread  # noqa: F401

RTOL = 1e-4
PR = dict(background_Nloga=1024, recfast_Nz0=4000, perturb_sampling_stepsize=2.0,
          tol_perturb_integration=RTOL)
CASES = {"lcdm": {}, "ncdm1": dict(m_ncdm=(0.06,), N_ur=2.0328)}
ISO = ("bi", "cdi", "nid", "niv")
IC_TOL, PRIM_TOL, CL_TOL, SUM_TOL = 1e-13, 1e-14, 1e-12, 1e-10
# the host build of the lane program against the plain integrator: the two
# round differently (operation order, libm); measured 1.5e-12 of delta_b's
# scale on the Newtonian ncdm lanes, where delta_cdm of a cdi lane starts at 1
HOST_TOL = 1e-11
SLICE_TOL = 1e-6


def t64(a):
    return torch.as_tensor(np.asarray(a), dtype=torch.float64)


class Setup:
    """One cosmology: the JAX background, thermodynamics and schedule, and
    the port's tables in each gauge; eight lanes from 1e-4 to 0.3/Mpc."""

    def __init__(self, case):
        self.params = CosmoParams(**CASES[case])
        self.pr = pr = PrecisionParams(**PR)
        self.n = n = self.params.N_ncdm
        self.bg, self.bidx = jbg.compute_background(self.params, pr)
        self.th = jth.compute_thermodynamics(self.params, pr, self.bg, self.bidx)
        self.taus = np.asarray(jg.get_tau_sampling(self.params, pr, self.bg, self.bidx,
                                                   self.th))
        ks = np.geomspace(1e-4, 0.3, 8)
        self.sched = s = jg.get_k_schedule(ks, pr, self.bg, self.bidx, self.th,
                                           tau_first_sample=float(self.taus[0]), n_ncdm=n)
        self.jidx = {g: JIdx(pr.l_max_g, pr.l_max_pol_g, pr.l_max_ur, n_ncdm=n, gauge=g)
                     for g in ("synchronous", "newtonian")}
        self.jncdm = jsolve.make_ncdm_ctx(self.params, self.bg, self.jidx["synchronous"],
                                          self.bidx) if n else None
        bgt, bit = interop.background(asdict(self.bg), "cpu", names=self.bidx.names)
        tht = interop.thermo(asdict(self.th), "cpu")
        nct = interop.ncdm_ctx(asdict(self.jncdm), "cpu") if n else None
        self.tidx = {g: TIdx(n_ncdm=n, gauge=g) for g in ("synchronous", "newtonian")}
        self.tables = {g: teq.make_tables(bgt, bit, tht, self.tidx[g], nct)
                       for g in self.tidx}
        t_ncfa = s.tau_ncdmfa_on if n else np.full_like(ks, np.inf)
        self.lanes = tsolve.Lanes(t64(s.k), t64(s.tau_ini), t64(s.tau_tca_off),
                                  t64(s.tau_ufa_on), t64(s.tau_rsa_on), t64(t_ncfa))

    def jax_ctx(self, gauge, i):
        s = self.sched
        return jeq.PertCtx(k=jnp.asarray(s.k[i]), tca_on=True, rsa_on=False, ufa_on=False,
                           bg_spline=self.bg.lntau_spline, th_spline=self.th.lntau_spline,
                           bidx=self.bidx, idx=self.jidx[gauge], ncdm=self.jncdm, eta_off=0.0)


_SETUPS = {}


def get_setup(case):
    if case not in _SETUPS:
        _SETUPS[case] = Setup(case)
    return _SETUPS[case]


@pytest.mark.parametrize("case", list(CASES))
@pytest.mark.parametrize("gauge", ["synchronous", "newtonian"])
@pytest.mark.parametrize("kind", ISO)
def test_isocurvature_ic_matches_jax(kind, gauge, case):
    setup = get_setup(case)
    s = setup.sched
    nl = len(s.k)
    code = torch.full((nl,), teq.IC_KINDS.index(kind), dtype=torch.int32)
    tau = t64(s.tau_ini)
    ctx = tsolve._ctx(setup.lanes, tau, tsolve._eta_off(setup.lanes.k, gauge, code),
                      setup.tables[gauge], code)
    assert not ctx.eta_off.any()
    got = teq.initial_conditions(teq.frame_at(tau, setup.tables[gauge]), ctx).numpy()
    assert got.shape == (nl, setup.tidx[gauge].size)
    for i in range(nl):
        ref = np.asarray(jeq.initial_conditions(kind, jnp.asarray(s.k[i]), s.tau_ini[i],
                                                setup.jax_ctx(gauge, i)))
        err = np.abs(got[i] - ref).max() / np.abs(ref).max()
        assert err <= IC_TOL, (i, err)


def test_eta_offset_only_on_adiabatic_synchronous_lanes():
    k = t64([1e-3, 1e-3, 0.1])
    ic = torch.as_tensor([0, 2, 0], dtype=torch.int32)
    assert tsolve._eta_off(k, "synchronous", ic).tolist() == [1.0, 0.0, 0.0]
    assert tsolve._eta_off(k, "synchronous").tolist() == [1.0, 1.0, 0.0]
    assert not tsolve._eta_off(k, "newtonian", ic).any()


# --- the integrator ---------------------------------------------------------

# the lanes of the source comparisons against JAX solve_one_k (cdi and nid
# are also compared on the whole slice below, bi and niv on row2_iso's)
NIV_LANES = [1, 6]


def _sources_pair(case, gauge, kind, lanes):
    """The plain integrator on `lanes` of the mode `kind` and an adiabatic
    lane in one call (the adiabatic lane last), and the JAX solve_one_k of
    the mode on the same lanes, in one gauge: (port sources, port steps, JAX
    sources, JAX steps) of the mode's lanes."""
    setup = get_setup(case)
    s, taus = setup.sched, setup.taus
    sel = torch.as_tensor(lanes + [3])
    code = torch.as_tensor([teq.IC_KINDS.index(kind)] * len(lanes) + [0], dtype=torch.int32)
    idx = setup.tidx[gauge]
    tol = (torch.full((len(sel), idx.size), RTOL, dtype=torch.float64),
           torch.full((len(sel), idx.size), 1e-11, dtype=torch.float64))
    St, nt = tsolve.integrate_sources(setup.lanes.take(sel), t64(taus), setup.tables[gauge],
                                      tol, code)

    def solve(k, ti, a, b, c, d):
        return jsolve.solve_one_k(k, ti, a, b, c, d, taus=jnp.asarray(taus),
                                  bg_spline=setup.bg.lntau_spline,
                                  th_spline=setup.th.lntau_spline, ncdm=setup.jncdm,
                                  bidx=setup.bidx, idx=setup.jidx[gauge], rtol=RTOL, ic=kind)

    args = tuple(jnp.asarray(a[lanes]) for a in (s.k, s.tau_ini, s.tau_tca_off, s.tau_ufa_on,
                                                  s.tau_rsa_on, s.tau_ncdmfa_on))
    Sj, nj, _ = jax.jit(jax.vmap(solve))(*args)
    n = len(lanes)
    return St.numpy()[:n], nt.numpy()[:n], np.asarray(Sj), np.asarray(nj)


@pytest.fixture(scope="module")
def niv_sources():
    """The niv mode on NIV_LANES (lcdm, synchronous)."""
    return _sources_pair("lcdm", "synchronous", "niv", NIV_LANES)


@pytest.fixture(scope="module")
def newt_bi_sources():
    """The bi mode on NIV_LANES in the Newtonian gauge with one ncdm species
    (the generic transform of the synchronous state, ncdm included)."""
    return _sources_pair("ncdm1", "newtonian", "bi", NIV_LANES)


def _hold_sources(st, sj, tag):
    assert st.shape == sj.shape and np.isfinite(st).all()
    for i, name in enumerate(SrcIdx.names):
        scale = np.abs(sj[:, :, i]).max()
        err = np.abs(st[:, :, i] - sj[:, :, i]).max()
        assert err <= 10 * RTOL * scale + 1e-300, (tag, name, err / max(scale, 1e-300))


def test_niv_sources_match_jax(niv_sources):
    st, nt, sj, nj = niv_sources
    _hold_sources(st, sj, "niv")
    assert np.all(np.abs(nt - nj) <= 0.02 * nj + 2), (nt, nj)


def test_newtonian_iso_sources_match_jax(newt_bi_sources):
    st, nt, sj, nj = newt_bi_sources
    _hold_sources(st, sj, "bi newtonian")
    assert np.all(np.abs(nt - nj) <= 0.02 * nj + 2), (nt, nj)


@pytest.fixture(scope="module")
def host_lib(tmp_path_factory):
    gxx = shutil.which("g++")
    if gxx is None:
        pytest.skip("no g++ to build the host version of the kernel's lane program")
    so = tmp_path_factory.mktemp("pkhost") / "libperturb_ark_host.so"
    subprocess.run([gxx, "-O2", "-std=c++17", "-shared", "-fPIC", "-o", str(so),
                    str(Path(cuda.CSRC_DIR) / "perturb_ark_host.cpp")], check=True)
    lib = ctypes.CDLL(str(so))
    P, I, D, L = ctypes.c_void_p, ctypes.c_int, ctypes.c_double, ctypes.c_longlong
    lib.perturb_ark_host_ic.argtypes = [P, P, P, P, P, D, D, I, P, P, D, D, I, P, P, P, P, D, D,
                                        I, I, L, I, I, P, P, P, P]
    return lib


@pytest.mark.parametrize("case,gauge", [("lcdm", "synchronous"), ("ncdm1", "newtonian")])
def test_kernel_lane_program_on_host(case, gauge, host_lib):
    """csrc/perturb_ark.cuh built for the host against the plain integrator on
    one lane of each isocurvature mode and one adiabatic lane of low k (which
    stores eta - 1 in the synchronous gauge), on every third sample time."""
    setup = get_setup(case)
    sel = torch.as_tensor([1, 2, 3, 5, 4, 0])
    code = torch.as_tensor([1, 2, 3, 4, 2, 0], dtype=torch.int32)
    lanes = setup.lanes.take(sel)
    idx, tb = setup.tidx[gauge], setup.tables[gauge]
    tol = tsolve._tolerances(lanes.k.numpy(), idx, TPrec(**PR), False, 0.0)
    tol = (t64(tol[0]), t64(tol[1]))
    taus = t64(np.ascontiguousarray(setup.taus[::3]))
    nl, ntau = len(sel), len(taus)
    St, nt = tsolve.integrate_sources(lanes, taus, tb, tol, code)
    lane_tab = torch.stack(list(lanes)).contiguous()
    nc = torch.cat([v.reshape(-1) for v in tb.ncdm]) if idx.n_ncdm else None
    work = torch.empty(tsolve.work_doubles(idx), dtype=torch.float64)
    S = torch.empty((nl, ntau, SrcIdx.n), dtype=torch.float64)
    nsteps = torch.zeros(nl, dtype=torch.long)
    status = torch.ones(nl, dtype=torch.int32)
    layout = (ctypes.c_int * tsolve.LAYOUT_INTS)(*tsolve._layout_ints(idx))
    rc = host_lib.perturb_ark_host_ic(
        layout, lane_tab.data_ptr(), taus.data_ptr(), tb.bg.y.data_ptr(), tb.bg.y2.data_ptr(),
        tb.bg.x0, tb.bg.dx, tb.bg.n, tb.th.y.data_ptr(), tb.th.y2.data_ptr(), tb.th.x0, tb.th.dx,
        tb.th.n, nc.data_ptr() if idx.n_ncdm else None, tol[0].data_ptr(), tol[1].data_ptr(),
        code.data_ptr(), tsolve.K_ETA_SPLIT, 0.0, 0, tsolve.GAUGES[gauge], tsolve.MAX_ITERATIONS,
        nl, ntau, work.data_ptr(), S.data_ptr(), nsteps.data_ptr(), status.data_ptr())
    assert rc == 0 and not status.any()
    np.testing.assert_array_equal(nsteps.numpy(), nt.numpy())
    worst = {}
    for i, name in enumerate(SrcIdx.names):
        scale = float(St[:, :, i].abs().max())
        worst[name] = float((S[:, :, i] - St[:, :, i]).abs().max()) / max(scale, 1e-300)
    print(f"host build vs plain ({case}, {gauge}): steps {nt.tolist()}, worst "
          f"{max(worst.values()):.3e} ({max(worst, key=worst.get)})")
    assert max(worst.values()) <= HOST_TOL, worst


# --- primordial, spectra, P(k) ----------------------------------------------

ISO_PRIM = {"cdi": (0.3, 0.95, 0.0), "nid": (0.2, 1.05, 0.01), "niv": (0.5, 1.0, 0.0)}
ISO_CORR = {("ad", "cdi"): (-0.6, 0.02, 0.0), ("ad", "nid"): (0.4, 0.0, 0.003),
            ("cdi", "nid"): (0.25, 0.0, 0.0), ("nid", "niv"): (0.0, 0.1, 0.0)}


def test_iso_and_cross_spectra_match_jax():
    pmj = jprim(CosmoParams(alpha_s=-0.004), iso=ISO_PRIM, iso_corr=ISO_CORR)
    pmt = interop.primordial(asdict(pmj))
    assert pmt.iso == ISO_PRIM and pmt.iso_corr == ISO_CORR
    k = np.geomspace(1e-5, 5.0, 200)
    for ic in ("ad",) + tuple(ISO_PRIM):
        ref = np.asarray(pmj.iso_pk(ic, jnp.asarray(k)) if ic != "ad"
                         else pmj.scalar_pk(jnp.asarray(k)))
        got = (pmt.iso_pk(ic, t64(k)) if ic != "ad" else pmt.scalar_pk(t64(k))).numpy()
        assert np.abs(got / ref - 1).max() <= PRIM_TOL, ic
    names = ("ad",) + tuple(ISO_PRIM)
    for a in names:
        for b in names:
            ref = pmj.cross_pk(a, b, jnp.asarray(k))
            got = pmt.cross_pk(a, b, t64(k))
            assert (ref is None) == (got is None), (a, b)
            if ref is not None:
                assert np.abs(got.numpy() / np.asarray(ref) - 1).max() <= PRIM_TOL, (a, b)
    assert pmt.cross_pk("nid", "niv", t64(k)) is None     # c = 0: uncorrelated


SLICE = {"h": 0.67810, "omega_b": 0.02238280, "omega_cdm": 0.1201075, "N_ur": 3.046,
         "A_s": 2.100549e-09, "n_s": 0.9660499, "tau_reio": 0.05430842,
         "ic": "ad, cdi, nid", "f_cdi": 0.3, "n_cdi": 0.95, "f_nid": 0.2, "n_nid": 1.05,
         "c_ad_cdi": -0.6, "n_ad_cdi": 0.02, "c_ad_nid": 0.4, "c_cdi_nid": 0.25,
         "output": "tCl,pCl,lCl,mPk", "lensing": "yes", "l_max_scalars": 300,
         "P_k_max_1/Mpc": 0.5, "z_pk": "0", "k_step_sub": 0.3, "k_step_super": 0.02,
         "k_step_super_reduction": 1.0, **PR}


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
    """The correlated point through the JAX Class and through the port's
    Class(device="cpu") seeded with the JAX background and thermodynamics."""
    cj = J.Class()
    cj.set(dict(SLICE))
    cj.compute(["lensing"])
    return cj, _port(SLICE, cj)


def test_cl_pairs_match_jax(slice_pair):
    """compute_spectra on the JAX transfers (adiabatic and isocurvature) and
    primordial spectra, moved across."""
    cj, _ = slice_pair
    cosmo = cj.cosmo
    tr_iso = cosmo.transfer_iso
    assert list(tr_iso) == ["cdi", "nid"]
    ref = jsp.compute_spectra(cosmo.transfer, cosmo.primordial, l_max=cosmo.l_max_internal,
                              tr_iso=tr_iso)
    got = tsp.compute_spectra(interop.transfer(asdict(cosmo.transfer), "cpu"),
                              interop.primordial(asdict(cosmo.primordial)),
                              l_max=cosmo.l_max_internal,
                              tr_iso={ic: interop.transfer(asdict(t), "cpu")
                                      for ic, t in tr_iso.items()})
    assert list(got.cl_pairs) == list(ref.cl_pairs)
    assert len(got.cl_pairs) == 6
    for key, r in list(ref.cl_pairs.items()) + [("total", ref.cl_list), ("cl", ref.cl)]:
        r = np.asarray(r)
        g = (got.cl_pairs[key] if key not in ("total", "cl")
             else got.cl_list if key == "total" else got.cl).numpy()
        for c in range(r.shape[1]):
            scale = np.abs(r[:, c]).max()
            if scale == 0.0:
                assert not g[:, c].any()
                continue
            assert np.abs(g[:, c] - r[:, c]).max() <= CL_TOL * scale, (key, c)


def test_iso_sources_match_jax(slice_pair):
    """The port's cdi and nid source tables (its own solve, on the JAX
    background and thermodynamics) against the JAX package's."""
    cj, ct = slice_pair
    pj, pt = cj.cosmo.perturbations, ct.cosmo.perturbations
    assert list(pt.sources_iso) == list(pj.sources_iso) == ["cdi", "nid"]
    for ic in pj.sources_iso:
        _hold_sources(pt.sources_iso[ic].numpy(), np.asarray(pj.sources_iso[ic]), ic)


def test_pk_pairs_and_halofit_fold_match_jax(slice_pair):
    """The pair-summed linear P(k, z) and the halofit stage (its effective
    delta folded over the pairs, and sigma8 through it) on the JAX source
    tables, moved across."""
    cj, _ = slice_pair
    cosmo = cj.cosmo
    pj, (bgj, bidx) = cosmo.perturbations, cosmo.background
    assert list(pj.sources_iso) == ["cdi", "nid"]
    pt = interop.perturb(asdict(pj), "cpu")
    bgt, bit = interop.background(asdict(bgj), "cpu", names=bidx.names)
    pmt = interop.primordial(asdict(cosmo.primordial))
    for z in (0.0, 1.5):
        ref = np.asarray(jnl.pk_linear_at_z(pj, bgj, cosmo.primordial, z))
        got = tnl.pk_linear_at_z(pt, bgt, pmt, z).numpy()
        assert np.abs(got / ref - 1).max() <= 1e-12, z
        single = tnl.pk_linear_at_z(pt._replace(sources_iso=None), bgt, pmt, z).numpy()
        assert np.abs(single / got - 1).max() > 1e-2      # the pairs move P(k)
    pr = cosmo.pr
    ref = jnl.compute_nonlinear(pj, bgj, bidx, cosmo.primordial, pr, cosmo.params,
                                z_pk=(0.0, 1.0), method="halofit")
    got = tnl.compute_nonlinear(pt, bgt, bit, pmt, TPrec(**PR),
                                interop.cosmo_params(dataclasses.asdict(cosmo.params)),
                                z_pk=(0.0, 1.0))
    for name in ("pk_lin", "pk_cb_lin", "pk_nl", "pk_cb_nl", "k_nl"):
        r, g = np.asarray(getattr(ref, name)), getattr(got, name).numpy()
        assert np.abs(g / r - 1).max() <= 1e-9, name
    assert abs(got.sigma8 / float(ref.sigma8) - 1) <= 1e-12


def test_slice_matches_jax(slice_pair):
    cj, ct = slice_pair
    assert ct.cosmo.out.ics == cj.cosmo.out.ics == ("ad", "cdi", "nid")
    np.testing.assert_array_equal(ct.cosmo.perturbations.k_np, cj.cosmo.perturbations.k_np)
    worst = {}
    for tag, got, ref in (("raw", ct.raw_cl(300), cj.raw_cl(300)),
                          ("lensed", ct.lensed_cl(300), cj.lensed_cl(300))):
        for key in ("tt", "ee", "te", "pp", "bb"):
            r = np.asarray(ref[key])
            if not np.abs(r).max():
                continue
            worst[f"{tag} {key}"] = float(np.abs(np.asarray(got[key]) - r).max() / np.abs(r).max())
    ks = np.geomspace(1e-3, 0.45, 12)
    pj = np.array([cj.pk_lin(k, 0.0) for k in ks])
    worst["pk_lin"] = float(np.max(np.abs(np.array([ct.pk_lin(k, 0.0) for k in ks]) / pj - 1)))
    worst["sigma8"] = abs(ct.sigma8() / cj.sigma8() - 1)
    print(f"isocurvature slice, port vs JAX relative to each spectrum's max: "
          f"worst {max(worst.values()):.3e} ({max(worst, key=worst.get)})")
    assert max(worst.values()) <= SLICE_TOL, worst


def test_sum_identity(slice_pair):
    """The raw C_l equal the sum of their pairs, the off-diagonal ones twice
    (spectra_module.cpp:305-308)."""
    _, ct = slice_pair
    err, at = golden_check.sum_identity(ct, 300)
    print(f"total against the sum of the pairs: {err:.3e} at l = {at}")
    assert err <= SUM_TOL


# row2_iso (tools/configs.py: row2_exact with ad, bi and niv, one 0.06 eV ncdm
# species and halofit) cut to l_max 100 and P(k) to 0.5/Mpc, halofit's k floor
# lowered to match, and integrated at rtol 1e-3 (half the time of 1e-4)
def _row2_iso_small():
    from classpp_public_torch.tools.configs import CONFIGS

    return dict(CONFIGS["row2_iso"], l_max_scalars=100, z_pk="0", k_step_sub=0.3,
                k_step_super=0.02, k_step_super_reduction=1.0, nonlinear_min_k_max=0.5,
                halofit_min_k_max=0.5, **{"P_k_max_1/Mpc": 0.5},
                **dict(PR, tol_perturb_integration=1e-3))


@pytest.fixture(scope="module")
def row2_iso_pair():
    """row2_iso at small size through the JAX Class and through the port's
    Class(device="cpu") seeded with the JAX background and thermodynamics."""
    keys = _row2_iso_small()
    cj = J.Class()
    cj.set(dict(keys))
    cj.compute(["lensing"])
    return cj, _port(keys, cj)


def test_row2_iso_sources_match_jax(row2_iso_pair):
    """The bi and niv source tables with one ncdm species."""
    cj, ct = row2_iso_pair
    pj, pt = cj.cosmo.perturbations, ct.cosmo.perturbations
    assert list(pt.sources_iso) == list(pj.sources_iso) == ["bi", "niv"]
    _hold_sources(pt.sources.numpy(), np.asarray(pj.sources), "ad")
    for ic in pj.sources_iso:
        _hold_sources(pt.sources_iso[ic].numpy(), np.asarray(pj.sources_iso[ic]), ic)


def test_row2_iso_matches_jax(row2_iso_pair):
    """Raw and lensed C_l (the halofit ratio on every mode's phi+psi), the
    linear and halofit P(k) summed over the pairs, and sigma8."""
    cj, ct = row2_iso_pair
    assert ct.cosmo.out.ics == cj.cosmo.out.ics == ("ad", "bi", "niv")
    assert ct.cosmo.out.non_linear == "halofit" and len(ct.cosmo.params.m_ncdm) == 1
    np.testing.assert_array_equal(ct.cosmo.perturbations.k_np, cj.cosmo.perturbations.k_np)
    worst = {}
    for tag, got, ref in (("raw", ct.raw_cl(100), cj.raw_cl(100)),
                          ("lensed", ct.lensed_cl(100), cj.lensed_cl(100))):
        for key in ("tt", "ee", "te", "pp", "bb"):
            r = np.asarray(ref[key])
            if not np.abs(r).max():
                continue
            worst[f"{tag} {key}"] = float(np.abs(np.asarray(got[key]) - r).max() / np.abs(r).max())
    ks = np.geomspace(1e-3, 0.45, 12)
    for name in ("pk_lin", "pk"):
        pj = np.array([getattr(cj, name)(k, 0.0) for k in ks])
        pt = np.array([getattr(ct, name)(k, 0.0) for k in ks])
        worst[name] = float(np.max(np.abs(pt / pj - 1)))
    worst["sigma8"] = abs(ct.sigma8() / cj.sigma8() - 1)
    print(f"row2_iso at small size, port vs JAX relative to each spectrum's max: "
          f"worst {max(worst.values()):.3e} ({max(worst, key=worst.get)})")
    assert max(worst.values()) <= SLICE_TOL, worst


# --- the classy surface -----------------------------------------------------

REFUSALS = [
    ({"output": "tCl", "ic": "ad,xyz"}, "unknown initial condition 'xyz'"),
    ({"output": "tCl", "ic": "ad,cdi", "c_ad_cdi": 1.5}, r"c_ad_cdi = 1.5 outside \[-1, 1\]"),
    ({"output": "tCl", "ic": "ad,cdi", "c_ad_nid": 0.3},
     "c_ad_nid given but ic does not include both 'ad' and 'nid'"),
    ({"ic": "ad,cdi"}, r"Class did not read input parameter\(s\): ic"),
    ({"output": "tCl", "P_k_ini type": "two_scales", "k1": 0.002, "k2": 0.1,
      "P_{RR}^1": 2.3e-9, "P_{RR}^2": 2.0e-9, "P_{II}^1": 1e-11},
     "two_scales isocurvature amplitudes not implemented"),
]


@pytest.mark.parametrize("keys,match", REFUSALS)
def test_ic_refusals_mirror_jax(keys, match):
    for cls, exc in ((J.Class, J.CosmoSevereError), (T.Class, T.CosmoSevereError)):
        c = cls(device="cpu") if cls is T.Class else cls()
        c.set(dict(keys))
        with pytest.raises(exc, match=match):
            c.cosmo


@pytest.mark.parametrize("keys,match", [
    ({"output": "tCl", "ic": "cdi"}, r"without 'ad' is not ported.*solve\.py:739"),
    ({"output": "tCl", "ic": "ad,cdi", "Omega_k": 0.01},
     r"Omega_k != 0 are not ported.*equations\.py:1216"),
])
def test_port_only_refusals(keys, match):
    c = T.Class(device="cpu")
    c.set(dict(keys))
    with pytest.raises(NotImplementedError, match=match):
        c.cosmo


def test_two_scales_parses_as_in_jax():
    keys = {"output": "tCl", "P_k_ini type": "two_scales", "k1": 0.002, "k2": 0.1,
            "P_{RR}^1": 2.3e-9, "P_{RR}^2": 2.0e-9}
    ct, cj = T.Class(device="cpu"), J.Class()
    ct.set(dict(keys))
    cj.set(dict(keys))
    assert ct.cosmo.params.n_s == pytest.approx(cj.cosmo.params.n_s, rel=1e-15)
    assert ct.cosmo.params.A_s == pytest.approx(cj.cosmo.params.A_s, rel=1e-15)


@pytest.mark.parametrize("k_pivot", [0.05, 0.002, 0.1])
def test_two_scales_k_pivot(k_pivot):
    """The JAX classy takes A_s at 0.05/Mpc whatever k_pivot (it reads k_pivot
    after popping it, classy.py:735): at 0.05 the port parses as it does, and
    any other k_pivot the port refuses."""
    keys = {"output": "tCl", "P_k_ini type": "two_scales", "k1": 0.002, "k2": 0.1,
            "P_{RR}^1": 2.3e-9, "P_{RR}^2": 2.0e-9, "k_pivot": k_pivot}
    ct, cj = T.Class(device="cpu"), J.Class()
    ct.set(dict(keys))
    cj.set(dict(keys))
    if k_pivot != 0.05:
        with pytest.raises(NotImplementedError, match=r"k_pivot != 0\.05.*classy\.py:735"):
            ct.cosmo
        return
    assert ct.cosmo.params.k_pivot == cj.cosmo.params.k_pivot == 0.05
    assert ct.cosmo.params.n_s == pytest.approx(cj.cosmo.params.n_s, rel=1e-15)
    assert ct.cosmo.params.A_s == pytest.approx(cj.cosmo.params.A_s, rel=1e-15)


@pytest.mark.parametrize("name", ["g21_isocorr", "g21_newt", "g31_peric", "row2_iso"])
def test_isocurvature_configurations_parse_as_in_jax(name):
    """The configurations the card drives with isocurvature modes
    (tools/configs.py) read as the JAX classy reads them."""
    from classpp_public_torch.tools.configs import CONFIGS

    ct, cj = T.Class(device="cpu"), J.Class()
    ct.set(dict(CONFIGS[name]))
    cj.set(dict(CONFIGS[name]))
    assert ct.cosmo.out.ics == cj.cosmo.out.ics and len(ct.cosmo.out.ics) > 1
    assert ct.cosmo.iso_primordial == cj.cosmo.iso_primordial
    assert ct.cosmo.iso_corr == cj.cosmo.iso_corr
    assert ct.cosmo.params.gauge == cj.cosmo.params.gauge
    for f in ("tCl", "pCl", "lCl", "mPk", "lensing", "l_scalar_max", "P_k_max", "non_linear"):
        assert getattr(ct.cosmo.out, f) == getattr(cj.cosmo.out, f), f

"""classpp_public_torch tensor method `exact` with massive neutrinos, and the
growth-factor march, against classpp_public_tpu on identical inputs (CPU).

The JAX background and thermodynamics tables are moved across with
classpp_public_torch.interop at the small-host precision (background_Nloga =
1024, recfast_Nz0 = 4000); one 0.06 eV species with N_ur = 2.0328 (the
g32_texact cosmology) and the three species of ncdm_row3 (0.021934, 0.023582,
0.054485 eV, N_ur = 0.00641).

- The ncdm momentum context of the tensor solve (tensors.tensor_ncdm_ctx)
  against the JAX make_ncdm_ctx: equal.
- The tensor right-hand side with the Psi_l(q) block and its stress in gw''
  against the JAX `rhs_full` on seeded states, one and three species, the
  three (tca, rsa) flag pairs, flat and K = -+5e-9/Mpc^2: 1e-12 of each
  lane's largest derivative (measured ~1e-17).
- The plain integrator against the JAX `solve_one_k` with the ncdm context,
  vmapped, on 5 lanes of the l_max_tensors = 60 grid at rtol 1e-4: equal step
  counts, sources within 1e-8 of each source type's scale (measured 3e-14).
- The host build of the kernel's lane program (csrc/tensor_rkck.cuh) against
  the plain integrator at one species (flat and open) and three: equal step
  counts, 1e-12 of scale (measured 2e-16); the wrapper's shared-memory
  refusal names N_ncdm.
- The host build of the growth-factor march (csrc/growth_march.cuh) against
  its plain loop (ops/ode.py rk4_fixed): 1e-13 relative (measured: equal),
  and the classy accessors of D and f against the JAX ones: 1e-10 relative.
- The whole tensor slice, `Class(device="cpu")` seeded with the JAX Class's
  background and thermodynamics, against the JAX Class: raw TT, EE, BB and TE
  of the tensor modes within 1e-6 relative at every l <= l_max_tensors.
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
from classpp_public_torch.models.perturbations import tensors as tt
from classpp_public_torch.ops import cuda
from classpp_public_torch.ops.splines import UniformSpline

import classpp_public_tpu as J
from classpp_public_tpu import CosmoParams, PrecisionParams
from classpp_public_tpu.models import background as jbg
from classpp_public_tpu.models import thermodynamics as jth
from classpp_public_tpu.models.perturbations import grids as jg
from classpp_public_tpu.models.perturbations import solve as jsolve
from classpp_public_tpu.models.perturbations import tensors as jt
from test_torch_common import asdict, one_torch_thread  # noqa: F401

RTOL = 1e-4
L_TENSOR = 60
PR = dict(background_Nloga=1024, recfast_Nz0=4000, perturb_sampling_stepsize=2.0,
          tol_perturb_integration=RTOL)
SPECIES = {1: dict(m_ncdm=(0.06,), N_ur=2.0328),
           3: dict(m_ncdm=(0.021934, 0.023582, 0.054485), N_ur=0.00641)}
K_OPEN = -5e-9   # 1/Mpc^2: Omega_k ~ 0.1 at this H0


def t64(a):
    return torch.as_tensor(np.asarray(a), dtype=torch.float64)


class Setup:
    """The JAX tables of one cosmology, both packages' ncdm contexts, and
    5 tensor lanes of the l_max_tensors = 60 grid."""

    def __init__(self, n_species):
        self.ns = n_species
        self.params = CosmoParams(r=0.1, tensor_method="exact", **SPECIES[n_species])
        self.pr = pr = PrecisionParams(**PR)
        self.bg, self.bidx = jbg.compute_background(self.params, pr)
        self.th = jth.compute_thermodynamics(self.params, pr, self.bg, self.bidx)
        self.bgt, self.bit = interop.background(asdict(self.bg), "cpu", names=self.bidx.names)
        self.tht = interop.thermo(asdict(self.th), "cpu")
        nq, q_gauss, q_max = jbg.ncdm_q_rule(self.params, pr)
        shim = type("QS", (), dict(q_size_ncdm=nq, q_gauss=q_gauss, q_max_ncdm=q_max,
                                   n_ncdm=n_species, n_dncdm=0))
        self.jncdm = jsolve.make_ncdm_ctx(self.params, self.bg, shim)
        self.nq, self.tncdm = tt.tensor_ncdm_ctx(
            interop.cosmo_params(dataclasses.asdict(self.params)), TPrec(**PR), "cpu")
        ks_all = jg.get_k_list(self.params, pr, self.bg, self.th, l_scalar_max=L_TENSOR,
                               k_max_for_pk=0.0, has_cls=True, has_pk=False, m_mode=2)
        ks = ks_all[np.linspace(0, len(ks_all) - 1, 5).astype(int)]
        self.taus = np.asarray(jg.get_tau_sampling(self.params, pr, self.bg, self.bidx, self.th,
                                                   has_cmb=True))
        self.sched = s = jg.get_k_schedule(ks, pr, self.bg, self.bidx, self.th,
                                           tau_first_sample=float(self.taus[0]))
        self.lanes = tt.TensorLanes(t64(s.k), t64(s.tau_ini), t64(s.tau_tca_off),
                                    t64(s.tau_rsa_on))

    def idx(self, sgnK=0):
        kw = dict(n_ncdm=self.ns, method="exact", sgnK=sgnK, l_max_ncdm=17)
        return jt.TnIdx(q_size_ncdm=self.nq, **kw), tt.TnIdx(q_size_ncdm=self.nq, **kw)

    def tables(self, K=0.0):
        _, tidx = self.idx(0 if K == 0.0 else (1 if K > 0 else -1))
        return tt.make_tables(self.bgt, self.bit, self.tht, tidx, K, self.tncdm)


@pytest.fixture(scope="module")
def setups():
    return {n: Setup(n) for n in SPECIES}


@pytest.fixture(scope="module")
def plain_runs(setups):
    """The plain integrator on each setup's 5 lanes: {(species, K): (S,
    nsteps, tables)}."""
    out = {}
    for ns, K in ((1, 0.0), (3, 0.0), (1, K_OPEN)):
        s = setups[ns]
        tables = s.tables(K)
        S, n = tt.tensor_rkck(s.lanes, t64(s.taus), tables, RTOL)
        out[(ns, K)] = (S.numpy(), n.numpy(), tables)
    return out


@pytest.mark.parametrize("ns", [1, 3])
def test_ncdm_context_matches_jax(setups, ns):
    s = setups[ns]
    assert s.nq == 16
    for name in s.tncdm._fields:
        np.testing.assert_array_equal(getattr(s.tncdm, name).numpy(),
                                      np.asarray(getattr(s.jncdm, name)), err_msg=name)
    jidx, tidx = s.idx()
    assert (tidx.size, tidx.ncdm, tidx.n_ncdm_block) == (jidx.size, jidx.ncdm, jidx.n_ncdm_block) \
        == (32 + 288 * ns, 32, 288 * ns)
    assert tidx.n_rho_ncdm == 0 and tt.TnIdx(n_ncdm=ns).n_ncdm_block == 0


@pytest.mark.parametrize("K", [0.0, K_OPEN, -K_OPEN], ids=["flat", "open", "closed"])
@pytest.mark.parametrize("flags", [(False, False), (True, False), (False, True)])
@pytest.mark.parametrize("ns", [1, 3])
def test_rhs_matches_jax(setups, ns, flags, K):
    s = setups[ns]
    sgnK = 0 if K == 0.0 else (1 if K > 0 else -1)
    jidx, tidx = s.idx(sgnK)
    rng = np.random.default_rng(7)
    ks, taus = np.geomspace(1e-3, 0.3, 6), np.geomspace(200.0, 8000.0, 6)
    y = rng.standard_normal((6, tidx.size)) * 1e-3
    tca, rsa = flags
    ref_dy, ref_s = [], []
    for i in range(6):
        ctx = jt.TensorCtx(k=jnp.asarray(ks[i]), tca_on=jnp.asarray(tca), rsa_on=jnp.asarray(rsa),
                           bg_spline=s.bg.lntau_spline, th_spline=s.th.lntau_spline, bidx=s.bidx,
                           idx=jidx, rho_rel_extra=jnp.asarray(0.0), K=K, ncdm=s.jncdm)
        dy, src = jt.rhs_full(jnp.asarray(taus[i]), jnp.asarray(y[i]), ctx)
        ref_dy.append(np.asarray(dy))
        ref_s.append(np.asarray(src))
    ctx = tt.TensorCtx(k=t64(ks), tca_on=torch.full((6,), tca), rsa_on=torch.full((6,), rsa),
                       idx=tidx, K=K, ncdm=s.tncdm)
    dy, src = tt.rhs_full(tt.frame_at(t64(taus), s.tables(K)), t64(y), ctx)
    jdy = np.stack(ref_dy)
    for i in range(6):
        scale = np.max(np.abs(jdy[i]))
        assert np.max(np.abs(dy[i].numpy() - jdy[i])) <= 1e-12 * scale, i
    js = np.stack(ref_s)
    np.testing.assert_allclose(torch.stack(src, dim=1).numpy(), js, rtol=1e-12,
                               atol=1e-12 * np.max(np.abs(js)))
    # the ncdm stress moves gw'' and the block is driven by gw'
    off = ctx._replace(ncdm=s.tncdm._replace(pref=torch.zeros_like(s.tncdm.pref)))
    dy0, _ = tt.rhs_full(tt.frame_at(t64(taus), s.tables(K)), t64(y), off)
    assert torch.all(dy0[:, 1] != dy[:, 1])
    assert torch.all(dy[:, tidx.ncdm:].abs().amax(dim=1) > 0.0)


def test_plain_solver_matches_jax(setups, plain_runs):
    s = setups[1]
    jidx, _ = s.idx()

    def solve(k, ti, a, b, c):
        return jt.solve_one_k(k, ti, a, b, c, jnp.asarray(s.taus), s.bg.lntau_spline,
                              s.th.lntau_spline, s.bidx, jidx, RTOL, ncdm=s.jncdm)

    sc = s.sched
    args = tuple(jnp.asarray(a) for a in (sc.k, sc.tau_ini, sc.tau_tca_off, sc.tau_ufa_on,
                                          sc.tau_rsa_on))
    sj, nj = (np.asarray(v) for v in jax.jit(jax.vmap(solve))(*args))
    st, nt, _ = plain_runs[(1, 0.0)]
    assert st.shape == sj.shape
    np.testing.assert_array_equal(nt, nj)
    for i in range(2):
        scale = np.max(np.abs(sj[:, :, i]))
        assert np.max(np.abs(st[:, :, i] - sj[:, :, i])) <= 1e-8 * scale, i


def _host_lib(name, tmp_path):
    gxx = shutil.which("g++")
    if gxx is None:
        pytest.skip("no g++ to build the host version of the kernel's code")
    so = tmp_path / f"lib{name}.so"
    subprocess.run([gxx, "-O2", "-std=c++17", "-shared", "-fPIC", "-o", str(so),
                    str(Path(cuda.CSRC_DIR) / f"{name}.cpp")], check=True)
    return ctypes.CDLL(str(so))


P, I, D, L = ctypes.c_void_p, ctypes.c_int, ctypes.c_double, ctypes.c_longlong


@pytest.mark.parametrize("ns,K", [(1, 0.0), (3, 0.0), (1, K_OPEN)], ids=["one", "three", "open"])
def test_kernel_lane_program_on_host(setups, plain_runs, ns, K, tmp_path):
    """csrc/tensor_rkck.cuh with the exact ncdm block, built for the host,
    against the plain integrator."""
    lib = _host_lib("tensor_rkck_host", tmp_path)
    lib.tensor_rkck_host_curved.argtypes = [P, P, P, P, P, D, D, I, P, P, D, D, I, P, D, D, I,
                                            L, I, I, P, P, P, P]
    s = setups[ns]
    st, nt, tables = plain_runs[(ns, K)]
    idx, bg, th = tables.idx, tables.bg, tables.th
    nl, ntau = s.lanes.k.shape[0], len(s.taus)
    lane_tab = torch.stack(list(s.lanes)).contiguous()
    taus = t64(s.taus)
    nc = tt.ncdm_pack(tables)
    work = torch.empty(tt.work_doubles(idx), dtype=torch.float64)
    S = torch.empty((nl, ntau, 2), dtype=torch.float64)
    nsteps = torch.zeros(nl, dtype=torch.long)
    status = torch.ones(nl, dtype=torch.int32)
    ints = tt._layout_ints(idx)
    rc = lib.tensor_rkck_host_curved(
        (ctypes.c_int * len(ints))(*ints), lane_tab.data_ptr(), taus.data_ptr(), bg.y.data_ptr(),
        bg.y2.data_ptr(), bg.x0, bg.dx, bg.n, th.y.data_ptr(), th.y2.data_ptr(), th.x0, th.dx,
        th.n, nc.data_ptr(), RTOL, K, idx.sgnK, tt.MAX_INTERVAL_STEPS, nl, ntau, work.data_ptr(),
        S.data_ptr(), nsteps.data_ptr(), status.data_ptr())
    assert rc == 0 and not status.any()
    np.testing.assert_array_equal(nsteps.numpy(), nt)
    for i in range(2):
        scale = np.max(np.abs(st[:, :, i]))
        assert np.max(np.abs(S[:, :, i].numpy() - st[:, :, i])) <= 1e-12 * scale, i


def test_lane_scratch_limit_names_n_ncdm():
    """Three exact species (65 KB of lane scratch) pass the old 48 KB cap and
    fit; twelve do not fit the 227 KB a block holds, and the wrapper raises
    before any launch."""
    three = tt.TnIdx(n_ncdm=3, method="exact", q_size_ncdm=16)
    assert 48 * 1024 < tt.check_lane_scratch(three) <= tt.MAX_LANE_SCRATCH_BYTES
    with pytest.raises(ValueError, match=r"N_ncdm = 12 .*227 KB"):
        tt.check_lane_scratch(tt.TnIdx(n_ncdm=12, method="exact", q_size_ncdm=16))
    assert tt.check_lane_scratch(tt.TnIdx(n_ncdm=12, method="massless")) < 48 * 1024


def test_decaying_ncdm_refused_under_exact():
    """The JAX package's one refusal of the method (tensors.py:424-427)."""
    from classpp_public_torch.classy import CosmoSevereError
    from classpp_public_torch.config.params import CosmoParams as TParams

    p = TParams(m_ncdm=(0.06,), tensor_method="exact", N_ncdm_decay_dr=1)
    with pytest.raises(CosmoSevereError, match="decaying ncdm"):
        tt.check_tensor_method(p)
    tt.check_tensor_method(p.replace(N_ncdm_decay_dr=0))


# --- the growth-factor march ------------------------------------------------

@pytest.fixture(scope="module")
def growth_inputs():
    """The port's background at the small precision, and the growth march's
    inputs rebuilt from its table as _compute_background_impl builds them."""
    bg, bidx = tbg.compute_background(T.CosmoParams(), TPrec(**PR), device="cpu")
    col = {n: bg.table[:, bidx[n]] for n in ("a", "H", "rho_b", "rho_cdm", "D", "f")}
    spl = UniformSpline.build(float(bg.loga[0]), float(bg.loga[1] - bg.loga[0]),
                              torch.stack([col["rho_b"] + col["rho_cdm"], col["a"], col["H"]], 1))
    aH = col["a"] * col["H"]
    y0 = (float(col["a"][0]), float(col["a"][0]) * 2.0 * float(aH[0]))
    return bg, col, spl, aH, y0


def test_growth_march_plain_is_the_table(growth_inputs):
    bg, col, spl, aH, y0 = growth_inputs
    before = tbg.growth_launches
    D, f = tbg.growth_march(spl, bg.loga, aH, y0)
    assert torch.equal(D, col["D"]) and torch.equal(f, col["f"])
    assert float(D[-1]) == 1.0 and 0.5 < float(f[-1]) < 0.6
    with pytest.raises(ValueError, match="unsupported device"):
        tbg.growth_march(spl.to("meta"), bg.loga.to("meta"), aH.to("meta"), y0)
    assert tbg.growth_launches == before


def test_growth_march_on_host(growth_inputs, tmp_path):
    """csrc/growth_march.cuh built for the host against the plain loop."""
    lib = _host_lib("growth_march_host", tmp_path)
    lib.growth_march_host.argtypes = [P, P, D, D, I, P, P, I, I, D, D, P, P, P]
    lib.growth_march_coef_doubles.restype = ctypes.c_long
    bg, col, spl, aH, y0 = growth_inputs
    n = bg.loga.shape[0]
    coef = torch.empty(lib.growth_march_coef_doubles(n, tbg.GROWTH_SUBSTEPS), dtype=torch.float64)
    Y = torch.empty((n, 2), dtype=torch.float64)
    out = torch.empty((2, n), dtype=torch.float64)
    rc = lib.growth_march_host(spl.y.data_ptr(), spl.y2.data_ptr(), spl.x0, spl.dx, spl.n,
                               bg.loga.data_ptr(), aH.data_ptr(), n, tbg.GROWTH_SUBSTEPS, y0[0],
                               y0[1], coef.data_ptr(), Y.data_ptr(), out.data_ptr())
    assert rc == 0
    for row, name in ((out[0], "D"), (out[1], "f")):
        assert float(((row - col[name]) / col[name]).abs().max()) <= 1e-13, name


def test_growth_accessors_match_jax():
    keys = {"h": 0.6736, "omega_b": 0.02237, "omega_cdm": 0.12, "N_ur": 2.0328, "N_ncdm": 1,
            "m_ncdm": 0.06, "output": "tCl", "background_Nloga": 1024}
    ct, cj = T.Class(device="cpu"), J.Class()
    ct.set(dict(keys))
    cj.set(dict(keys))
    z = np.array([0.0, 0.5, 2.0, 10.0])
    for name in ("scale_independent_growth_factor", "scale_independent_growth_factor_f"):
        got, ref = getattr(ct, name)(z), np.asarray(getattr(cj, name)(z))
        np.testing.assert_allclose(got, ref, rtol=1e-10, err_msg=name)
        assert float(getattr(ct, name)(0.5)) == pytest.approx(float(ref[1]), rel=1e-10)
    assert ct.scale_independent_growth_factor(0.0) == pytest.approx(1.0, rel=1e-14)


# --- the whole tensor slice -------------------------------------------------

SLICE_KEYS = {"N_ur": 2.0328, "N_ncdm": 1, "m_ncdm": 0.06, "modes": "t", "r": 0.1,
              "n_t": "scc", "tensor method": "exact", "output": "tCl,pCl", "l_max_scalars": 40,
              "l_max_tensors": 40, "k_step_super": 0.02, "k_step_sub": 0.1,
              "k_step_super_reduction": 1.0, **PR}


def test_tensor_slice_matches_jax():
    """Class(device="cpu") with tensor method exact and one ncdm species
    against the JAX Class, the port seeded with the JAX background and
    thermodynamics; no kernel launches on the CPU."""
    cj = J.Class()
    cj.set(dict(SLICE_KEYS))
    cj.compute(["spectra"])
    before = (tt.launches, tbg.growth_launches)
    ct = T.Class(device="cpu")
    ct.set(dict(SLICE_KEYS))
    bg, bidx = cj.cosmo.background
    ct.cosmo.set_stage("background", interop.background(asdict(bg), "cpu", names=bidx.names))
    ct.cosmo.set_stage("thermodynamics", interop.thermo(asdict(cj.cosmo.thermodynamics), "cpu"))
    ct.compute(["spectra"])
    assert ct.cosmo.params.tensor_method == "exact" and ct.cosmo.params.N_ncdm == 1
    got, ref = ct.raw_cl(40), cj.raw_cl(40)
    for name in ("tt", "ee", "bb"):
        r, g = np.asarray(ref[name])[2:], np.asarray(got[name])[2:]
        assert (r > 0).all(), name
        assert np.max(np.abs(g / r - 1.0)) <= 1e-6, name
    den = np.sqrt(np.asarray(ref["tt"]) * np.asarray(ref["ee"]))[2:]
    assert np.max(np.abs(np.asarray(got["te"])[2:] - np.asarray(ref["te"])[2:]) / den) <= 1e-6
    assert (tt.launches, tbg.growth_launches) == before


@pytest.mark.parametrize("name", ["g32_texact", "g33_tphotons", "texact_ncdm3", "g1_lcdm",
                                  "g1_lcdm_halofit", "g1h_halofit", "g2_ncdm", "g8s_curved",
                                  "lcdm_row1"])
def test_configurations_parse_as_in_jax(name):
    """The configurations this slice drives on the card (tools/configs.py)
    read as the JAX classy reads them: every parameter and the outputs."""
    from classpp_public_torch.tools.configs import CONFIGS, GOLDEN_ONLY, TENSOR_ONLY

    cfg = {**CONFIGS, **GOLDEN_ONLY, **TENSOR_ONLY}[name]
    ct, cj = T.Class(device="cpu"), J.Class()
    ct.set(dict(cfg))
    cj.set(dict(cfg))
    want = dataclasses.asdict(cj.cosmo.params)
    for k, v in dataclasses.asdict(ct.cosmo.params).items():
        assert v == want[k] or (isinstance(v, float) and v == pytest.approx(want[k], rel=1e-12)), k
    ot, oj = ct.cosmo.out, cj.cosmo.out
    for f in ("tCl", "pCl", "lCl", "mPk", "lensing", "modes", "l_scalar_max", "l_tensor_max",
              "z_pk", "non_linear"):
        assert getattr(ot, f) == getattr(oj, f), f

"""classpp_public_torch HMcode-2016 against classpp_public_tpu on shared inputs
(CPU, where the port runs the plain versions of its two HMcode kernels).

Inputs are made with numpy from a seed and handed to both sides: x grids for
Si/Ci, the BBKS-like spectrum of test_torch_nonlinear.py on the sigma grid, a
mass grid with its nu, virial radii and concentrations for the one-halo
integral, and test_torch_nonlinear.py's hand-made PerturbResult (one 0.06 eV
neutrino, so f_nu > 0 and the cb spectrum differs from the total) for the
whole stage. Where g++ is present the kernels' own code (csrc/hmcode.cuh,
csrc/special.cuh, built for the host by csrc/hmcode_host.cpp and summed in the
kernels' order) is held against the plain versions too.

Then a whole `Class(device="cpu")` with `non linear = hmcode` (lensed C_l and
P(k), small precision; P_k_max and the nonlinear floors at 1/Mpc on both
sides) against the JAX `Class`, from the JAX background and thermodynamics;
the classy parse of the feedback keys against the JAX classy's; and the Cl-only
repair: with a nonlinear method on and no mPk the port samples k as with mPk
(the reference's k_max floor, input_module.cpp:2806), so its lensed C_l equal
those of the same point with mPk, and the JAX Class's with mPk (the JAX
package samples Cl-only output to k_max_cmb alone).

Each test states its tolerance. Both sides are float64 and differ in the order
of the trapezoid sums, in exp/log/pow last bits and in the tridiagonal solver
of the ln P spline (cyclic reduction against the Thomas scan).
"""

import ctypes
import dataclasses
import math
import shutil
import subprocess
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import classpp_public_torch as T
from classpp_public_torch import interop
from classpp_public_torch.models import nonlinear as tnl
from classpp_public_torch.models.primordial import compute_primordial as t_primordial
from classpp_public_torch.ops import cuda
from classpp_public_torch.ops.special import si_ci

import classpp_public_tpu as J
from classpp_public_tpu.models import nonlinear as jnl
from classpp_public_tpu.ops.special import si_ci as j_si_ci
from test_torch_common import asdict, one_torch_thread  # noqa: F401
from test_torch_nonlinear import H, bbks_pk, stage_inputs  # noqa: F401


def t64(a):
    return torch.tensor(np.asarray(a), dtype=torch.float64)


def rel_to_scale(got, want, axis=-1):
    """max |got - want| over `axis`, relative to max |want| there; the worst."""
    got, want = np.asarray(got), np.asarray(want)
    return float(np.max(np.max(np.abs(got - want), axis=axis)
                        / np.max(np.abs(want), axis=axis)))


X_SICI = np.concatenate([np.geomspace(1e-6, 1e4, 4001),
                         [4.0 - 1e-12, 3.999, 4.0, 4.001, 4.0 + 1e-12]])


def test_si_ci_matches_jax():
    """Si and Ci on 1e-6 <= x <= 1e4, both sides of the x = 4 split: rtol 1e-14
    (measured 7.5e-15, Ci near its zero at x = 0.6165; Si equal)."""
    s, c = si_ci(t64(X_SICI))
    js, jc = j_si_ci(jnp.asarray(X_SICI))
    np.testing.assert_allclose(s.numpy(), np.asarray(js), rtol=1e-14, atol=0.0)
    np.testing.assert_allclose(c.numpy(), np.asarray(jc), rtol=1e-14, atol=0.0)


@pytest.fixture(scope="module")
def sigma_inputs():
    """Three growth-scaled BBKS spectra on the HMcode sigma grid (80 a decade,
    1e-5 to 1e6/Mpc) and 40 radii per spectrum, among them 1e-12 and radii
    whose smallest x = k R fall below 0.01."""
    rng = np.random.default_rng(11)
    lnk = math.log(1e-5) + np.arange(881) / 80.0 * math.log(10.0)
    k = np.exp(lnk)
    growth = np.array([1.0, 0.55, 0.2])
    pk = growth[:, None] ** 2 * bbks_pk(k)[None, :] * (1.0 + 0.01 * rng.standard_normal((3, 1)))
    R = np.sort(10.0 ** rng.uniform(-3.0, 2.5, (3, 40)), axis=1)
    R[:, 0] = 1e-12
    return k, lnk, pk, R


def test_hmcode_sigma_plain_matches_jax(sigma_inputs):
    """sigma, dsigma^2/dR and sigma_d against `_sigma_integrals` and
    `_sigma_disp` (nonlinear.py:211-243): 1e-12 of each spectrum's scale."""
    k, lnk, pk, R = sigma_inputs
    base = k**3 * pk / (2.0 * math.pi**2)
    got = tnl.hmcode_sigma(t64(base), t64(k), t64(lnk), t64(R)).numpy()
    assert got.shape == (3, 40, 3)
    kj, lnkj = jnp.asarray(k), jnp.asarray(lnk)
    for i in range(3):
        s, ds2 = jnl._sigma_integrals(kj, jnp.asarray(pk[i]), jnp.asarray(R[i]), lnkj)
        sd = jnl._sigma_disp(kj, jnp.asarray(pk[i]), jnp.asarray(R[i]), lnkj)
        for j, want in enumerate((np.asarray(s), np.asarray(ds2), np.asarray(sd))):
            mine = np.sqrt(got[i, :, j]) if j != 1 else got[i, :, j]
            assert rel_to_scale(mine, want) <= 1e-12, (i, j)
    assert tnl.hmcode_sigma_launches == 0


@pytest.fixture(scope="module")
def onehalo_inputs():
    """Four rows of 256 masses (the HMcode grid 1e3 to 1e18 M_sun/h), nu
    rising past 10, virial radii, concentrations and eta per row, and 40 k
    from 1e-4 to 50/Mpc."""
    rng = np.random.default_rng(12)
    nm, nrow = 256, 4
    m = np.exp(np.linspace(np.log(1e3 / H), np.log(1e18 / H), nm))
    r_real = (3.0 * m / (4.0 * math.pi * 2.7754e11 * H * H * 0.31)) ** (1.0 / 3.0)
    lo = 10.0 ** rng.uniform(-1.5, -0.8, nrow)
    hi = 10.0 ** rng.uniform(1.2, 1.6, nrow)
    nu = np.exp(np.linspace(np.log(lo), np.log(hi), nm).T) * (1.0 + 1e-3 * np.sin(np.arange(nm)))
    rv = r_real[None, :] / (300.0 + 100.0 * rng.random((nrow, 1))) ** (1.0 / 3.0)
    conc = np.maximum(2.5, 3.13 * (1.0 + 4.0 * np.exp(-np.arange(nm) / 60.0)))[None, :] \
        * (1.0 + 0.05 * rng.random((nrow, 1)))
    eta = 0.603 - 0.3 * rng.uniform(0.3, 0.9, nrow)
    k = np.geomspace(1e-4, 50.0, 40)
    return nu, m, rv, conc, eta, k


def test_hmcode_onehalo_plain_matches_jax(onehalo_inputs):
    """The one-halo integral against the JAX expression (nonlinear.py:349-358,
    `_window_nfw`): 1e-12 of each row's scale."""
    nu, m, rv, conc, eta, k = onehalo_inputs
    got = tnl.hmcode_onehalo(*(t64(a) for a in (nu, m, rv, conc, eta, k))).numpy()
    assert got.shape == (4, 40) and (nu > 10.0).any()
    for i in range(4):
        n = jnp.asarray(nu[i])
        gst = 0.21616 * (1.0 + (0.707 * n * n) ** -0.3) * jnp.exp(-0.707 * n * n / 2.0)
        kx = n[None, :] ** eta[i] * jnp.asarray(k)[:, None]
        Wn = jnl._window_nfw(kx, jnp.asarray(rv[i])[None, :], jnp.asarray(conc[i])[None, :])
        integ = jnp.where(n[None, :] <= 10.0, jnp.asarray(m)[None, :] * gst[None, :] * Wn * Wn,
                          0.0)
        want = np.asarray(jnp.trapezoid(integ, n, axis=-1))
        assert rel_to_scale(got[i], want) <= 1e-12, i
    assert tnl.hmcode_onehalo_launches == 0


@pytest.fixture(scope="module")
def host_lib(tmp_path_factory):
    """csrc/hmcode_host.cpp built with g++ (the kernels' node code for the host)."""
    gxx = shutil.which("g++")
    if gxx is None:
        pytest.skip("no g++ to build the host version of the HMcode kernels' code")
    out = tmp_path_factory.mktemp("hmcode_host") / "libhmcode_host.so"
    subprocess.run([gxx, "-O2", "-std=c++17", "-shared", "-fPIC", "-o", str(out),
                    str(Path(cuda.CSRC_DIR) / "hmcode_host.cpp")], check=True)
    return ctypes.CDLL(str(out))


def _ptr(a):
    return a.ctypes.data_as(ctypes.c_void_p)


def test_kernel_code_matches_plain(host_lib, sigma_inputs, onehalo_inputs):
    """The kernels' arithmetic (host build, the kernels' summation order)
    against the plain versions: Si/Ci rtol 1e-14, the sigma integrals and the
    one-halo integral 1e-13 of each row's scale (both float64; the orders of
    the sums and libm's last bits differ)."""
    n = len(X_SICI)
    hs, hc = np.zeros(n), np.zeros(n)
    host_lib.si_ci_host(_ptr(X_SICI), ctypes.c_int(n), _ptr(hs), _ptr(hc))
    s, c = si_ci(t64(X_SICI))
    np.testing.assert_allclose(hs, s.numpy(), rtol=1e-14, atol=0.0)
    np.testing.assert_allclose(hc, c.numpy(), rtol=1e-14, atol=0.0)

    k, lnk, pk, R = sigma_inputs
    base = np.ascontiguousarray(k**3 * pk / (2.0 * math.pi**2))
    out = np.zeros((3, 40, 3))
    assert host_lib.hmcode_sigma_host(_ptr(base), _ptr(k), _ptr(lnk), _ptr(R), 3, len(k), 40,
                                      _ptr(out)) == 0
    plain = tnl.hmcode_sigma_plain(t64(base), t64(k), t64(lnk), t64(R)).numpy()
    for j in range(3):
        assert rel_to_scale(out[:, :, j], plain[:, :, j]) <= 1e-13, j

    nu, m, rv, conc, eta, kk = (np.ascontiguousarray(a) for a in onehalo_inputs)
    out = np.zeros((4, len(kk)))
    assert host_lib.hmcode_onehalo_host(_ptr(nu), _ptr(m), _ptr(rv), _ptr(conc), _ptr(eta),
                                        _ptr(kk), 4, len(m), len(kk), _ptr(out)) == 0
    plain = tnl.hmcode_onehalo_plain(*(t64(a) for a in (nu, m, rv, conc, eta, kk))).numpy()
    assert rel_to_scale(out, plain) <= 1e-13


def test_extend_pk_and_growint_match_jax(stage_inputs):
    """`_extend_pk` on two redshifts of the hand-made table and `_growint` for
    w0 = -1, above and below it: 1e-13 relative."""
    params, pr, bg, bidx, pm, pert = stage_inputs
    tp = interop.cosmo_params(dataclasses.asdict(params))
    pmt = t_primordial(tp)
    for z in (0.0, 2.0):
        pk = np.asarray(jnl.pk_linear_at_z(pert, bg, pm, z))
        kj, pj = jnl._extend_pk(pert.k, jnp.asarray(pk), pm, 1e6)
        kt, pt = tnl._extend_pk(t64(pert.k_np), t64(pk), pmt, 1e6, k_np=pert.k_np)
        np.testing.assert_allclose(kt.numpy(), np.asarray(kj), rtol=1e-13, atol=0.0)
        np.testing.assert_allclose(pt.numpy(), np.asarray(pj), rtol=1e-13, atol=0.0)
        assert len(kt) == len(pert.k_np) + int(math.log10(1e6 / pert.k_np[-1]) * 10) + 1
    for args in ((0.31, 0.0, 0.69, -1.0, 0.0), (0.3, 0.01, 0.69, -0.9, 0.1),
                 (0.32, -0.01, 0.69, -1.1, -0.2)):
        assert tnl._growint(*args) == pytest.approx(float(jnl._growint(*args)), rel=1e-13)


Z_STAGE = (0.0, 0.5, 2.0, 7.0)


@pytest.fixture(scope="module")
def jax_hmcode(stage_inputs):
    """The JAX compute_nonlinear(method="hmcode") at z = 0, 0.5, 2, 7 with each
    feedback (its redshifts are independent rows of a vmap, so z = 0 alone is
    the first row)."""
    params, pr, bg, bidx, pm, pert = stage_inputs
    out = {}
    for name in ("emu_dmonly", "owls_agn"):
        eta0, cmin = jnl.HMCODE_FEEDBACK[name]
        ref = jnl.compute_nonlinear(pert, bg, bidx, pm, pr, params, z_pk=Z_STAGE,
                                    method="hmcode", hm_eta0=eta0, hm_cmin=cmin)
        out[name] = interop.pk_result(asdict(ref), "cpu")
    return out


@pytest.mark.parametrize("z_pk", [(0.0,), Z_STAGE])
@pytest.mark.parametrize("feedback", ["emu_dmonly", "owls_agn"])
def test_compute_hmcode_matches_jax(stage_inputs, jax_hmcode, z_pk, feedback):
    """compute_nonlinear(method="hmcode") against the JAX one (nonlinear.py:368)
    on the hand-made table, total and cb rows: pk_lin, pk_cb_lin, pk_nl,
    pk_cb_nl, k_nl, k_nl_cb and sigma8 to 1e-8 relative."""
    params, pr, bg, bidx, pm, pert = stage_inputs
    eta0, cmin = tnl.HMCODE_FEEDBACK[feedback]
    assert tnl.HMCODE_FEEDBACK == jnl.HMCODE_FEEDBACK
    tp = interop.cosmo_params(dataclasses.asdict(params))
    bgt, bit = interop.background(asdict(bg), "cpu", names=bidx.names)
    got = tnl.compute_nonlinear(interop.perturb(asdict(pert), "cpu"), bgt, bit, t_primordial(tp),
                                interop.precision_params(dataclasses.asdict(pr)), tp, z_pk=z_pk,
                                method="hmcode", hm_eta0=eta0, hm_cmin=cmin)
    want, rows = jax_hmcode[feedback], slice(0, len(z_pk))
    np.testing.assert_array_equal(got.k.numpy(), want.k.numpy())
    np.testing.assert_array_equal(got.z.numpy(), want.z.numpy()[rows])
    for f in ("pk_lin", "pk_nl", "pk_cb_lin", "pk_cb_nl", "k_nl", "k_nl_cb"):
        np.testing.assert_allclose(getattr(got, f).numpy(), getattr(want, f).numpy()[rows],
                                   rtol=1e-8, atol=0.0, err_msg=f)
    assert got.sigma8 == pytest.approx(want.sigma8, rel=1e-8)
    assert got.pk_nl.shape == (len(z_pk), 36)
    assert not np.allclose(got.pk_cb_nl.numpy(), got.pk_nl.numpy(), rtol=1e-4)
    assert got.pk_nl[0, -1] > 2.0 * got.pk_lin[0, -1]     # the one-halo term at 5/Mpc, z = 0
    assert tnl.hmcode_sigma_launches == tnl.hmcode_onehalo_launches == 0


# --- the whole Class ---------------------------------------------------------

# small precision; the same keys on both sides. The P(k) redshifts are the
# nonlinear source ratio's 24 (pipeline.py:232), so the JAX package's eager
# HMcode runs one batch shape twice; 64 masses in the one-halo integral.
Z_RATIO = np.concatenate([[0.0], np.geomspace(0.05, 10.0, 23)])
POINT = {"h": 0.6736, "omega_b": 0.02237, "omega_cdm": 0.1200, "A_s": 2.0989e-9,
         "n_s": 0.9649, "tau_reio": 0.0544, "lensing": "yes", "l_max_scalars": 60,
         "background_Nloga": 1024, "recfast_Nz0": 4000, "perturb_sampling_stepsize": 2.0,
         "tol_perturb_integration": 1e-3, "k_step_sub": 0.3, "k_step_super": 0.02,
         "k_per_decade_for_pk": 5.0, "k_per_decade_for_bao": 8.0, "delta_l_max": 100,
         "nonlinear_min_k_max": 1.0, "halofit_min_k_max": 1.0, "hmcode_min_k_max": 1.0,
         "nsteps_for_p1h_integral": 64, "z_pk": ", ".join(repr(float(z)) for z in Z_RATIO)}
CL_ONLY, WITH_PK = "tCl,pCl,lCl", "tCl,pCl,lCl,mPk"
CL_TYPES = ("tt", "ee", "te", "pp")
METHODS = {"hmcode": {"c_min": 2.6}, "halofit": {}}


@pytest.fixture(scope="module")
def jax_runs():
    """The JAX Class with mPk, for hmcode (c_min 2.6) and halofit."""
    runs = {}
    for method, extra in METHODS.items():
        c = J.Class()
        c.set(dict(POINT, output=WITH_PK, **{"non linear": method}, **extra))
        c.compute(["lensing"])
        runs[method] = c
    return runs


@pytest.fixture(scope="module")
def port_runs(jax_runs):
    """The port's Class for each (method, output), from the JAX background and
    thermodynamics (the tau sampling reads their last bits). Each computes its
    own perturbations but halofit with mPk, which takes hmcode's with mPk:
    the method does not enter the perturbation stage."""
    cj = jax_runs["hmcode"]
    bg, bidx = cj.cosmo.background
    runs = {}
    for method, extra in METHODS.items():
        for output in (WITH_PK, CL_ONLY):
            c = T.Class(device="cpu")
            c.set(dict(POINT, output=output, **{"non linear": method}, **extra))
            c.cosmo.set_stage("background", interop.background(asdict(bg), "cpu",
                                                               names=bidx.names))
            c.cosmo.set_stage("thermodynamics",
                              interop.thermo(asdict(cj.cosmo.thermodynamics), "cpu"))
            if (method, output) == ("halofit", WITH_PK):
                c.cosmo.set_stage("perturbations", runs["hmcode", WITH_PK].cosmo.perturbations)
            c.compute(["lensing"])
            runs[method, output] = c
    return runs


def test_class_hmcode_matches_jax(jax_runs, port_runs):
    """`non linear = hmcode` (c_min 2.6, eta_0 = 0.668 by the one-key rule)
    through both classy surfaces, each on its own perturbations: the grids
    equal, the nonlinear stage, raw and lensed TT/EE/TE/phiphi and pk to
    1e-3, the tolerance of the integrators at rtol 1e-3 (measured 1e-4 in
    P_lin), as test_torch_slice.py holds reduced row2_exact. The port's
    HMcode on the JAX perturbation table: every field of PkResult and the
    phi+psi source ratio to 1e-8."""
    cj, ct = jax_runs["hmcode"], port_runs["hmcode", WITH_PK]
    assert ct.cosmo.out.hm_eta0 == cj.cosmo.out.hm_eta0 == pytest.approx(0.668)
    np.testing.assert_array_equal(ct.cosmo.perturbations.k_np, cj.cosmo.perturbations.k_np)
    np.testing.assert_array_equal(ct.cosmo.perturbations.tau_np, cj.cosmo.perturbations.tau_np)
    nj, nt = cj.cosmo.nonlinear, ct.cosmo.nonlinear
    for f in ("pk_lin", "pk_nl", "pk_cb_lin", "pk_cb_nl", "k_nl", "k_nl_cb"):
        np.testing.assert_allclose(getattr(nt, f).numpy(), np.asarray(getattr(nj, f)),
                                   rtol=1e-3, err_msg=f)
    np.testing.assert_allclose(ct.cosmo.nl_source_ratio.numpy(),
                               np.asarray(cj.cosmo.nl_source_ratio), rtol=1e-3)
    for name, a, b in (("raw", ct.raw_cl(60), cj.raw_cl(60)),
                       ("lensed", ct.lensed_cl(60), cj.lensed_cl(60))):
        for spec in CL_TYPES:
            assert rel_to_scale(a[spec][2:], b[spec][2:], axis=0) <= 1e-3, (name, spec)
    for z in (0.0, 1.0):
        for kk in (0.05, 0.3, 0.9):
            assert ct.pk(kk, z) == pytest.approx(cj.pk(kk, z), rel=1e-3)
    assert ct.pk(0.9, 0.0) > 1.1 * ct.pk_lin(0.9, 0.0)

    # the port's stages from the JAX perturbation table on: every field of the
    # nonlinear stage and the phi+psi source ratio to 1e-8, the lensed C_l to
    # 1e-6 of each spectrum's scale (the LOS scans' Bessel band, ~1e-8)
    c = T.Cosmology(ct.cosmo.params, ct.cosmo.pr, ct.cosmo.out, device="cpu")
    for stage in ("background", "thermodynamics"):
        c.set_stage(stage, ct.cosmo._cache["bg" if stage == "background" else "th"])
    c.set_stage("perturbations", interop.perturb(asdict(cj.cosmo.perturbations), "cpu"))
    for f in ("pk_lin", "pk_nl", "pk_cb_lin", "pk_cb_nl", "k_nl", "k_nl_cb"):
        np.testing.assert_allclose(getattr(c.nonlinear, f).numpy(), np.asarray(getattr(nj, f)),
                                   rtol=1e-8, atol=0.0, err_msg=f)
    assert c.nonlinear.sigma8 == pytest.approx(float(nj.sigma8), rel=1e-8)
    rj = np.asarray(cj.cosmo.nl_source_ratio)
    np.testing.assert_allclose(c.nl_source_ratio.numpy(), rj, rtol=1e-8, atol=0.0)
    assert rj.max() > 1.02 and rj[0].max() == 1.0       # boosted late, linear beyond z = 10
    lensed, want = c.lensing.cl.numpy(), np.asarray(cj.cosmo.lensing.cl)
    assert rel_to_scale(lensed[:, :4], want[:, :4], axis=0) <= 1e-6


@pytest.mark.parametrize("method", ["hmcode", "halofit"])
def test_cl_only_nonlinear_samples_full_k(jax_runs, port_runs, method):
    """Cl-only output with a nonlinear method: the port's k grid is the one
    with mPk (computed anew for each method), and its lensed TT/EE/TE/phiphi
    equal those of the same point with mPk to 1e-12 of each spectrum's scale,
    and the JAX Class's with mPk to 1e-3 (the integrators at rtol 1e-3)."""
    cl_only, with_pk = port_runs[method, CL_ONLY], port_runs[method, WITH_PK]
    k_cl = cl_only.cosmo.perturbations.k_np
    np.testing.assert_array_equal(k_cl, with_pk.cosmo.perturbations.k_np)
    assert k_cl[-1] >= 1.0 and not cl_only.cosmo.out.has_pk
    a, b = cl_only.lensed_cl(60), with_pk.lensed_cl(60)
    c = jax_runs[method].lensed_cl(60)
    for spec in CL_TYPES:
        assert rel_to_scale(a[spec][2:], b[spec][2:], axis=0) <= 1e-12, spec
        assert rel_to_scale(a[spec][2:], c[spec][2:], axis=0) <= 1e-3, spec


@pytest.mark.parametrize("keys", [
    {}, {"feedback model": "owls_agn"}, {"feedback_model": "owls_ref"}, {"eta_0": 0.7},
    {"c_min": 2.6}, {"eta_0": 0.65, "c_min": 3.0}, {"feedback model": "owls_dblim", "c_min": 2.9},
    {"hmcode_min_k_max": 25.0},
])
def test_feedback_parse_matches_jax(keys):
    """The HMcode keys parse as the JAX classy parses them: the presets, each
    one-key rule eta_0 = 0.98 - 0.12 c_min, both keys, a preset overridden by
    c_min, and the method's own P_k_max floor."""
    full = dict(keys, output="mPk", **{"non linear": "hmcode"})
    ct, cj = T.Class(device="cpu"), J.Class()
    ct.set(dict(full))
    cj.set(dict(full))
    ot, oj = ct.cosmo.out, cj.cosmo.out
    assert (ot.hm_eta0, ot.hm_cmin, ot.non_linear) == (oj.hm_eta0, oj.hm_cmin, oj.non_linear)
    assert ot.P_k_max == oj.P_k_max == max(20.0, keys.get("hmcode_min_k_max", 0.0))


def test_unknown_feedback_model_raises():
    for cls, err in ((T.Class(device="cpu"), T.CosmoSevereError),
                     (J.Class(), J.CosmoSevereError)):
        cls.set({"output": "mPk", "non linear": "hmcode", "feedback model": "owls_bogus"})
        with pytest.raises(err, match="unknown feedback model"):
            cls.cosmo

"""The port's whole slice (perturbations -> transfer -> spectra -> lensing ->
P(k)) against the JAX `Cosmology` as __graft_entry__.dryrun_multichip builds
it: small precision, l_scalar_max = 100, lensing on, plus mPk, with tensor
modes (r = 0.1, n_t and alpha_t from the slow-roll consistency relations,
l_max_tensors = 60) beside the scalars (CPU).

Both pipelines start from the same background and thermodynamics (the JAX
stages moved across with classpp_public_torch.interop): the source sampling
in tau steps by a rate containing the third derivative of the optical depth,
whose last-bit noise decides which samples land where, so independently
computed tables give another (equally valid) sampling. The stage modules are
compared one by one in the other test_torch_* files.

Tolerance 1e-3 relative (TE against sqrt(TT EE)), ten times tighter than the
reference CI contract; the two agree to ~1e-8. The tensor part (raw TT, EE,
BB and the lensed BB, to which the unlensed tensor BB contributes) is held to
1e-6 relative.

A reduced `row2_exact` goes the same way: one 0.06 eV neutrino species and
halofit, l_scalar_max = 60, P(k) to 0.35/Mpc, rtol 1e-3, coarse k steps. There
the integrators' accept/reject decisions may differ (rtol 1e-3 on a 334-wide
state), so the spectra are held to 3e-3 and the halofit ratio to 1e-3.
"""

import numpy as np
import pytest
import torch

import classpp_public_torch as T
from classpp_public_torch import interop
from classpp_public_torch.models.nonlinear import pk_linear_at_z as t_pk
from classpp_public_torch.models.spectra import CT_TYPES

import classpp_public_tpu as J
from classpp_public_tpu.models.nonlinear import pk_linear_at_z as j_pk
from test_torch_common import asdict, one_torch_thread  # noqa: F401

SMALL = dict(background_Nloga=1024, recfast_Nz0=4000, perturb_sampling_stepsize=2.0,
             tol_perturb_integration=1e-4)
OUT = dict(tCl=True, pCl=True, lCl=True, mPk=True, lensing=True, l_scalar_max=100,
           P_k_max=0.2, modes=("s", "t"), l_tensor_max=60)
TOL = 1e-3
# r = 0.1 with n_t, alpha_t from the consistency relations (classy.py:620-627)
R, N_S = 0.1, 0.9619
TENSOR = dict(r=R, n_t=-R / 8.0 * (2.0 - R / 8.0 - N_S), alpha_t=R / 8.0 * (R / 8.0 + N_S - 1.0))


def _pk_at(pert_k, pk, k):
    return float(np.exp(np.interp(np.log(k), np.log(pert_k), np.log(pk))))


@pytest.fixture(scope="module")
def pipelines():
    import dataclasses

    params = J.CosmoParams(**TENSOR)
    prj = J.PrecisionParams(k_chunk_size=8, **SMALL)
    cj = J.Cosmology(params, precision=prj, output=J.OutputSelection(**OUT))
    cj.lensing
    ct = T.Cosmology(interop.cosmo_params(dataclasses.asdict(params)),
                     interop.precision_params(dataclasses.asdict(prj)),
                     T.OutputSelection(**OUT), device="cpu")
    bg, bidx = cj.background
    ct.set_stage("background", interop.background(asdict(bg), "cpu", names=bidx.names))
    ct.set_stage("thermodynamics", interop.thermo(asdict(cj.thermodynamics), "cpu"))
    ct.compute(["lensing"])
    return cj, ct


def _check_cls(a, b, n, tol=TOL):
    a, b = np.asarray(a)[:n], np.asarray(b)[:n]
    for i, name in enumerate(CT_TYPES):
        if name in ("tp", "ep"):
            continue
        if name == "te":
            den = np.sqrt(np.abs(b[:, 0] * b[:, 1]))
        else:
            den = np.abs(b[:, i])
        zero = den == 0.0   # BB above l_max_tensors before lensing
        assert np.all(a[zero, i] == 0.0), name
        if zero.all():
            continue
        rel = np.max(np.abs(a[~zero, i] - b[~zero, i]) / den[~zero])
        assert rel <= tol, (name, rel)


def test_grids_match(pipelines):
    cj, ct = pipelines
    np.testing.assert_allclose(ct.perturbations.k_np, cj.perturbations.k_np, rtol=1e-13)
    np.testing.assert_allclose(ct.perturbations.tau_np, cj.perturbations.tau_np, rtol=1e-13)
    np.testing.assert_array_equal(ct.transfer.l.numpy(), np.asarray(cj.transfer.l))


def test_raw_cls_match_jax(pipelines):
    cj, ct = pipelines
    assert ct.spectra.cl.shape == tuple(np.asarray(cj.spectra.cl).shape)
    _check_cls(ct.spectra.cl.numpy(), cj.spectra.cl, n=99)


def test_lensed_cls_match_jax(pipelines):
    cj, ct = pipelines
    assert ct.lensing.cl.shape == (99, 7)
    _check_cls(ct.lensing.cl.numpy(), cj.lensing.cl, n=99)


def test_pk_lin_matches_jax(pipelines):
    cj, ct = pipelines
    bgj, _ = cj.background
    bgt, _ = ct.background
    pj = np.asarray(j_pk(cj.perturbations, bgj, cj.primordial, 0.0))
    pt = t_pk(ct.perturbations, bgt, ct.primordial, 0.0).numpy()
    assert np.max(np.abs(pt - pj) / pj) <= TOL
    k = cj.perturbations.k_np
    assert _pk_at(k, pt, 0.1) == pytest.approx(_pk_at(k, pj, 0.1), rel=TOL)


def test_tensor_cls_match_jax(pipelines):
    """The tensor modes through both pipelines from shared tables: the tensor
    part of the raw TT, EE, BB to l_max_tensors, the total raw TT, EE, BB, and
    the lensed BB, to 1e-6 relative."""
    cj, ct = pipelines
    assert ct.stages("lensing") == ["background", "thermodynamics", "perturbations",
                                    "primordial", "nonlinear", "transfer",
                                    "tensor_perturbations", "tensor_transfer", "spectra",
                                    "lensing"]
    np.testing.assert_allclose(ct.tensor_perturbations.k_np, cj.tensor_perturbations.k_np,
                               rtol=1e-13)
    ix = {n: CT_TYPES.index(n) for n in ("tt", "ee", "bb")}
    got_t, ref_t = ct.spectra.cl_tensor.numpy(), np.asarray(cj.spectra.cl_tensor)
    n_t = OUT["l_tensor_max"] - 1
    for name, i in ix.items():
        rel = np.abs(got_t[:n_t, i] - ref_t[:n_t, i]) / np.abs(ref_t[:n_t, i])
        assert rel.max() <= 1e-6, name
    assert not got_t[n_t:].any()
    raw, raw_j = ct.spectra.cl.numpy(), np.asarray(cj.spectra.cl)
    for name in ("tt", "ee", "bb"):   # scalar + tensor
        n = n_t if name == "bb" else 99
        assert np.max(np.abs(raw[:n, ix[name]] / raw_j[:n, ix[name]] - 1.0)) <= 1e-6, name
    got, ref = ct.lensing.cl.numpy()[:99, ix["bb"]], np.asarray(cj.lensing.cl)[:99, ix["bb"]]
    assert (ref > 0).all()
    assert np.max(np.abs(got - ref) / ref) <= 1e-6


@pytest.mark.parametrize("stage", ["transfer", "lensing"])
def test_stage_from_jax_input(pipelines, stage):
    """One port stage fed the JAX stage's own input through interop."""
    from classpp_public_torch.models.lensing import compute_lensing
    from classpp_public_torch.models.transfer import compute_transfer

    cj, ct = pipelines
    if stage == "transfer":
        got = compute_transfer(interop.perturb(asdict(cj.perturbations), "cpu"),
                               ct.thermodynamics, ct.pr, l_max=ct.l_max_internal).delta
        ref = np.asarray(cj.transfer.delta)
        for i in range(ref.shape[1]):
            scale = np.max(np.abs(ref[:, i]))
            assert np.max(np.abs(got[:, i].numpy() - ref[:, i])) <= 1e-6 * scale, i
    else:
        got = compute_lensing(interop.spectra(asdict(cj.spectra), "cpu"), ct.pr,
                              l_lensed_max=OUT["l_scalar_max"]).cl.numpy()
        _check_cls(got, cj.lensing.cl, n=99)


ROW2 = dict(m_ncdm=(0.06,), N_ur=2.0328, YHe=0.2454006, tau_reio=0.0543, z_reio=None)
ROW2_PR = dict(SMALL, tol_perturb_integration=1e-3, k_step_sub=0.3, k_step_super=0.02,
               k_per_decade_for_pk=5.0, k_per_decade_for_bao=8.0, delta_l_max=100)
ROW2_OUT = dict(tCl=True, pCl=True, lCl=True, mPk=True, lensing=True, l_scalar_max=60,
                P_k_max=0.35, non_linear="halofit")


@pytest.fixture(scope="module")
def row2_pipelines():
    import dataclasses

    params = J.CosmoParams(**ROW2)
    prj = J.PrecisionParams(k_chunk_size=8, **ROW2_PR)
    cj = J.Cosmology(params, precision=prj, output=J.OutputSelection(**ROW2_OUT))
    cj.lensing
    ct = T.Cosmology(interop.cosmo_params(dataclasses.asdict(params)),
                     interop.precision_params(dataclasses.asdict(prj)),
                     T.OutputSelection(**ROW2_OUT), device="cpu")
    bg, bidx = cj.background
    ct.set_stage("background", interop.background(asdict(bg), "cpu", names=bidx.names))
    ct.set_stage("thermodynamics", interop.thermo(asdict(cj.thermodynamics), "cpu"))
    ct.compute(["lensing"])
    return cj, ct


def test_row2_exact_reduced_matches_jax(row2_pipelines):
    """Reduced row2_exact (ncdm + halofit) through both pipelines from shared
    tables: grids equal, raw and lensed C_l to 3e-3, the nonlinear stage and
    the source ratio that scales phi+psi to 1e-3."""
    cj, ct = row2_pipelines
    np.testing.assert_allclose(ct.perturbations.k_np, cj.perturbations.k_np, rtol=1e-13)
    np.testing.assert_allclose(ct.perturbations.tau_np, cj.perturbations.tau_np, rtol=1e-13)
    assert ct.stages("lensing") == ["background", "thermodynamics", "perturbations",
                                    "primordial", "nonlinear", "transfer", "spectra", "lensing"]
    _check_cls(ct.spectra.cl.numpy(), cj.spectra.cl, n=59, tol=3e-3)
    _check_cls(ct.lensing.cl.numpy(), cj.lensing.cl, n=59, tol=3e-3)
    nj, nt = cj.nonlinear, ct.nonlinear
    for f in ("pk_lin", "pk_nl", "pk_cb_lin", "pk_cb_nl", "k_nl"):
        np.testing.assert_allclose(getattr(nt, f).numpy(), np.asarray(getattr(nj, f)),
                                   rtol=1e-3, err_msg=f)
    assert nt.sigma8 == pytest.approx(float(nj.sigma8), rel=1e-3)
    rj, rt = np.asarray(cj.nl_source_ratio), ct.nl_source_ratio.numpy()
    assert rt.shape == rj.shape == (len(ct.perturbations.tau_np), len(ct.perturbations.k_np))
    np.testing.assert_allclose(rt, rj, rtol=1e-3)
    assert rt.max() > 1.05 and rt[0].max() == 1.0   # boosted late, linear beyond z = 10


def test_row2_exact_sources_feed_transfer(row2_pipelines):
    """phi+psi entering the transfer carries the ratio; the other columns and
    the stored table do not."""
    from classpp_public_torch.models.perturbations.indices import SrcIdx

    _, ct = row2_pipelines
    pert = ct.perturbations
    scaled = ct._pert_for_transfer(pert)
    col = SrcIdx.ix["phi_plus_psi"]
    want = pert.sources[:, :, col] * ct.nl_source_ratio.T
    assert torch.equal(scaled.sources[:, :, col], want)
    rest = [i for i in range(SrcIdx.n) if i != col]
    assert torch.equal(scaled.sources[:, :, rest], pert.sources[:, :, rest])
    assert (pert.sources[:, :, SrcIdx.ix["delta_ncdm"]].abs().max() > 0)
    with pytest.raises(AssertionError, match="does not match"):
        ct._pert_for_transfer(pert._replace(sources=pert.sources[:-1]))


def test_class_api_on_cpu():
    """The classy entry point runs the slice on its own tables (coarse k
    steps: this test checks the entry point, not the numbers)."""
    c = T.Class(device="cpu")
    c.set({"output": "tCl,pCl,lCl,mPk", "lensing": "yes", "l_max_scalars": 60,
           "P_k_max_1/Mpc": 0.2, "delta_l_max": 100, "modes": "s,t", "r": 0.1, "n_t": "scc",
           "l_max_tensors": 40, **dict(SMALL, tol_perturb_integration=1e-3, k_step_sub=0.3,
                                       k_step_super=0.02)})
    c.compute(["lensing"])
    cl, raw = c.lensed_cl(), c.raw_cl()
    for tab in (cl, raw):
        assert tab["tt"].shape == (61,)
        for name in ("tt", "ee", "bb"):
            assert np.isfinite(tab[name]).all() and (tab[name][2:41] > 0).all(), name
    assert (cl["bb"][2:] > 0).all() and not raw["bb"][41:].any()
    assert np.isfinite(c.pk_lin(0.1, 0.0)) and c.pk_lin(0.1, 0.0) > 0
    assert c.cosmo.device == torch.device("cpu")
    from classpp_public_torch.models import lensing, thermodynamics, transfer
    from classpp_public_torch.models.perturbations import tensors

    assert transfer.launches == 0 and lensing.launches == 0
    assert transfer.tensor_launches == tensors.launches == 0
    assert thermodynamics.recfast_launches == thermodynamics.tb_march_launches == 0


def test_no_card_no_fallback(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="cuda"):
        T.Class()
    with pytest.raises(RuntimeError, match="cuda"):
        T.Cosmology(T.CosmoParams())


def test_unported_inputs_raise():
    c = T.Class(device="cpu")
    c.set({"output": "tCl,mPk", "evolver": "rkck"})
    with pytest.raises(NotImplementedError, match="rkck"):
        c.compute()
    c = T.Class(device="cpu")
    c.set({"output": "tCl", "N_ncdm": 1, "ksi_ncdm": 0.1})
    with pytest.raises(NotImplementedError, match="ksi_ncdm"):
        c.compute()


def test_row2_exact_inputs_parse():
    """The row2_exact keys: omega_ncdm is inverted for the mass as the JAX
    classy does (1e-7 relative, the bisection's own tolerance), H0 gives h,
    and halofit raises P_k_max to nonlinear_min_k_max."""
    keys = {"H0": 67.32117, "omega_b": 0.02238280, "N_ur": 2.03066666667,
            "omega_cdm": 0.1201075, "N_ncdm": 1, "omega_ncdm": 0.0006451439,
            "YHe": 0.2454006, "tau_reio": 0.05430842, "n_s": 0.9660499, "A_s": 2.100549e-09,
            "non linear": "halofit", "output": "tCl,pCl,lCl,mPk", "lensing": "yes"}
    ct, cj = T.Class(device="cpu"), J.Class()
    ct.set(dict(keys))
    cj.set(dict(keys))
    pt, pj = ct.cosmo.params, cj.cosmo.params
    assert pt.m_ncdm == pytest.approx(pj.m_ncdm, rel=1e-7) and len(pt.m_ncdm) == 1
    assert pt.m_ncdm[0] == pytest.approx(0.06, rel=5e-3)
    for f in ("h", "omega_b", "omega_cdm", "N_ur", "YHe", "tau_reio", "z_reio", "n_s", "A_s"):
        assert getattr(pt, f) == getattr(pj, f), f
    assert pt.N_eff == pytest.approx(pj.N_eff, rel=1e-14)
    ot, oj = ct.cosmo.out, cj.cosmo.out
    assert ot.non_linear == oj.non_linear == "halofit"
    assert ot.P_k_max == oj.P_k_max == 20.0 and ot.l_scalar_max == oj.l_scalar_max == 2500


@pytest.mark.parametrize("extra", [{}, {"alpha_t": "scc", "tensor method": "photons"},
                                   {"n_t": -0.02, "alpha_t": 0.001}])
def test_tensor_inputs_parse(extra):
    """The g3_tensor keys (tests/golden/gen/g3_tensor.ini) and variants parse
    as the JAX classy parses them: r, n_t and alpha_t (slow-roll consistency
    where 'scc' or absent), the tensor method, modes and l_max_tensors."""
    from classpp_public_torch.tools.configs import G3_TENSOR

    keys = dict(G3_TENSOR, **extra)
    ct, cj = T.Class(device="cpu"), J.Class()
    ct.set(dict(keys))
    cj.set(dict(keys))
    pt, pj = ct.cosmo.params, cj.cosmo.params
    for f in ("r", "n_t", "alpha_t", "tensor_method", "n_s", "A_s", "h", "YHe", "z_reio",
              "Omega_k", "gauge", "recombination"):
        assert getattr(pt, f) == getattr(pj, f), f
    ot, oj = ct.cosmo.out, cj.cosmo.out
    assert ot.modes == oj.modes == ("s", "t")
    assert ot.l_tensor_max == oj.l_tensor_max == 500
    assert ot.l_scalar_max == oj.l_scalar_max == 2500


@pytest.mark.parametrize("keys,err,match", [
    ({"output": "tCl", "modes": "s,v"}, "severe", "vector"),
    ({"output": "mPk", "modes": "s,t"}, "severe", "tensor source"),
    ({"output": "tCl", "tensor method": "photons"}, "severe", "tensor method"),
    ({"output": "tCl,lCl", "modes": "t"}, "severe", "lensing potential"),
    ({"output": "tCl,pCl", "modes": "s,t", "tensor method": "bogus", "N_ncdm": 1},
     "severe", "unknown tensor method"),
])
def test_tensor_input_guards(keys, err, match):
    """The reference's consistency guards, and an unknown tensor method."""
    exc = T.CosmoSevereError if err == "severe" else NotImplementedError
    c = T.Class(device="cpu")
    c.set(keys)
    with pytest.raises(exc, match=match):
        c.cosmo

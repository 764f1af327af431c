"""classpp_public_torch ops against classpp_public_tpu ops on identical
seeded inputs (CPU).

Tolerance 1e-12 relative: both are float64 implementations of the same
formulas; only the tridiagonal solve differs in algorithm (cyclic reduction
vs the Thomas scan), which moves results by a few ulp on these strictly
diagonally dominant systems.
"""

import pathlib
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from classpp_public_torch.ops import ode as tode
from classpp_public_torch.ops import quadrature as tquad
from classpp_public_torch.ops import splines as tspl
from classpp_public_tpu.ops import ode as jode
from classpp_public_tpu.ops import quadrature as jquad
from classpp_public_tpu.ops import splines as jspl
from test_torch_common import one_torch_thread  # noqa: F401

RTOL = 1e-12


def _t(a):
    return torch.as_tensor(np.asarray(a), dtype=torch.float64)


def _close(a, b, rtol=RTOL):
    a, b = np.asarray(a), np.asarray(b)
    scale = np.max(np.abs(b))
    assert a.shape == b.shape
    assert np.max(np.abs(a - b)) <= rtol * scale, np.max(np.abs(a - b)) / scale


@pytest.fixture(scope="module")
def data():
    rng = np.random.default_rng(1234)
    # random but not pathologically clustered nodes (the est-deriv end
    # slopes difference nearby nodes)
    x = np.cumsum(rng.uniform(0.1, 0.3, 57))
    y = np.stack([np.sin(x) * (1 + 0.1 * x), np.exp(-0.3 * x), rng.normal(size=57)], axis=1)
    xq = rng.uniform(x[0], x[-1], 200)
    return x, y, xq


def test_tridiag_solve(data):
    rng = np.random.default_rng(7)
    n = 41
    dl, du = rng.uniform(-1, 1, n), rng.uniform(-1, 1, n)
    d = 3.0 + rng.uniform(0, 1, n)
    b = rng.normal(size=(n, 3))
    _close(tspl.tridiag_solve(_t(dl), _t(d), _t(du), _t(b)),
           jspl.tridiag_solve(jnp.asarray(dl), jnp.asarray(d), jnp.asarray(du), jnp.asarray(b)))


@pytest.mark.parametrize("bc", ["natural", "est_deriv"])
def test_spline_d2_eval_integrate(data, bc):
    x, y, xq = data
    jd2 = jspl.spline_d2(jnp.asarray(x), jnp.asarray(y), bc=bc)
    td2 = tspl.spline_d2(_t(x), _t(y), bc=bc)
    _close(td2, jd2)
    _close(tspl.spline_d2(_t(x), _t(y[:, 0]), bc=bc), jspl.spline_d2(jnp.asarray(x), jnp.asarray(y[:, 0]), bc=bc))
    _close(tspl.spline_eval(_t(x), _t(y), td2, _t(xq)),
           jspl.spline_eval(jnp.asarray(x), jnp.asarray(y), jd2, jnp.asarray(xq)))
    _close(tspl.spline_integrate(_t(x), _t(y), td2),
           jspl.spline_integrate(jnp.asarray(x), jnp.asarray(y), jd2))
    _close(tspl.spline_integrate_reverse(_t(x), _t(y), td2),
           jspl.spline_integrate_reverse(jnp.asarray(x), jnp.asarray(y), jd2))


def test_uniform_spline_and_linear(data):
    _, y, _ = data
    rng = np.random.default_rng(3)
    x0, dx = -2.0, 0.125
    xq = rng.uniform(x0 - 0.5, x0 + dx * (len(y) - 1) + 0.5, 300)
    js = jspl.UniformSpline.build(x0, dx, jnp.asarray(y))
    ts = tspl.UniformSpline.build(x0, dx, _t(y))
    _close(ts.y2, js.y2)
    _close(ts.eval(_t(xq)), js.eval(jnp.asarray(xq)))
    _close(ts.eval_deriv(_t(xq)), js.eval_deriv(jnp.asarray(xq)))
    _close(tspl.linear_interp_uniform(x0, dx, _t(y), _t(xq)),
           jspl.linear_interp_uniform(x0, dx, jnp.asarray(y), jnp.asarray(xq)))
    xp = np.sort(rng.uniform(0, 1, 30))
    fp = rng.normal(size=30)
    xi = rng.uniform(-0.2, 1.2, 100)
    _close(tspl.interp(_t(xi), _t(xp), _t(fp)), np.interp(xi, xp, fp))


def test_quadrature():
    x, w = tquad.gauss_legendre(37, 0.5, 2.0)
    xj, wj = jquad.gauss_legendre(37, 0.5, 2.0)
    _close(x, xj)
    _close(w, wj)
    g = np.sort(np.random.default_rng(5).uniform(0, 3, 25))
    _close(tquad.trapz_weights(_t(g)), jquad.trapz_weights(jnp.asarray(g)))
    _close(tquad.trapz_weights_np(g), jquad.trapz_weights_np(g))


def test_ark43_step_stiff_linear():
    """One ARK4(3)6L step on y' = A y + J(t) y with a stiff diagonal J,
    batched over lanes with per-lane t and h; JAX vmapped over the same."""
    rng = np.random.default_rng(11)
    L, n = 5, 6
    A = rng.normal(size=(n, n)) * 0.3
    kap = np.array([1e4, 3e3, 0.0, 50.0, 1e5, 0.0])
    y0 = rng.normal(size=(L, n))
    t0 = rng.uniform(0.5, 1.0, L)
    h = rng.uniform(0.01, 0.1, L)

    def j_rhs(t, y, a):
        return jnp.asarray(A) @ y - (1.0 + t) * jnp.asarray(kap) * y

    def j_apply(t, y, a):
        return -(1.0 + t) * jnp.asarray(kap) * y

    def j_solve(t, gh, r, a):
        return r / (1.0 + gh * (1.0 + t) * jnp.asarray(kap))

    jy, jerr, jk1 = jax.vmap(lambda t, y, hh: jode.ark43_step(j_rhs, j_apply, j_solve, t, y, hh, None))(
        jnp.asarray(t0), jnp.asarray(y0), jnp.asarray(h))

    At, kt = _t(A), _t(kap)

    def t_rhs(fr, y):
        t, _ = fr
        return y @ At.T - (1.0 + t)[:, None] * kt * y

    def t_apply(fr, y):
        t, _ = fr
        return -(1.0 + t)[:, None] * kt * y

    def t_solve(fr, gh, r):
        t, _ = fr
        return r / (1.0 + gh[:, None] * (1.0 + t)[:, None] * kt)

    ty, terr, tk1 = tode.ark43_step(t_rhs, t_apply, t_solve, _t(t0), _t(y0), _t(h), None)
    _close(ty, jy)
    _close(terr, jerr, rtol=1e-10)   # an O(h^4) difference of O(1) stage sums
    _close(tk1, jk1)


def test_rk4_fixed():
    ts = np.linspace(0.0, 2.0, 33)

    def rhs(t, y, a):
        return np.array([y[1], -4.0 * y[0] + np.sin(t)])

    def jrhs(t, y, a):
        return jnp.array([y[1], -4.0 * y[0] + jnp.sin(t)])

    ys = tode.rk4_fixed(rhs, np.array([1.0, 0.0]), ts, None, substeps=2)
    yj = jode.rk4_fixed(jrhs, jnp.array([1.0, 0.0]), jnp.asarray(ts), None, substeps=2)
    _close(ys, yj)


def test_import_does_not_load_jax():
    """Every module of the package imports without jax, the JAX package or a
    kernel build."""
    code = ("import importlib, pkgutil, sys, classpp_public_torch as p; "
            "[importlib.import_module(m.name) for m in "
            "pkgutil.walk_packages(p.__path__, p.__name__ + '.')]; "
            "assert 'jax' not in sys.modules, 'jax imported'; "
            "assert not any(m.startswith('classpp_public_tpu') for m in sys.modules); "
            "from classpp_public_torch.ops import cuda; assert cuda._LIB is None")
    root = pathlib.Path(__file__).resolve().parents[1]
    res = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         cwd=root)
    assert res.returncode == 0, res.stderr


def test_failed_kernel_build_raises(tmp_path, monkeypatch):
    """A compiler that fails makes the build raise: there is no fallback."""
    from classpp_public_torch.ops import cuda

    nvcc = tmp_path / "nvcc"
    nvcc.write_text("#!/bin/sh\necho 'nvcc: broken' >&2\nexit 1\n")
    nvcc.chmod(0o755)
    monkeypatch.setenv("NVCC", str(nvcc))
    monkeypatch.setattr(cuda, "BUILD_DIR", tmp_path / "build")
    with pytest.raises(RuntimeError, match="nvcc failed"):
        cuda.build()
    assert not list((tmp_path / "build").glob("*.so"))

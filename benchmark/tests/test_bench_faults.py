"""A run with the timed path broken underneath comes out not correct.

Each test drives a whole run (the harness's look for a card skipped:
`session.run_cell` on a given device), with one fault of the kinds a cell
can have planted in the program, and sees `correct` come out false; a run
without a fault comes out true. On the CPU the runs are of the tiny cell;
the tests marked `card` run des_y1.chain at its own size, where a fault may
touch one bin or one band of l alone. A single-card cell has no exchange
between chips to leave out.
"""

import inspect

import pytest
import torch

from harness import session

from conftest import TINY, TINY_NC

SEED = 2**35 + 9
DES = "des_y1.chain"


def _run(bench):
    return session.run_cell(TINY, SEED, 0.1, False, device="cpu", bench=bench)


def _run_des():
    return session.run_cell(DES, 2**33 + 41, 3.0, False, device="cuda")


def _stale_bias(monkeypatch, b: int):
    """The number counts take bin b's galaxy bias from the previous point."""
    from classpp_public_torch.models import numbercounts

    orig = numbercounts._assemble_rows
    sig = inspect.signature(orig)
    last = {}

    def stale(*args, **kwargs):
        bound = sig.bind(*args, **kwargs)
        bias = [float(v) for v in bound.arguments["selection_bias"]]
        prev, last["bias"] = last.get("bias"), list(bias)
        if prev is not None:
            bias[b] = prev[b]
        bound.arguments["selection_bias"] = bias
        return orig(*bound.args, **bound.kwargs)

    monkeypatch.setattr(numbercounts, "_assemble_rows", stale)


def _dd_band_altered(monkeypatch, lo: int, hi: int):
    """The number counts return dd 1e-5 off over l = lo..hi-1 alone."""
    from classpp_public_torch.models import numbercounts

    orig = numbercounts.compute_number_counts

    def altered(*args, **kwargs):
        out = orig(*args, **kwargs)
        cols = (out.ell >= lo) & (out.ell < hi)
        out.dd[:, cols] *= 1.0 + 1e-5
        return out

    monkeypatch.setattr(numbercounts, "compute_number_counts", altered)


def _run_nc(bench):
    return session.run_cell(TINY_NC, SEED, 0.1, False, device="cpu", bench=bench)


@pytest.fixture(autouse=True)
def _threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def test_sound_run_is_correct(tiny_bench):
    r = _run(tiny_bench)
    assert r["correct"] and r["attempted"] >= 1 and r["failed"] == 0
    assert set(r["checks"]) == {"cl_band", "pk_gap"}
    assert list(r)[-1] == "checks"


def test_state_left_unchanged(tiny_bench, monkeypatch):
    """`set` keeps the previous point's parameters: every point returns the
    warm-up point's spectra."""
    from classpp_public_torch.classy import Class

    orig = Class.set

    def stale(self, *args, **kwargs):
        if self._pars:
            return True
        return orig(self, *args, **kwargs)

    monkeypatch.setattr(Class, "set", stale)
    assert not _run(tiny_bench)["correct"]


def test_half_the_lanes_left_out(tiny_bench, monkeypatch):
    """The integrator solves every other k lane; each lane left out takes the
    mean of its two neighbours' sources."""
    from classpp_public_torch.models.perturbations import solve

    orig = solve.integrate_sources

    def half(lanes, taus, tables, tolerances, ic=None):
        nl = lanes.k.shape[0]
        even = torch.arange(0, nl, 2)
        S, n = orig(lanes.take(even), taus, tables, tuple(t[even] for t in tolerances),
                    None if ic is None else ic[even])
        full = torch.empty((nl,) + tuple(S.shape[1:]), dtype=S.dtype)
        steps = torch.empty(nl, dtype=n.dtype)
        full[even], steps[even] = S, n
        odd = torch.arange(1, nl, 2)
        hi = torch.clamp((odd + 1) // 2, max=len(even) - 1)
        full[odd] = 0.5 * (S[(odd - 1) // 2] + S[hi])
        steps[odd] = n[(odd - 1) // 2]
        return full, steps

    monkeypatch.setattr(solve, "integrate_sources", half)
    assert not _run(tiny_bench)["correct"]


def test_answer_altered_where_produced(tiny_bench, monkeypatch):
    """The lensing stage returns its lensed spectra 1e-5 off."""
    from classpp_public_torch.models import lensing

    orig = lensing.compute_lensing

    def altered(*args, **kwargs):
        out = orig(*args, **kwargs)
        out.cl.mul_(1.0 + 1e-5)
        return out

    monkeypatch.setattr(lensing, "compute_lensing", altered)
    r = _run(tiny_bench)
    assert not r["correct"] and r["checks"]["cl_band"]["value"] > 1e-6


def test_one_band_of_l_altered(tiny_bench, monkeypatch):
    """The lensing stage returns TT alone 1e-5 off over l = 30..39, one band
    of the read's bands; every other multipole and spectrum is sound."""
    from classpp_public_torch.models import lensing

    orig = lensing.compute_lensing

    def altered(*args, **kwargs):
        out = orig(*args, **kwargs)
        rows = (out.ell >= 30) & (out.ell < 40)
        out.cl[rows, 0] *= 1.0 + 1e-5
        return out

    monkeypatch.setattr(lensing, "compute_lensing", altered)
    r = _run(tiny_bench)
    assert not r["correct"] and r["checks"]["cl_band"]["value"] > 1e-6


def test_counts_sound_run_is_correct(tiny_bench):
    r = _run_nc(tiny_bench)
    assert r["correct"] and set(r["checks"]) == {"nc_band"}


def test_counts_one_bins_bias_stale(tiny_bench, monkeypatch):
    """Bin 1's galaxy bias is the previous point's; bin 0 is sound."""
    _stale_bias(monkeypatch, 1)
    r = _run_nc(tiny_bench)
    assert not r["correct"] and r["checks"]["nc_band"]["value"] > 1e-4


def test_counts_one_band_of_l_altered(tiny_bench, monkeypatch):
    _dd_band_altered(monkeypatch, 20, 30)
    r = _run_nc(tiny_bench)
    assert not r["correct"] and r["checks"]["nc_band"]["value"] > 5e-6


@pytest.mark.card
def test_one_bins_bias_stale_at_des_y1_size(card, monkeypatch):
    """Bin 2's galaxy bias is the previous point's: the pairs of that bin
    move, the other pairs are sound."""
    _stale_bias(monkeypatch, 2)
    r = _run_des()
    assert not r["correct"] and r["checks"]["nc_band"]["value"] > 1e-4, r["checks"]


@pytest.mark.card
def test_one_band_of_l_altered_at_des_y1_size(card, monkeypatch):
    """The number counts return dd 1e-5 off over l = 400..499 alone."""
    _dd_band_altered(monkeypatch, 400, 500)
    r = _run_des()
    assert not r["correct"] and r["checks"]["nc_band"]["value"] > 5e-6, r["checks"]

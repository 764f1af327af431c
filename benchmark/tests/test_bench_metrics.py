"""The metric arithmetic on synthetic spans, counts and profiler events."""

import numpy as np
import pytest

from harness import compare, manifest, roofline, session, trace


def _read(name, run):
    return manifest.reader(name)(run)


def test_point_s_is_the_window_over_its_points():
    """The window closes at the end of the first point that ends after
    --seconds: point_s is its whole length over the points it completed."""
    run = session.Run(setup_s=12.5, window_s=31.2, points=13)
    assert _read("point_s", run) == pytest.approx(31.2 / 13)
    assert _read("setup_s", run) == 12.5
    assert _read("point_s", session.Run(setup_s=1.0)) is None


def test_stage_spans_mean_per_point():
    spans = [{"set": 0.01, "background": 0.2, "thermodynamics": 0.8, "perturbations": 1.3,
              "primordial": 0.001, "nonlinear": 0.05, "transfer": 0.1, "spectra": 0.02,
              "lensing": 0.04, "reads": 0.2},
             {"set": 0.01, "background": 0.4, "thermodynamics": 0.6, "perturbations": 1.5,
              "primordial": 0.001, "nonlinear": 0.05, "transfer": 0.1, "spectra": 0.02,
              "lensing": 0.04, "reads": 0.1}]
    run = session.Run(setup_s=1.0, stage_s=spans, steps_max=[31000, 32000])
    assert _read("background_s", run) == pytest.approx(0.3)
    assert _read("thermodynamics_s", run) == pytest.approx(0.7)
    assert _read("perturbations_s", run) == pytest.approx(1.4)
    assert _read("output_stages_s", run) == pytest.approx((0.411 + 0.311) / 2)
    assert _read("perturb_steps_max", run) == 31500
    empty = session.Run(setup_s=1.0)
    for name in ("background_s", "output_stages_s", "perturb_steps_max", "device_idle_pct",
                 "perturb_ark_roofline", "recfast_history_roofline"):
        assert _read(name, empty) is None


def test_trace_reduce_union_kernels_and_idle_labels():
    dev = [("void (anonymous namespace)::perturb_ark_kernel<false, false, false>("
            "pk::LayoutOf<false>, int)", 10, 40),
           ("void at::native::elementwise_kernel<128, 2>(int)", 35, 50),
           ("Memcpy HtoD (Pageable -> Device)", 70, 80),
           ("outside", 120, 130)]
    spans = [("perturbations", 30, 60), ("background", 0, 20), ("reads", 65, 100)]
    r = trace.reduce(dev, spans, (0, 100))
    assert r["busy_s"] == pytest.approx(50e-9) and r["window_s"] == pytest.approx(100e-9)
    assert r["kernel_s"]["perturb_ark_kernel"] == pytest.approx(30e-9)
    assert r["kernel_s"]["at::native::elementwise_kernel"] == pytest.approx(15e-9)
    assert r["device_ops"][0][0] == "perturb_ark_kernel"
    idle = dict(r["idle_gaps"])
    assert idle == pytest.approx({"background": 10e-9, "perturbations": 10e-9,
                                  trace.OUTSIDE: 5e-9, "reads": 25e-9})
    assert sum(idle.values()) == pytest.approx(r["window_s"] - r["busy_s"])
    assert [k for k, _ in r["idle_gaps"]][0] == "reads"


def test_trace_reduce_clips_to_the_window():
    r = trace.reduce([("k", -50, 50), ("k", 90, 200)], [], (0, 100))
    assert r["busy_s"] == pytest.approx(60e-9)
    assert dict(r["idle_gaps"]) == pytest.approx({trace.OUTSIDE: 40e-9})


def test_idle_and_roofline_readers():
    tr = trace.reduce([("void (anonymous namespace)::perturb_ark_kernel<true>(int)", 0,
                        500_000_000),
                       ("void (anonymous namespace)::recfast_history_kernel(int)", 600_000_000,
                        700_000_000)], [], (0, 1_000_000_000))
    run = session.Run(setup_s=1.0, trace=tr,
                      work={"perturb_ark_kernel": [(1e-4, "operations"), (2e-4, "operations")],
                            "recfast_history_kernel": [(1e-6, "operations")]})
    assert _read("device_idle_pct", run) == pytest.approx(40.0)
    assert _read("perturb_ark_roofline", run) == pytest.approx(100 * 3e-4 / 0.5)
    assert _read("recfast_history_roofline", run) == pytest.approx(100 * 1e-6 / 0.1)


def test_roofline_arithmetic():
    assert roofline.bound(3.35e12, 1.0) == (1.0, "bytes")
    assert roofline.bound(1.0, 33.5e12) == (1.0, "operations")
    # row2_exact's state: 334 rows, one species of 15 momenta x 18 multipoles
    # collapsing to 3 fluid moments; 30 rows in the implicit range
    n_late = 334 - (270 - 3)
    assert roofline.perturb_ark_flops(10.0, 334, 1, 270, 30) == pytest.approx(
        10 * (6 * (12 * n_late + 400) + 30 * (n_late + 30) + 24 * n_late))
    assert roofline.perturb_ark_flops(1.0, 46, 0, 0, 20) == 6 * (12 * 46 + 400) + 30 * 66 \
        + 24 * 46
    z = [3000.0, 2500.0, 2000.0, 1500.0]
    xe = [1.16, 1.10, 1.01, 1.0]
    # y1 from the row before: 1.0 (start), 0.16/0.08 = 2.0, 1.25, then 0.125
    assert roofline.recfast_integrated_intervals(z, xe, 4, 2800.0, 0.0, 0.5, 0.08) == 1
    assert roofline.recfast_history_flops(100, 10, False) == 350.0 * 260
    assert roofline.recfast_history_flops(100, 10, True) == 600.0 * 260


def test_sample_is_seeded_and_uniform():
    def draw(seed, n):
        s = session.Sample(seed)
        for i in range(n):
            s.offer(i)
        return s.item

    assert draw(5, 20) == draw(5, 20)
    counts = np.bincount([draw(seed, 4) for seed in range(4000)], minlength=4)
    assert counts.min() > 850 and counts.max() < 1150


def test_compare_bands():
    """A band spec [start, stop, width] gives bands of width l; a remainder
    shorter than half a width joins the band before it."""
    assert compare.bands([200, 2501, 200])[-1] == (2400, 2501)
    assert compare.bands([100, 2501, 200])[-1] == (2300, 2501)
    assert compare.bands([30, 300, 90]) == [(30, 120), (120, 210), (210, 300)]
    assert compare.bands([2, 1001, 100])[-1] == (902, 1001)


def test_compare_numbers():
    """cl_band: the largest |median| of a spectrum's relative gap over its
    bands, every spectrum's; swings at single multipoles leave it; pk_gap:
    the widest gap over P(k) and sigma8."""
    ell = np.arange(60.0)
    tt, ee = 1.0 + ell, 0.5 + ell
    te = np.where(ell % 2 == 0, 0.3, -0.2)
    ref = {"lensed_cl": {"tt": tt, "ee": ee, "te": te, "pp": tt * 2},
           "pk": np.array([1.0, 2.0, 3.0]), "sigma8": np.array([0.8])}
    noise = np.where(ell % 2 == 0, 1e-6, -1e-6)              # no coherent shift
    shift = np.where((ell >= 40) & (ell < 50), 3e-7, 0.0)     # one band of TE moves
    prog = {"lensed_cl": {"tt": tt * (1 + np.where(ell == 23, 1e-2, 0.0)),
                          "ee": ee * (1 + noise), "pp": tt * 2 * (1 + 1e-7),
                          "te": te + shift * np.sqrt(tt * ee)},
            "pk": np.array([1.0, 2.0 * (1 + 3e-5), 3.0]), "sigma8": np.array([0.8 * (1 - 1e-4)])}
    spec = {s: [10, 60, 10] for s in ("tt", "te", "ee", "pp")}
    reads = [{"call": "lensed_cl", "bands": spec}, {"call": "pk"}, {"call": "sigma8"}]
    g = compare.located(prog, ref, reads)
    assert g["cl_band"][0] == pytest.approx(3e-7, rel=1e-6)
    assert g["cl_band"][1] == "te l=[40,50)"
    assert g["pk_gap"] == (pytest.approx(1e-4), "sigma8 i=0")
    widest = {(c, s): (w, at) for _, c, s, w, at, _ in compare.parts(prog, ref)}
    assert widest[("lensed_cl", "tt")] == (pytest.approx(1e-2), "l=23")
    prog["lensed_cl"]["pp"] = tt * 2 * (1 + np.where(ell < 30, 1e-5, 0.0))
    assert compare.numbers(prog, ref, reads)["cl_band"] == pytest.approx(1e-5)
    prog["pk"] = np.array([np.nan, 2.0, 3.0])
    assert compare.numbers(prog, ref, reads)["pk_gap"] == float("inf")
    prog["lensed_cl"]["ee"] = ee[:-1]
    assert compare.numbers(prog, ref, reads)["cl_band"] == float("inf")
    ok, checks = compare.judge({"cl_band": 1e-6}, {"cl_band": 1e-7})
    assert not ok and checks == {"cl_band": {"value": 1e-6, "limit": 1e-7}}


def test_compare_number_counts():
    """nc_band: each pair's |band median| of its relative gap, against the
    larger of its own spectrum and the median pair's; one pair or one band
    that moves is seen, a pair all but zero is measured against the median
    pair."""
    ell = np.arange(2.0, 62.0)
    big = np.outer([1.0, 2.0, 3.0], 1.0 / ell)
    tiny = np.outer([1e-6], 1.0 / ell)
    dd = np.vstack([big, tiny])
    ref = {"density_cl": {"ell": ell, "dd": dd, "ll": dd * 3, "dl": dd[:2]}}
    spec = {"dd": [2, 62, 20], "ll": [2, 62, 20], "dl": [2, 62, 20]}
    reads = [{"call": "density_cl", "bands": spec}]

    def prog(**scale):
        out = {"ell": ell}
        for s in ("dd", "ll", "dl"):
            out[s] = ref["density_cl"][s] * scale.get(s, 1.0)
        return {"density_cl": out}

    assert compare.numbers(prog(), ref, reads)["nc_band"] == 0.0
    one_pair = np.ones_like(dd)
    one_pair[1] += 4e-6
    assert compare.located(prog(dd=one_pair), ref, reads)["nc_band"] == (
        pytest.approx(4e-6), "dd pair 1 l=[2,22)")
    one_band = np.ones_like(dd[:2])
    one_band[:, (ell >= 42)] += 2e-6
    assert compare.located(prog(dl=one_band), ref, reads)["nc_band"] == (
        pytest.approx(2e-6), "dl pair 1 l=[42,62)")
    small = np.ones_like(dd)
    small[3] += 1e-2                          # the all-but-zero pair: 1e-2 of 1e-6
    v = compare.numbers(prog(ll=small), ref, reads)["nc_band"]
    assert v == pytest.approx(1e-2 * 3e-6 / 4.5, rel=1e-6)   # against the median pair
    bad = prog()
    bad["density_cl"]["ell"] = ell + 1
    assert compare.numbers(bad, ref, reads)["nc_band"] == float("inf")

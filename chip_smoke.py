#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port once on one NVIDIA card.

Runs the `planck_row2` configuration (flat LambdaCDM with massless neutrinos:
lensed TT/TE/EE/phiphi to l = 2500 plus P(k) to k = 10/Mpc) through
`classpp_public_torch.Class(device="cuda")`, stage by stage, and checks:

1. the hand-written CUDA kernels (csrc/*.cu) build with nvcc for sm_90a;
2. the main path launched each kernel (launch counters, reset just before);
3. the result against the reference C++ probe tests/golden/bench_probe.json
   (rel TT/EE/TE <= 3e-3 at l = 220, 1000, 2000, 2500; rel P(0.1) <= 1e-2);
4. each kernel against its plain PyTorch version on the very tensors the
   pipeline fed it, with both timed on the card (CUDA events, median of 3).

Usage: python3 chip_smoke.py   (from the repository root; needs one card)

Prints per-phase seconds, a JSON line of kernel results, the card's name and
power limit, and as its last line {"ok": true, "device": {...}}. Any failure
raises and exits non-zero.
"""

import json
import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
PROBE = os.path.join(ROOT, "tests", "golden", "bench_probe.json")

PLANCK_ROW2 = {
    "h": 0.6736, "omega_b": 0.02237, "omega_cdm": 0.1200,
    "A_s": 2.0989e-9, "n_s": 0.9649, "tau_reio": 0.0544,
    "output": "tCl,pCl,lCl,mPk", "lensing": "yes",
    "l_max_scalars": 2500, "P_k_max_1/Mpc": 10.0, "z_pk": "0.",
}
CL_TOL, PK_TOL = 3e-3, 1e-2
# kernel vs plain version: max |kernel - plain| over each output column,
# relative to that column's max |plain|. Both are float64 and differ only in
# summation order and in the last bit of sin/cos/exp/lgamma. The LOS scan
# runs the upward Bessel recurrence through the band x < l < x + 6 x^(1/3) + 2
# that its mask keeps, where the recurrence is unstable and amplifies those
# last-bit differences (by up to ~1e9 at l ~ 10): measured ~1.5e-7 of scale.
# The lensing passes have no such band: ~1e-12 (BB, a difference of terms).
KERNEL_TOL = {"transfer_los": 1e-6, "lensing_wigner": 1e-9}


def phase(name, t0):
    print(f"[phase] {name}: {time.time() - t0:.3f} s", flush=True)


def probe_check(cl, pk):
    """The bench.py rule (bench.py:91-118) against the planck_row2 probe."""
    with open(PROBE) as f:
        ref = json.load(f)["planck_row2"]
    worst = {}
    for spec in ("tt", "ee", "te"):
        errs = []
        for l_str, want in ref[spec].items():
            got = float(cl[spec][int(l_str)])
            den = abs(want) if spec != "te" else max(abs(want), 1e-3 * abs(ref["tt"][l_str]))
            errs.append(abs(got - want) / den)
        worst[f"rel_{spec}"] = max(errs)
    worst["rel_pk"] = abs(pk - ref["pk_0.1"]) / abs(ref["pk_0.1"])
    ok = max(worst[f"rel_{s}"] for s in ("tt", "ee", "te")) <= CL_TOL \
        and worst["rel_pk"] <= PK_TOL
    return ok, worst


def timed(fn, reps=3):
    """Median wall time of fn() on the card in ms (CUDA events) and its result."""
    import torch

    fn()
    torch.cuda.synchronize()
    times, out = [], None
    for _ in range(reps):
        a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        a.record()
        out = fn()
        b.record()
        torch.cuda.synchronize()
        times.append(a.elapsed_time(b))
    return sorted(times)[len(times) // 2], out


def spy(module, name, captured):
    """Wrap module.name so that each call records its arguments in
    captured[name]; returns the original function."""
    orig = getattr(module, name)

    def wrapper(*args, **kwargs):
        captured[name] = (args, kwargs)
        return orig(*args, **kwargs)

    setattr(module, name, wrapper)
    return orig


def compare(name, kern, plain):
    """(max_abs_err, scaled error) between two (..., ncol) outputs."""
    import torch

    if kern.shape != plain.shape:
        raise RuntimeError(f"{name}: kernel shape {tuple(kern.shape)} != plain "
                           f"{tuple(plain.shape)}")
    if not bool(torch.isfinite(kern).all()):
        raise RuntimeError(f"{name}: kernel output is not finite")
    diff = (kern - plain).abs()
    return float(diff.max()), float(diff.max() / plain.abs().max().clamp_min(1e-300))


def main():
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is False)",
              file=sys.stderr)
        return 1
    sys.path.insert(0, ROOT)
    import numpy as np

    import classpp_public_torch as cpt
    from classpp_public_torch.models import lensing, transfer
    from classpp_public_torch.ops import cuda

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         check=True).stdout.strip().splitlines()[0]
    print(f"[card] {smi}", flush=True)
    print(f"[env] python {sys.version.split()[0]} torch {torch.__version__} "
          f"cuda {torch.version.cuda}", flush=True)

    t0 = time.time()
    lib_path = cuda.build(verbose=True)
    cuda.library()
    phase(f"build kernels ({os.path.relpath(lib_path, ROOT)})", t0)

    # --- main path: planck_row2 through Class(device="cuda"), stage by stage
    dev = torch.device("cuda")
    c = cpt.Class(device=dev)
    c.set(dict(PLANCK_ROW2))
    cosmo = c.cosmo
    captured = {}
    kernel_fns = {"transfer_los": spy(transfer, "transfer_los", captured),
                  "lensing_wigner": spy(lensing, "lensing_wigner", captured)}
    transfer.launches = lensing.launches = 0
    t_all = time.time()
    stage_s = {}
    for st in cosmo.stages("lensing"):
        t0 = time.time()
        getattr(cosmo, st)
        torch.cuda.synchronize()
        stage_s[st] = time.time() - t0
        phase(f"stage {st}", t0)
    t0 = time.time()
    cl = c.lensed_cl(2500)
    raw = c.raw_cl(2500)
    pk = c.pk_lin(0.1, 0.0)
    torch.cuda.synchronize()
    phase("accessors", t0)
    phase("planck_row2 total", t_all)
    counts = {"transfer_los": transfer.launches, "lensing_wigner": lensing.launches}
    transfer.transfer_los = kernel_fns["transfer_los"]
    lensing.lensing_wigner = kernel_fns["lensing_wigner"]
    print(f"[launches] {counts}", flush=True)
    missing = [k for k, n in counts.items() if n <= 0]
    if missing:
        raise RuntimeError(f"kernels not launched on the main path: {missing}")
    pt = cosmo.perturbations
    print(f"[shapes] k {tuple(pt.k.shape)} tau {tuple(pt.tau.shape)} sources "
          f"{tuple(pt.sources.shape)} transfer {tuple(cosmo.transfer.delta.shape)} "
          f"steps max {int(pt.stats_steps.max())} mean {float(pt.stats_steps.float().mean()):.1f}",
          flush=True)

    # --- the result: finite, shaped, and in contract with the reference probe
    for name, tab in (("lensed", cl), ("raw", raw)):
        for spec in ("tt", "ee", "te", "bb", "pp"):
            arr = np.asarray(tab[spec])
            if arr.shape != (2501,) or not np.isfinite(arr).all():
                raise RuntimeError(f"{name} C_l[{spec}]: shape {arr.shape} or non-finite")
    if not (np.isfinite(pk) and pk > 0):
        raise RuntimeError(f"P(k=0.1) = {pk}")
    ok, rel = probe_check(cl, pk)
    print(f"[probe] planck_row2 {json.dumps(rel)} (tol C_l {CL_TOL}, P(k) {PK_TOL})",
          flush=True)
    if not ok:
        raise RuntimeError(f"planck_row2 probe out of contract: {rel}")

    # --- each kernel against its plain version on the captured inputs
    t0 = time.time()
    kernels = []
    args, kw = captured["transfer_los"]
    ms, kout = timed(lambda: transfer.transfer_los(*args, **kw))
    plain_ms, pout = timed(lambda: transfer.transfer_los_plain(*args, **kw))
    errs = [compare("transfer_los", kout[:, i], pout[:, i]) for i in range(kout.shape[1])]
    kernels.append(dict(name="transfer_los", route="cuda",
                        source="classpp_public_torch/csrc/transfer_los.cu",
                        replaces="classpp_public_tpu/models/transfer.py:360",
                        launches=counts["transfer_los"],
                        max_abs_err=max(e[0] for e in errs), ms=ms, plain_ms=plain_ms,
                        scaled_err=max(e[1] for e in errs)))
    args, kw = captured["lensing_wigner"]
    ms, kout = timed(lambda: lensing.lensing_wigner(*args, **kw))
    plain_ms, pout = timed(lambda: lensing.lensing_wigner_plain(*args, **kw))
    errs = [compare("lensing_wigner", kout[:, i], pout[:, i]) for i in range(kout.shape[1])]
    kernels.append(dict(name="lensing_wigner", route="cuda",
                        source="classpp_public_torch/csrc/lensing_wigner.cu",
                        replaces="classpp_public_tpu/models/lensing.py:94",
                        launches=counts["lensing_wigner"],
                        max_abs_err=max(e[0] for e in errs), ms=ms, plain_ms=plain_ms,
                        scaled_err=max(e[1] for e in errs)))
    phase("kernel vs plain comparison", t0)
    scaled = {k["name"]: k.pop("scaled_err") for k in kernels}
    print(f"[kernels] scaled error (max |kernel - plain| / max |plain|): {scaled}, "
          f"tolerance {KERNEL_TOL}", flush=True)
    print("[stages] " + " ".join(f"{k}={v:.3f}s" for k, v in stage_s.items()), flush=True)
    bad = [n for n, e in scaled.items() if not e <= KERNEL_TOL[n]]
    if bad:
        raise RuntimeError(f"kernels disagree with their plain versions beyond "
                           f"{KERNEL_TOL} (scaled): {bad}")
    print(json.dumps({"kernels": kernels}), flush=True)
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

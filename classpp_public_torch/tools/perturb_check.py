#!/usr/bin/env python3
"""Register use and section profile of the perturbation integrator kernel.

Builds classpp_public_torch/csrc/*.cu with `-Xptxas -v` (registers, spills),
runs the perturbation stage of a configuration at full size on one NVIDIA
card and times its call of `integrate_sources` (the perturb_ark kernel; CUDA
events, one warm-up, median of 3). The comparison of the kernel with its
plain version is chip_smoke.py's.

Usage (from the repository root, needs one card and nvcc):
    python3 -m classpp_public_torch.tools.perturb_check [planck_row2|row2_exact] [--profile]

--profile builds the kernel with -DPK_PROFILE and prints, for the highest-k
lane, the cycles per step spent in each section of the integrator.
"""

import argparse
import ctypes
import sys
import time

from .configs import CONFIGS

SECTIONS = ("table reads", "stage combination", "stiff solve", "stiff apply",
            "right-hand side", "explicit part", "solution/error sums",
            "control/remaps/sources")


def main():
    import torch

    ap = argparse.ArgumentParser()
    ap.add_argument("config", nargs="?", default="planck_row2", choices=sorted(CONFIGS))
    ap.add_argument("--profile", action="store_true")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 1
    import classpp_public_torch as cpt
    from classpp_public_torch.models.perturbations import solve
    from classpp_public_torch.ops import cuda

    print(f"[card] {torch.cuda.get_device_name(0)}", flush=True)
    if args.profile:
        cuda.NVCC_FLAGS.append("-DPK_PROFILE")
    t0 = time.time()
    cuda.build(verbose=True)
    cuda.library()
    print(f"[build] {time.time() - t0:.1f} s", flush=True)

    c = cpt.Class(device="cuda")
    c.set(dict(CONFIGS[args.config]))
    calls = []
    orig = solve.integrate_sources
    solve.integrate_sources = lambda *a: (calls.append(a), orig(*a))[1]
    t0 = time.time()
    pt = c.cosmo.perturbations
    torch.cuda.synchronize()
    solve.integrate_sources = orig
    print(f"[stage] perturbations {time.time() - t0:.3f} s, sources {tuple(pt.sources.shape)}",
          flush=True)

    lanes, taus, tables, tol = calls[-1]
    orig(lanes, taus, tables, tol)
    times = []
    for _ in range(3):
        a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        a.record()
        S, nsteps = orig(lanes, taus, tables, tol)
        b.record()
        torch.cuda.synchronize()
        times.append(a.elapsed_time(b))
    print(f"[kernel] lanes {lanes.k.shape[0]} state {tables.idx.size}: {sorted(times)[1]:.2f} ms, "
          f"steps max {int(nsteps.max())} sum {int(nsteps.sum())}", flush=True)
    if not bool(torch.isfinite(S).all()):
        raise RuntimeError("kernel output is not finite")
    if args.profile:
        out = (ctypes.c_longlong * len(SECTIONS))()
        fn = cuda.library().perturb_ark_profile
        fn.argtypes = [ctypes.c_void_p]
        cuda.check(fn(out), "perturb_ark_profile")
        n_last = int(nsteps[-1])
        print(f"[profile] lane k = {float(lanes.k[-1]):.4g}/Mpc, {n_last} steps, "
              f"{sum(out) / n_last:.0f} cycles per step", flush=True)
        for name, v in zip(SECTIONS, out):
            print(f"    {name:24s} {v / n_last:9.0f} cycles/step {100.0 * v / sum(out):5.1f}%")
    return 0


if __name__ == "__main__":
    sys.exit(main())

"""Readings of the comparison's numbers outside a run, on the card.

    python benchmark/control.py --workload planck18.chain --seeds 11 12 13 [--golden]

For each seed, one point of the cell's chain (the index drawn from the seed
among its first eight points) is computed by the program, by the plain
reference and by the reference's control (its perturbation state stored in
float32, rtol floored at 1e-4; --no-control leaves it out). One JSON line per
seed gives the numbers of the program against the reference (the lower
reading of each limit) and of the control against the reference (its upper
reading), with each read's widest gap and where it lies; --save keeps every
side's reads. With --golden the reference is also computed at planck18's
centre and held to the `row2_exact` row of the C++ build's bench probe
(benchmark/tests/bench_probe_row2_exact.json): lensed TT, EE, TE within 3e-3
at l = 220, 1000, 2000, 2500 (TE against max(|TE|, 1e-3 TT)), P(k = 0.1/Mpc,
z = 0) within 1e-2.
"""

import argparse
import itertools
import json
import sys
import time
from pathlib import Path

BENCH_DIR = Path(__file__).resolve().parent
sys.path[:0] = [str(BENCH_DIR), str(BENCH_DIR.parent)]

from harness import compare, guard, manifest, reference, traffic  # noqa: E402

PROBE = BENCH_DIR / "tests" / "bench_probe_row2_exact.json"
PROBE_CL_TOL, PROBE_PK_TOL = 3e-3, 1e-2


def sampled_point(cfg: dict, mix: dict, seed: int) -> tuple:
    import numpy as np

    i = int(np.random.default_rng([int(seed) % 2**64, 2]).integers(8))
    return i, next(itertools.islice(traffic.points(cfg, mix, seed), i, None))


def readings(cell_name: str, seed: int, device: str = "cuda", with_control: bool = True,
             bench: dict = None, raw: dict = None) -> dict:
    """{"program": numbers, "control": numbers} of one seed's point; `raw`,
    where given, receives each side's reads."""
    bench = manifest.load() if bench is None else bench
    cfg = manifest.config(bench, manifest.cell(bench, cell_name))
    i, params = sampled_point(cfg, manifest.traffic(manifest.cell(bench, cell_name)["traffic"]),
                              seed)
    out = {"workload": cell_name, "seed": seed, "point": i}
    t = time.perf_counter()
    ref = reference.reads(params, cfg["reads"], device)
    out["reference_s"] = time.perf_counter() - t
    from classpp_public_torch import Class

    cls = Class(device=device)
    cls.set(params)
    cls.compute()
    sides = {"reference": ref, "program": compare.perform(cls, cfg["reads"])}
    del cls
    if with_control:
        t = time.perf_counter()
        with reference.float32_state():
            sides["control"] = reference.reads(params, cfg["reads"], device)
        out["control_s"] = time.perf_counter() - t
    for side in ("program", "control"):
        if side in sides:
            out[side] = compare.numbers(sides[side], ref, cfg["reads"])
            out[side + "_parts"] = [p[1:] for p in compare.parts(sides[side], ref)]
    if raw is not None:
        raw.update(sides)
    out["limits"] = cfg["limits"]
    return out


def golden(device: str = "cuda") -> dict:
    """The reference at planck18's centre against the C++ build's probe."""
    bench = manifest.load()
    cfg = manifest.config(bench, manifest.cell(bench, "planck18.chain"))
    with open(PROBE) as f:
        probe = json.load(f)
    from classref import Class

    cls = Class(device=device)
    cls.set(cfg["params"])
    cls.compute()
    cl = cls.lensed_cl(2500)
    worst = {}
    for spec in ("tt", "ee", "te"):
        errs = []
        for l_str, want in probe[spec].items():
            den = abs(want) if spec != "te" else max(abs(want), 1e-3 * abs(probe["tt"][l_str]))
            errs.append(abs(float(cl[spec][int(l_str)]) - want) / den)
        worst[f"rel_{spec}"] = max(errs)
    worst["rel_pk"] = abs(cls.pk_lin(0.1, 0.0) - probe["pk_0.1"]) / abs(probe["pk_0.1"])
    ok = all(v <= (PROBE_PK_TOL if k == "rel_pk" else PROBE_CL_TOL) for k, v in worst.items())
    return {"golden": "row2_exact", "ok": ok, **worst}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--golden", action="store_true")
    ap.add_argument("--no-control", action="store_true")
    ap.add_argument("--save", help="a directory for each seed's reads (<workload>_<seed>.npz)")
    args = ap.parse_args()
    if args.golden:
        print(json.dumps(golden()), flush=True)
    for seed in args.seeds:
        raw = {}
        print(json.dumps(readings(args.workload, seed, with_control=not args.no_control,
                                  raw=raw)), flush=True)
        if args.save:
            import numpy as np

            Path(args.save).mkdir(parents=True, exist_ok=True)
            flat = {f"{side}/{call}/{part}": v for side, reads in raw.items()
                    for call, r in reads.items()
                    for part, v in (r.items() if isinstance(r, dict) else [("", r)])}
            np.savez(Path(args.save) / f"{args.workload}_{seed}.npz", **flat)
    found = guard.loaded()
    if found:
        print(f"JAX was loaded: {found}", file=sys.stderr)
        return 3
    return 0


if __name__ == "__main__":
    sys.exit(main())

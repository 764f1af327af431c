"""Run one cell of BENCHMARK.json once on the card and print its result.

    python benchmark/run.py --workload planck18.chain --seed 7 --seconds 30 --trace 0

Run from the root of a checkout. The last line of standard output is the
result, one JSON object: `correct`, `attempted`, `failed`, `metrics` (the
cell's end-to-end metrics, or with `--trace 1` its per-layer metrics),
`device`, with `--trace 1` `breakdown`, and last `checks`, each number the
comparison with the plain reference held beside its limit (also the last
lines of standard error). Without a card, with fewer cards than the cell
asks for, or with JAX loaded in this process, it prints no result and exits
with a code other than 0.
"""

import time

T_START = time.perf_counter()

import os  # noqa: E402

for _var in ("OMP_NUM_THREADS", "OPENBLAS_NUM_THREADS", "MKL_NUM_THREADS"):
    os.environ[_var] = "1"      # one host thread a process: the host shares its cores

import argparse  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

BENCH_DIR = Path(__file__).resolve().parent
sys.path[:0] = [str(BENCH_DIR), str(BENCH_DIR.parent)]

from harness import guard, manifest, session  # noqa: E402


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    bench = manifest.load()
    chips = manifest.cell(bench, args.workload)["chips"]
    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        n = torch.cuda.device_count() if torch.cuda.is_available() else 0
        print(f"{args.workload} needs {chips} card(s); this machine has {n}", file=sys.stderr)
        return 2
    result = session.run_cell(args.workload, args.seed, args.seconds, bool(args.trace),
                              t_start=T_START, bench=bench)
    found = guard.loaded()
    if found:
        print(f"JAX was loaded in the measured process: {found}", file=sys.stderr)
        return 3
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

"""The benchmark's own tests: `python -m pytest benchmark/tests` from the
root of the repository. Tests marked `card` need an NVIDIA card and skip
without one (`python -m pytest benchmark/tests -m card` on the card)."""

import json
import sys
from pathlib import Path

import pytest

BENCH_DIR = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(BENCH_DIR), str(BENCH_DIR.parent)]

TINY = "tiny.chain"
TINY_NC = "tiny_nc.chain"


def pytest_configure(config):
    config.addinivalue_line("markers", "card: needs an NVIDIA card; skips without one")


@pytest.fixture
def card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("no CUDA card in this machine")
    return torch.device("cuda")


@pytest.fixture(scope="session")
def tiny_bench():
    """BENCHMARK.json with two tiny cells that the CPU runs in seconds:
    tiny.chain (benchmark/tests/tiny.json: lensed C_l to l 60, P(k) to
    0.2/Mpc) and tiny_nc.chain (benchmark/tests/tiny_nc.json: two
    number-count bins to l 60), both at coarse precision."""
    from harness import manifest

    bench = manifest.load()
    for name, cell in (("tiny", TINY), ("tiny_nc", TINY_NC)):
        bench["configs"].append({"name": name, "source": "benchmark/tests",
                                 "file": f"benchmark/tests/{name}.json", "reduced": [],
                                 "why": "tests"})
        bench["workloads"].append({"name": cell, "config": name, "traffic": "chain",
                                   "chips": 1, "why": "tests"})
        for m in bench["per_layer"]:
            m.setdefault("workloads", []).append(cell)
    return json.loads(json.dumps(bench))

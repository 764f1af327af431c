"""The comparison's control comes out not correct, and the reference itself
holds the C++ build's probe.

The control is the reference put in the program's place with its
perturbation state stored in float32 and rtol floored at 1e-4 (the JAX
package's float32 working-state rule). On the CPU it runs at the tiny cell's
size; on the card (`-m card`) at each cell's own size, where the reference
takes minutes a point.
"""

import pytest
import torch

import control
from harness import compare, manifest

from conftest import TINY

CELLS = [w["name"] for w in manifest.load()["workloads"]]


def _fails(readings: dict, limits: dict) -> bool:
    return not compare.judge(readings["control"], limits)[0]


def test_control_fails_on_the_tiny_cell(tiny_bench):
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    try:
        r = control.readings(TINY, 2**33 + 1, device="cpu", bench=tiny_bench)
    finally:
        torch.set_num_threads(n)
    assert compare.judge(r["program"], r["limits"])[0]
    assert _fails(r, r["limits"])


@pytest.mark.card
@pytest.mark.parametrize("cell", CELLS)
def test_control_fails_at_the_cells_size(card, cell):
    r = control.readings(cell, 2**32 + 77)
    assert compare.judge(r["program"], r["limits"])[0], r
    assert _fails(r, r["limits"]), r


@pytest.mark.card
def test_reference_holds_the_probe(card):
    """classref at planck18's centre against the row2_exact row of the C++
    build's bench probe (C_l 3e-3, P(0.1) 1e-2)."""
    r = control.golden()
    assert r["ok"], r

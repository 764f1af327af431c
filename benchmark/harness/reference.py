"""The plain reference's side of the comparison, and its control.

`reads` computes a point with classref, the frozen plain copy of the
program's pipeline under benchmark/classref, from the parameter dict alone,
and makes the cell's reads on it. `float32_state` turns the reference into
its control: the perturbation integrator's lane state stored in float32
after every step and rtol floored at 1e-4, the JAX package's float32
working-state rule, the step below float64 that would tempt a later change.
"""

from __future__ import annotations

from contextlib import contextmanager

from .compare import perform

F32_RTOL_FLOOR = 1e-4   # tol_perturb_f32_floor, classpp_public_tpu/config/precision.py:189


def reads(params: dict, read_list: list, device) -> dict:
    from classref import Class

    cls = Class(device=device)
    cls.set(params)
    cls.compute()
    return perform(cls, read_list)


@contextmanager
def float32_state():
    import torch
    from classref.models.perturbations import solve

    saved = solve.STATE_DTYPE, solve.RTOL_FLOOR
    solve.STATE_DTYPE, solve.RTOL_FLOOR = torch.float32, F32_RTOL_FLOOR
    try:
        yield
    finally:
        solve.STATE_DTYPE, solve.RTOL_FLOOR = saved

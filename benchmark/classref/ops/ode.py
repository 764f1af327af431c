"""ODE integrators (counterpart of classpp_public_tpu/ops/ode.py).

- `ark43_step`: one ARK4(3)6L[2]SA additive IMEX Runge-Kutta step (Kennedy &
  Carpenter 2003), batched over a leading lane axis: every lane carries its
  own t and h. The explicit table advances the non-stiff physics; the
  L-stable ESDIRK table absorbs the stiff part through a closed-form solve.
  The stages are a Python loop over the six tableau rows.
- `rkck_step`: one embedded Cash-Karp RK4(5) step, batched over lanes (the
  plain tensor-mode integrator).
- `rk4_fixed`: classic RK4 over a fixed grid, for host-side scans on numpy
  values (the background growth factor).
"""

from __future__ import annotations

from typing import Callable

import numpy as np
import torch

# --- ARK4(3)6L[2]SA tableau (classpp_public_tpu/ops/ode.py:107-135) --------
_ARK4_G = 0.25
_ARK4_C = (0.0, 1.0 / 2.0, 83.0 / 250.0, 31.0 / 50.0, 17.0 / 20.0, 1.0)
_ARK4_AE = (
    (),
    (1.0 / 2.0,),
    (13861.0 / 62500.0, 6889.0 / 62500.0),
    (-116923316275.0 / 2393684061468.0, -2731218467317.0 / 15368042101831.0,
     9408046702089.0 / 11113171139209.0),
    (-451086348788.0 / 2902428689909.0, -2682348792572.0 / 7519795681897.0,
     12662868775082.0 / 11960479115383.0, 3355817975965.0 / 11060851509271.0),
    (647845179188.0 / 3216320057751.0, 73281519250.0 / 8382639484533.0,
     552539513391.0 / 3454668386233.0, 3354512671639.0 / 8306763924573.0,
     4040.0 / 17871.0),
)
_ARK4_AI = (
    (),
    (1.0 / 4.0,),
    (8611.0 / 62500.0, -1743.0 / 31250.0),
    (5012029.0 / 34652500.0, -654441.0 / 2922500.0, 174375.0 / 388108.0),
    (15267082809.0 / 155376265600.0, -71443401.0 / 120774400.0,
     730878875.0 / 902184768.0, 2285395.0 / 8070912.0),
    (82889.0 / 524892.0, 0.0, 15625.0 / 83664.0, 69875.0 / 102672.0,
     -2260.0 / 8211.0),
)
_ARK4_B = (82889.0 / 524892.0, 0.0, 15625.0 / 83664.0, 69875.0 / 102672.0,
           -2260.0 / 8211.0, 1.0 / 4.0)
_ARK4_BH = (4586570599.0 / 29645900160.0, 0.0, 178811875.0 / 945068544.0,
            814220225.0 / 1159782912.0, -3700637.0 / 11593932.0,
            61727.0 / 225920.0)
ARK4_TABLEAU = (_ARK4_G, _ARK4_C, _ARK4_AE, _ARK4_AI, _ARK4_B, _ARK4_BH)


def _combine(coefs, vecs):
    """sum_j coefs[j] * vecs[j], skipping zero coefficients."""
    out = None
    for c, v in zip(coefs, vecs):
        if c == 0.0:
            continue
        out = c * v if out is None else out + c * v
    return out


def ark_step(tableau, rhs: Callable, stiff_apply: Callable, stiff_solve: Callable,
             t: torch.Tensor, y: torch.Tensor, h: torch.Tensor, args,
             prepare: Callable = None):
    """One additive (IMEX) RK step for y' = f(t, y) = f_E + J(t) y
    (classpp_public_tpu/ops/ode.py:141 `_ark_step`).

    y: (L, n) lanes of state; t, h: (L,) per-lane time and step. rhs returns
    the FULL f; stiff_apply returns J y; stiff_solve solves (I - gh J) x = r in
    closed form. Each of the three takes a per-stage frame as first argument:
    `prepare(t_i, args)` when given (so a caller evaluates its tables once per
    stage time), else the pair (t_i, args). Returns (y_new, err, f(t, y)).

    Stage 0 is explicit (Y_0 = y). The embedded error is passed through
    (I - gamma h J)^-1: the pair is not stiffly accurate, and the raw
    (b - bhat) combination would collapse the step to explicit sizes."""
    gamma, C, AE, AI, B, BH = tableau
    s = len(C)
    hc = h[:, None]
    gh = gamma * h
    prep = prepare if prepare is not None else (lambda ti, a: (ti, a))
    FE, FI = [], []
    frame = None
    for i in range(s):
        frame = prep(t + C[i] * h, args)
        if i == 0:
            Y = y
        else:
            acc = _combine(AE[i] + AI[i], FE[:i] + FI[:i])
            Y = stiff_solve(frame, gh, y + hc * acc)
        fI = stiff_apply(frame, Y)
        fE = rhs(frame, Y) - fI
        FE.append(fE)
        FI.append(fI)
    F = [FE[i] + FI[i] for i in range(s)]
    y_new = y + hc * _combine(B, F)
    err = hc * _combine(tuple(b - bh for b, bh in zip(B, BH)), F)
    if C[-1] != 1.0:
        frame = prep(t + h, args)
    err = stiff_solve(frame, gh, err)
    return y_new, err, F[0]


def ark43_step(rhs, stiff_apply, stiff_solve, t, y, h, args, prepare=None):
    """ARK4(3)6L[2]SA additive step (6 stages, order 4(3))."""
    return ark_step(ARK4_TABLEAU, rhs, stiff_apply, stiff_solve, t, y, h, args,
                    prepare=prepare)


# --- Cash-Karp tableau (classpp_public_tpu/ops/ode.py:27-38) ---------------
CK_C = (0.0, 1.0 / 5.0, 3.0 / 10.0, 3.0 / 5.0, 1.0, 7.0 / 8.0)
CK_A = (
    (),
    (1.0 / 5.0,),
    (3.0 / 40.0, 9.0 / 40.0),
    (3.0 / 10.0, -9.0 / 10.0, 6.0 / 5.0),
    (-11.0 / 54.0, 5.0 / 2.0, -70.0 / 27.0, 35.0 / 27.0),
    (1631.0 / 55296.0, 175.0 / 512.0, 575.0 / 13824.0, 44275.0 / 110592.0, 253.0 / 4096.0),
)
CK_B5 = (37.0 / 378.0, 0.0, 250.0 / 621.0, 125.0 / 594.0, 0.0, 512.0 / 1771.0)
CK_B4 = (2825.0 / 27648.0, 0.0, 18575.0 / 48384.0, 13525.0 / 55296.0, 277.0 / 14336.0,
         1.0 / 4.0)


def rkck_step(rhs: Callable, t: torch.Tensor, y: torch.Tensor, h: torch.Tensor):
    """One embedded Cash-Karp step of y' = rhs(t, y) for every lane
    (classpp_public_tpu/ops/ode.py:44 `rkck_step`). y: (L, n); t, h: (L,).
    Each stage sum runs over the earlier stages in order, skipping zero
    coefficients. Returns (y5, y5 - y4, rhs(t, y))."""
    hc = h[:, None]
    K = []
    for i in range(6):
        Y = y if i == 0 else y + hc * _combine(CK_A[i], K)
        K.append(rhs(t + CK_C[i] * h, Y))
    y5 = y + hc * _combine(CK_B5, K)
    y4 = y + hc * _combine(CK_B4, K)
    return y5, y5 - y4, K[0]


def rk4_fixed(rhs: Callable, y0: np.ndarray, ts: np.ndarray, args, substeps: int = 1):
    """Classic RK4 over the fixed grid ts with `substeps` sub-steps per
    interval; ys[i] = y(ts[i]). A host loop on numpy values
    (classpp_public_tpu/ops/ode.py:305)."""
    ys = [np.asarray(y0, dtype=np.float64)]
    y = ys[0]
    ts = [float(v) for v in ts]
    for ta, tb in zip(ts[:-1], ts[1:]):
        h = (tb - ta) / substeps
        for i in range(substeps):
            t = ta + i * h
            k1 = rhs(t, y, args)
            k2 = rhs(t + h / 2, y + h / 2 * k1, args)
            k3 = rhs(t + h / 2, y + h / 2 * k2, args)
            k4 = rhs(t + h, y + h * k3, args)
            y = y + h / 6 * (k1 + 2 * k2 + 2 * k3 + k4)
        ys.append(y)
    return np.stack(ys)

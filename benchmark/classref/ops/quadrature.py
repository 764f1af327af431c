"""Quadrature rules (counterpart of classpp_public_tpu/ops/quadrature.py).

Nodes and weights are generated on the host in numpy float64; the callers
move them to their device.
"""

from __future__ import annotations

from functools import lru_cache

import numpy as np
import torch


def gauss_legendre(n: int, a: float = -1.0, b: float = 1.0):
    """n-point Gauss-Legendre nodes/weights on [a, b] (float64 numpy).
    Cached: leggauss(n ~ 3000) is a ~1 s companion-matrix eigensolve."""
    x, w = _leggauss_cached(n)
    x = 0.5 * (b - a) * x + 0.5 * (b + a)
    w = 0.5 * (b - a) * w
    return x, w


@lru_cache(maxsize=8)
def _leggauss_cached(n: int):
    x, w = np.polynomial.legendre.leggauss(n)
    x.setflags(write=False)
    w.setflags(write=False)
    return x, w


def trapz_weights_np(x: np.ndarray) -> np.ndarray:
    w = np.zeros_like(x)
    dx = np.diff(x)
    w[:-1] += dx / 2
    w[1:] += dx / 2
    return w


def trapz_weights(x: torch.Tensor) -> torch.Tensor:
    """Trapezoidal weights for a (possibly non-uniform) grid
    (array_trapezoidal_weights, tools/arrays.c:2823)."""
    dx = torch.diff(x)
    z = torch.zeros((1,), dtype=x.dtype, device=x.device)
    return torch.cat([dx / 2, z]) + torch.cat([z, dx / 2])

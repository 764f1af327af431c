"""Cubic-spline and interpolation ops on float64 tensors.

Counterpart of classpp_public_tpu/ops/splines.py. Tables queried inside the
hot loops live on uniform grids (UniformSpline), so the bracketing index is
arithmetic; non-uniform tables use torch.searchsorted.

The tridiagonal solve is parallel cyclic reduction: ceil(log2 n) rounds of
whole-vector updates instead of the n sequential steps of the Thomas scan
(classpp_public_tpu/ops/splines.py:22). The spline systems are strictly
diagonally dominant, where cyclic reduction is stable and agrees with the
Thomas algorithm to round-off. On a card a sequential scan would cost n
rounds of kernel launches; cyclic reduction costs ~12 launches per round.
"""

from __future__ import annotations

from typing import NamedTuple

import torch


def _shift(v: torch.Tensor, s: int, fill: float) -> torch.Tensor:
    """out[i] = v[i - s] (s > 0) or v[i + |s|] (s < 0), `fill` outside."""
    out = torch.full_like(v, fill)
    n = v.shape[0]
    if abs(s) >= n:
        return out
    if s > 0:
        out[s:] = v[:n - s]
    else:
        out[:n + s] = v[-s:]
    return out


def tridiag_solve(dl: torch.Tensor, d: torch.Tensor, du: torch.Tensor,
                  b: torch.Tensor) -> torch.Tensor:
    """Solve the tridiagonal system by parallel cyclic reduction.

    dl: sub-diagonal (n,), dl[0] unused; d: diagonal (n,); du: super-diagonal
    (n,), du[-1] unused; b: rhs (n,) or (n, m). Differentiable."""
    n = d.shape[0]
    r = b if b.ndim > 1 else b[:, None]
    a = torch.cat([torch.zeros_like(dl[:1]), dl[1:]])
    c = torch.cat([du[:-1], torch.zeros_like(du[:1])])
    bb = d
    s = 1
    while s < n:
        alpha = -a / _shift(bb, s, 1.0)
        gamma = -c / _shift(bb, -s, 1.0)
        bb_new = bb + alpha * _shift(c, s, 0.0) + gamma * _shift(a, -s, 0.0)
        r = (r + alpha[:, None] * _shift(r, s, 0.0)
             + gamma[:, None] * _shift(r, -s, 0.0))
        a = alpha * _shift(a, s, 0.0)
        c = gamma * _shift(c, -s, 0.0)
        bb = bb_new
        s *= 2
    x = r / bb[:, None]
    return x if b.ndim > 1 else x[:, 0]


def spline_d2(x: torch.Tensor, y: torch.Tensor, bc: str = "natural") -> torch.Tensor:
    """Second derivatives of the cubic spline through (x, y), splined along
    axis 0 (array_spline_table_lines, tools/arrays.c:514). bc: 'natural' or
    'est_deriv' (clamped, end slopes from the quadratic through the three
    outermost points: the reference _SPLINE_EST_DERIV_)."""
    if bc not in ("natural", "est_deriv"):
        raise NotImplementedError(
            f"spline bc {bc!r} is not ported (classpp_public_tpu/ops/splines.py:93)")
    h = torch.diff(x)
    y2d = y if y.ndim > 1 else y[:, None]
    dy = torch.diff(y2d, dim=0) / h[:, None]
    one = torch.ones(1, dtype=x.dtype, device=x.device)
    zero = torch.zeros(1, dtype=x.dtype, device=x.device)
    dl = torch.cat([zero, h[:-1], zero])
    d = torch.cat([one, 2.0 * (h[:-1] + h[1:]), one])
    du = torch.cat([zero, h[1:], zero])
    zrow = torch.zeros((1, y2d.shape[1]), dtype=y2d.dtype, device=y2d.device)
    mid = 6.0 * (dy[1:] - dy[:-1])
    if bc == "est_deriv":
        x0, x1, x2 = x[0], x[1], x[2]
        dy_first = (((x2 - x0) ** 2 * (y2d[1] - y2d[0])
                     - (x1 - x0) ** 2 * (y2d[2] - y2d[0]))
                    / ((x2 - x0) * (x1 - x0) * (x2 - x1)))
        xm0, xm1, xm2 = x[-1], x[-2], x[-3]
        dy_last = (((xm2 - xm0) ** 2 * (y2d[-2] - y2d[-1])
                    - (xm1 - xm0) ** 2 * (y2d[-3] - y2d[-1]))
                   / ((xm2 - xm0) * (xm1 - xm0) * (xm2 - xm1)))
        d = torch.cat([2.0 * one, d[1:-1], 2.0 * one])
        du = torch.cat([one, du[1:]])
        dl = torch.cat([dl[:-1], one])
        first = (6.0 * (dy[0] - dy_first) / h[0])[None]
        last = (6.0 * (dy_last - dy[-1]) / h[-1])[None]
        rhs = torch.cat([first, mid, last], dim=0)
    else:
        rhs = torch.cat([zrow, mid, zrow], dim=0)
    y2 = tridiag_solve(dl, d, du, rhs)
    return y2 if y.ndim > 1 else y2[:, 0]


def _bracket(x: torch.Tensor, xq: torch.Tensor) -> torch.Tensor:
    return torch.clamp(torch.searchsorted(x, xq, right=True) - 1, 0, x.shape[0] - 2)


def spline_eval(x: torch.Tensor, y: torch.Tensor, y2: torch.Tensor,
                xq: torch.Tensor) -> torch.Tensor:
    """Cubic spline at xq on a non-uniform grid (array_interpolate_spline,
    tools/arrays.c:1565). y, y2: (n,) or (n, m)."""
    xq = torch.as_tensor(xq, dtype=x.dtype, device=x.device)
    idx = _bracket(x, xq)
    xl, xr = x[idx], x[idx + 1]
    h = xr - xl
    a = (xr - xq) / h
    b = (xq - xl) / h
    if y.ndim > 1:
        a, b, h = a[..., None], b[..., None], h[..., None]
    yl, yr, y2l, y2r = y[idx], y[idx + 1], y2[idx], y2[idx + 1]
    return a * yl + b * yr + ((a**3 - a) * y2l + (b**3 - b) * y2r) * h * h / 6.0


def _segments(x, y, y2):
    h = torch.diff(x)
    if y.ndim > 1:
        h = h[:, None]
    return h * (y[:-1] + y[1:]) / 2.0 - h**3 * (y2[:-1] + y2[1:]) / 24.0


def spline_integrate(x: torch.Tensor, y: torch.Tensor, y2: torch.Tensor) -> torch.Tensor:
    """Cumulative spline integral from x[0], shaped like y."""
    seg = _segments(x, y, y2)
    return torch.cat([torch.zeros_like(y[:1]), torch.cumsum(seg, dim=0)], dim=0)


def spline_integrate_reverse(x: torch.Tensor, y: torch.Tensor, y2: torch.Tensor) -> torch.Tensor:
    """out[i] = int_{x[i]}^{x[-1]} y dx, accumulated from the upper end."""
    seg = _segments(x, y, y2)
    rev = torch.flip(torch.cumsum(torch.flip(seg, [0]), dim=0), [0])
    return torch.cat([rev, torch.zeros_like(y[:1])], dim=0)


class UniformSpline(NamedTuple):
    """Cubic spline on a uniform grid: O(1) arithmetic lookup."""

    x0: float
    dx: float
    y: torch.Tensor     # (n,) or (n, m)
    y2: torch.Tensor    # same shape as y

    @property
    def n(self) -> int:
        return self.y.shape[0]

    @classmethod
    def build(cls, x0, dx, y: torch.Tensor, bc: str = "natural") -> "UniformSpline":
        x0, dx = float(x0), float(dx)
        x = x0 + dx * torch.arange(y.shape[0], dtype=y.dtype, device=y.device)
        return cls(x0, dx, y, spline_d2(x, y, bc=bc))

    def to(self, device) -> "UniformSpline":
        return self._replace(y=self.y.to(device), y2=self.y2.to(device))

    def _weights(self, xq):
        t = (xq - self.x0) / self.dx
        idx = torch.clamp(torch.floor(t).long(), 0, self.n - 2)
        b = t - idx
        a = 1.0 - b
        if self.y.ndim > 1:
            a, b = a[..., None], b[..., None]
        return idx, a, b

    def eval(self, xq: torch.Tensor) -> torch.Tensor:
        idx, a, b = self._weights(xq)
        yl, yr, y2l, y2r = self.y[idx], self.y[idx + 1], self.y2[idx], self.y2[idx + 1]
        h2 = self.dx * self.dx
        return a * yl + b * yr + ((a**3 - a) * y2l + (b**3 - b) * y2r) * h2 / 6.0

    def eval_deriv(self, xq: torch.Tensor) -> torch.Tensor:
        idx, a, b = self._weights(xq)
        yl, yr, y2l, y2r = self.y[idx], self.y[idx + 1], self.y2[idx], self.y2[idx + 1]
        return (yr - yl) / self.dx + ((3.0 * b**2 - 1.0) * y2r
                                      - (3.0 * a**2 - 1.0) * y2l) * self.dx / 6.0


def interp(xq: torch.Tensor, xp: torch.Tensor, fp: torch.Tensor) -> torch.Tensor:
    """Piecewise-linear interpolation with numpy.interp's semantics
    (clamped to the end values outside [xp[0], xp[-1]])."""
    xq = torch.as_tensor(xq, dtype=xp.dtype, device=xp.device)
    idx = torch.clamp(torch.searchsorted(xp, xq, right=True) - 1, 0, xp.shape[0] - 2)
    x0, x1 = xp[idx], xp[idx + 1]
    w = torch.clamp((xq - x0) / (x1 - x0), 0.0, 1.0)
    return fp[idx] + w * (fp[idx + 1] - fp[idx])

"""Lensed CMB spectra by the correlation-function method (Challinor & Lewis
2005), counterpart of classpp_public_tpu/models/lensing.py (`_wigner_seed`
:38, `_wigner_coeffs` :48, `compute_lensing` :84, `_lensing_impl` :94-284).

Twelve Wigner d^l_{m m'} three-term recurrences run over l on a mu grid in
three passes: (1) the deflection correlations Cgl, Cgl2; (2) the lensed
correlation functions ksi, ksiX, ksi+-; (3) the projection back to C_l. On a
CUDA tensor the passes are the hand-written kernel csrc/lensing_wigner.cu
(`lensing_wigner`); on a CPU tensor the plain version `lensing_wigner_plain`.
Default is the reference's fast mode: Riemann sum on theta in [0, pi/16] of
the correlation *difference*, plus the unlensed add-back.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import numpy as np
import torch

from ..config.precision import PrecisionParams
from ..ops.quadrature import gauss_legendre
from .spectra import CT_TYPES, SpectraResult

PAIRS = [(0, 0), (1, 1), (1, -1), (2, -2), (2, 0), (3, -1), (4, -2),
         (2, 2), (3, 1), (3, -3), (4, 0), (4, -4)]
_P = {p: i for i, p in enumerate(PAIRS)}


def wigner_seed(m, mp, mu):
    """d^{l0}_{m mp}(mu) at l0 = m (m >= |mp|; every pair here has even m - mp)."""
    c2 = (1.0 + mu) / 2.0
    s2 = (1.0 - mu) / 2.0
    return math.sqrt(math.comb(2 * m, m - mp)) * c2 ** ((m + mp) / 2.0) * s2 ** ((m - mp) / 2.0)


def wigner_coeffs(m, mp, lmax):
    """B_l and m mp/(l(l+1)) of the recurrence
    B_{l+1} d^{l+1} = (2l+1)(mu - m mp/(l(l+1))) d^l - B_l d^{l-1}."""
    l = np.arange(0, lmax + 2, dtype=np.float64)
    with np.errstate(invalid="ignore", divide="ignore"):
        B = np.sqrt(np.maximum(l**2 - m**2, 0.0)) * np.sqrt(np.maximum(l**2 - mp**2, 0.0)) \
            / np.maximum(l, 1)
        shift = np.where(l > 0, m * mp / np.maximum(l * (l + 1), 1e-300), 0.0)
    return B, shift


def mu_grid(l_unlensed_max: int, accurate: bool, num_mu_minus_lmax: int):
    """(mu, w8) float64 numpy: Gauss-Legendre (accurate) or the fast mode's
    theta Riemann grid on [0, pi/16]."""
    if accurate:
        num_mu = l_unlensed_max + num_mu_minus_lmax
        num_mu += num_mu % 2
        return gauss_legendre(num_mu - 1)
    num_mu = (l_unlensed_max * 2) // 16
    dtheta = math.pi / 16.0 / (num_mu - 1)
    theta = (np.arange(num_mu - 1) + 1) * dtheta
    return np.cos(theta), np.sin(theta) * dtheta


class LensedResult(NamedTuple):
    ell: torch.Tensor
    cl: torch.Tensor          # (nl, nct) lensed C_l; pp/tp/ep unlensed copies


def _tables(cl_of_l: torch.Tensor):
    """Per-l tables shared by both versions: w_pp (lmax+1,), the X-function
    square roots sq1..sq5 (5, lmax+1), recurrence B and shift (12, lmax+2)."""
    lmax = cl_of_l.shape[0] - 1
    dev, f64 = cl_of_l.device, torch.float64
    ls = torch.arange(0, lmax + 1, dtype=f64, device=dev)
    w_pp = (2.0 * ls + 1.0) * ls * (ls + 1.0) * cl_of_l[:, CT_TYPES.index("pp")] / (4.0 * math.pi)
    z = torch.zeros_like(ls)
    sq = torch.stack([
        torch.sqrt((ls + 2) * (ls + 1) * ls * torch.maximum(ls - 1, z)),
        torch.sqrt(torch.maximum((ls + 2) * (ls - 1), z)),
        torch.sqrt(torch.maximum((ls + 3) * (ls - 2), z)),
        torch.sqrt(torch.maximum((ls + 4) * (ls + 3) * (ls - 2) * (ls - 3), z)),
        torch.sqrt(ls * (ls + 1))])
    co = [wigner_coeffs(m, mp, lmax) for m, mp in PAIRS]
    B = torch.as_tensor(np.stack([c[0] for c in co]), dtype=f64, device=dev)
    S = torch.as_tensor(np.stack([c[1] for c in co]), dtype=f64, device=dev)
    return w_pp, sq, B, S


def _seeds(mu: torch.Tensor) -> torch.Tensor:
    return torch.stack([wigner_seed(m, mp, mu) for m, mp in PAIRS])


# From this l on every pair's recurrence coefficient B_{l+1} is positive and
# no pair starts (m <= 4): the pairs step as one block, and on a card each l
# of a pass is the replay of one CUDA graph (`_per_l`).
_L_BLOCK = 5


def _per_l(body, table, divisors, dev, out=None):
    """Run body(s, div) once per row i of `table` (name -> numpy array, (n,)
    for a scalar, (n, m) for a column of m values), in row order; with `out`
    its result goes to out[i]. `s[name]` is row i's value: a Python float (a
    column: an (m, 1) tensor), or on a card a 0-dim view (an (m, 1) view) of
    a device row that row i of the table is copied into before the replay of
    one CUDA graph of body. div(x, name) divides by s[name] for the names in
    `divisors`; on a card it multiplies by the reciprocal taken on the host,
    as PyTorch divides a CUDA tensor by a Python float, so that both forms
    round alike."""
    n = len(next(iter(table.values())))
    if dev.type != "cuda":
        for i in range(n):
            s = {k: float(v[i]) if v.ndim == 1 else torch.as_tensor(v[i][:, None], device=dev)
                 for k, v in table.items()}
            r = body(s, lambda x, k: x / s[k])
            if out is not None:
                out[i] = r
        return
    rows = [(1.0 / v if k in divisors else v).reshape(n, -1) for k, v in table.items()]
    ctab = torch.as_tensor(np.ascontiguousarray(np.concatenate(rows, axis=1)), device=dev)
    buf = torch.empty(ctab.shape[1], dtype=ctab.dtype, device=dev)
    s, o = {}, 0
    for k, v in table.items():
        w = 1 if v.ndim == 1 else v.shape[1]
        s[k] = buf[o] if v.ndim == 1 else buf[o:o + w].view(w, 1)
        o += w

    def div(x, k):
        return x * s[k]

    # row 0 runs eagerly on a side stream (the warm-up a capture needs), then
    # one graph of body is captured and replayed for every later row
    buf.copy_(ctab[0])
    side = torch.cuda.Stream(dev)
    side.wait_stream(torch.cuda.current_stream(dev))
    with torch.cuda.stream(side):
        r = body(s, div)
        if out is not None:
            out[0].copy_(r)
    torch.cuda.current_stream(dev).wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        r = body(s, div)
    for i in range(1, n):
        buf.copy_(ctab[i])
        graph.replay()
        if out is not None:
            out[i].copy_(r)


def lensing_wigner_plain(cl_of_l, mu, w8, l_lensed_max: int, fast: bool = True):
    """Plain version of the three passes (_lensing_impl :116-284): loops over
    l on mu-vectors, the pairs of a pass one (pairs, n_mu) block from
    l = _L_BLOCK on (before it each pair steps alone, where B_{l+1} may be 0
    and the pairs start), on a card one CUDA graph a l. cl_of_l: (lmax+1, 7)
    unlensed C_l from l = 0 (rows 0, 1 zero), CT_TYPES columns. Returns
    (l_lensed_max - 1, 7)."""
    lmax = cl_of_l.shape[0] - 1
    dev = mu.device
    ct = {n: i for i, n in enumerate(CT_TYPES)}
    cl = cl_of_l.cpu().numpy()
    w_pp, sq, Bt, St = _tables(cl_of_l)
    Bn, Sn = Bt.cpu().numpy(), St.cpu().numpy()
    sqn = sq.cpu().numpy()
    seeds = _seeds(mu)
    zero = torch.zeros_like(mu)
    Bdiv = np.maximum(Bn, 1e-300)

    def step(p, dl, dlm1, l):
        B = Bn[p, l + 1]
        if not B > 0:
            return zero
        return ((2.0 * l + 1.0) * (mu - Sn[p, l]) * dl - Bn[p, l] * dlm1) / max(B, 1e-300)

    def block_table(ps, ls):
        """The recurrence's scalars of the pairs ps at each l of ls."""
        ls = np.asarray(ls)
        return {"c": 2.0 * ls + 1.0, "S": Sn[ps][:, ls].T, "B": Bn[ps][:, ls].T,
                "Bnext": Bdiv[ps][:, ls + 1].T}

    def block_step(s, div, D, Dm):
        """One l of the recurrences of the block D (d^l) over Dm (d^(l-1)), in
        place: the per-pair step's arithmetic element by element."""
        new = div(s["c"] * (mu - s["S"]) * D - s["B"] * Dm, "Bnext")
        Dm.copy_(D)
        D.copy_(new)

    # pass 1: Cgl, Cgl2 (d11 and d1-1 from l = 1)
    i11, i1m1 = _P[(1, 1)], _P[(1, -1)]
    wpp = w_pp.cpu().numpy()
    D1 = torch.stack([seeds[i11], seeds[i1m1]])
    Dm1 = torch.zeros_like(D1)
    Cgl = zero.clone()
    Cgl2 = zero.clone()
    if lmax >= 1:
        D1[0], Dm1[0] = step(i11, D1[0], Dm1[0], 1), D1[0].clone()
        D1[1], Dm1[1] = step(i1m1, D1[1], Dm1[1], 1), D1[1].clone()

    def pass1(s, div):
        Cgl.copy_(Cgl + s["wpp"] * D1[0])
        Cgl2.copy_(Cgl2 + s["wpp"] * D1[1])
        block_step(s, div, D1, Dm1)

    if lmax >= 2:
        ls = np.arange(2, lmax + 1)
        _per_l(pass1, dict(wpp=wpp[ls], **block_table([i11, i1m1], ls)), ("Bnext",), dev)
    sigma2 = float(w_pp[2:].sum()) - Cgl

    # pass 2: ksi, ksiX, ksi+, ksi- (all twelve pairs from l = 0)
    D = torch.stack([torch.ones_like(mu) if m == 0 else zero for m, _ in PAIRS])
    Dm = torch.zeros_like(D)
    acc = torch.zeros((4,) + mu.shape, dtype=mu.dtype, device=dev)   # ksi, ksiX, ksi+, ksi-
    # the factors of the X functions that do not depend on l
    P022 = 1.0 + sigma2 * (1.0 + 0.5 * sigma2)
    P121 = 1.0 + 2.0 / 3.0 * sigma2
    P132 = 1.0 + 5.0 / 3.0 * sigma2
    C2 = Cgl2 * 2.0
    CC = Cgl2 * Cgl2
    hCC = 0.5 * Cgl2 * Cgl2

    def lens(s, div):
        """The lensed correlation terms of one l, accumulated into acc."""
        X000 = torch.exp(s["nfac"] * sigma2)
        Xp000 = s["nfac"] * X000
        X220 = s["c220"] * X000
        X022 = X000 * P022
        Xp022 = s["c022"] * X022
        X242 = s["c242"] * X000
        X121 = s["c121"] * X000 * P121
        X132 = s["c132"] * X000 * P132
        d00, d11, d1m1, d2m2, d20, d3m1, d4m2, d22, d31, d3m3, d40, d4m4 = D
        XpXp = Xp000 * Xp000
        X220s = X220 * X220
        X022s = X022 * X022
        Xp022x2 = 2.0 * Xp022
        lens_tt = (X000 * X000 * d00
                   + div(XpXp * d1m1 * Cgl2 * 8.0, "mtt")
                   + (XpXp * d00 + X220s * d2m2) * Cgl2 * Cgl2)
        lens_te = (X022 * X000 * d20
                   + div(C2 * Xp000, "mte") * (X121 * d11 + X132 * d3m1)
                   + hCC * ((Xp022x2 * Xp000 + X220s) * d20 + X220 * X242 * d4m2))
        lens_p = (X022s * d22 + 2.0 * Cgl2 * X132 * X121 * d31
                  + CC * (Xp022 * Xp022 * d22 + X242 * X220 * d40))
        lens_m = (X022s * d2m2 + Cgl2 * (X121 * X121 * d1m1 + X132 * X132 * d3m3)
                  + hCC * (Xp022x2 * Xp022 * d2m2 + X220s * d00 + X242 * X242 * d4m4))
        if fast:
            lens_tt = lens_tt - d00
            lens_te = lens_te - d20
            lens_p = lens_p - d22
            lens_m = lens_m - d2m2
        for i, (f, t) in enumerate((("ftt", lens_tt), ("fte", lens_te), ("fp", lens_p),
                                    ("fm", lens_m))):
            acc[i].add_(s[f] * t)

    def lens_table(ls):
        lf = np.asarray(ls, dtype=np.float64)
        fac = lf * (lf + 1.0) / 4.0
        fac1 = (2.0 * lf + 1.0) / (4.0 * math.pi)
        c = cl[ls]
        return {"nfac": -fac, "c220": 0.25 * sqn[0, ls], "c022": -(fac - 1.0),
                "c242": 0.25 * sqn[3, ls], "c121": -0.5 * sqn[1, ls], "c132": -0.5 * sqn[2, ls],
                "mtt": np.maximum(lf * (lf + 1.0), 1e-300), "mte": np.maximum(sqn[4, ls], 1e-300),
                "ftt": fac1 * c[:, ct["tt"]], "fte": fac1 * c[:, ct["te"]],
                "fp": fac1 * (c[:, ct["ee"]] + c[:, ct["bb"]]),
                "fm": fac1 * (c[:, ct["ee"]] - c[:, ct["bb"]])}

    for l in range(0, min(_L_BLOCK, lmax + 1)):
        for p, (m, _) in enumerate(PAIRS):
            if l == m:
                D[p] = seeds[p]
        if l >= 2:
            row = {k: float(v[0]) for k, v in lens_table([l]).items()}
            lens(row, lambda x, k: x / row[k])
        new = [step(p, D[p], Dm[p], l) for p in range(len(PAIRS))]
        Dm.copy_(D)
        D.copy_(torch.stack(new))
    if lmax >= _L_BLOCK:
        ls = np.arange(_L_BLOCK, lmax + 1)

        def pass2(s, div):
            lens(s, div)
            block_step(s, div, D, Dm)

        _per_l(pass2, dict(**lens_table(ls), **block_table(list(range(len(PAIRS))), ls)),
               ("mtt", "mte", "Bnext"), dev)
    ksi, ksiX, ksip, ksim = acc

    # pass 3: C_l = 2 pi sum_mu w8 ksi d (the four pairs it needs)
    use = [_P[(0, 0)], _P[(2, 0)], _P[(2, 2)], _P[(2, -2)]]
    D3 = torch.stack([torch.ones_like(mu) if PAIRS[p][0] == 0 else zero for p in use])
    Dm3 = torch.zeros_like(D3)
    cls = torch.empty((l_lensed_max - 1, 4), dtype=mu.dtype, device=dev)   # tt, ee, te, bb

    def row():
        d00, d20, d22, d2m2 = D3
        kp = ksip * d22
        km = ksim * d2m2
        return torch.stack([2.0 * math.pi * torch.sum(ksi * d00 * w8),
                            2.0 * math.pi * torch.sum(0.5 * (kp + km) * w8),
                            2.0 * math.pi * torch.sum(ksiX * d20 * w8),
                            2.0 * math.pi * torch.sum(0.5 * (kp - km) * w8)])

    def rows(s, div):
        r = row()
        block_step(s, div, D3, Dm3)
        return r

    for l in range(0, min(_L_BLOCK, l_lensed_max + 1)):
        for i, p in enumerate(use):
            if l == PAIRS[p][0]:
                D3[i] = seeds[p]
        if l >= 2:
            cls[l - 2] = row()
        new = [step(p, D3[i], Dm3[i], l) for i, p in enumerate(use)]
        Dm3.copy_(D3)
        D3.copy_(torch.stack(new))
    if l_lensed_max >= _L_BLOCK:
        ls = np.arange(_L_BLOCK, l_lensed_max + 1)
        _per_l(rows, block_table(use, ls), ("Bnext",), dev, out=cls[_L_BLOCK - 2:])
    raw = cl_of_l[2: l_lensed_max + 1]
    if fast:
        cls = cls + raw[:, [ct["tt"], ct["ee"], ct["te"], ct["bb"]]]
    out = raw.clone()
    out[:, ct["tt"]], out[:, ct["ee"]] = cls[:, 0], cls[:, 1]
    out[:, ct["te"]], out[:, ct["bb"]] = cls[:, 2], cls[:, 3]
    return out


def lensing_wigner(cl_of_l: torch.Tensor, mu: torch.Tensor, w8: torch.Tensor,
                   l_lensed_max: int, fast: bool = True) -> torch.Tensor:
    """Lensed (l_lensed_max - 1, 7) table in CT_TYPES order: the CUDA kernel
    for CUDA tensors, the plain version for CPU tensors."""
    return lensing_wigner_plain(cl_of_l, mu, w8, l_lensed_max, fast)


def compute_lensing(sp: SpectraResult, pr: PrecisionParams, l_lensed_max: int) -> LensedResult:
    dev = sp.cl.device
    l_unlensed_max = sp.ell.shape[0] + 1
    cl_of_l = torch.cat([torch.zeros((2, sp.cl.shape[1]), dtype=sp.cl.dtype, device=dev),
                         sp.cl]).contiguous()
    mu, w8 = (torch.as_tensor(np.ascontiguousarray(a), dtype=torch.float64, device=dev)
              for a in mu_grid(l_unlensed_max, pr.accurate_lensing, pr.num_mu_minus_lmax))
    out = lensing_wigner(cl_of_l, mu, w8, l_lensed_max, fast=not pr.accurate_lensing)
    return LensedResult(ell=torch.arange(2, l_lensed_max + 1, device=dev), cl=out)

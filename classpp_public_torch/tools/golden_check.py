#!/usr/bin/env python3
"""The reference goldens' contracts, and a check of configurations against them.

`golden_check(name, raw, lensed, pk_lin, h)` holds the spectra of a run of
the configuration `name` to the golden tests/golden/<name>.npz (built by the
reference C++ code) under the contract of the JAX package's test of that
golden: g3_tensor (tests/test_extended.py:58-92), g8_curved
(tests/test_curved.py:176-196), g18_closed (tests/test_curved.py:112-157),
g29_open01 and g30_closed01 (tests/test_curved_large.py:43-102). chip_smoke.py
uses it for its golden paths.

Run as a script it drives configurations through Class(device="cuda") and
prints each measure against its limit with the multipole of the largest
error; it exits 1 if any is out of its contract.

Usage (from the repository root, needs one card and nvcc):
    python3 -m classpp_public_torch.tools.golden_check g29_open01 g30_closed01
"""

import json
import os
import sys
import time

import numpy as np

GOLDEN_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..", "..", "tests",
                          "golden")
CL_TOL, PK_TOL = 3e-3, 1e-2


class Golden:
    """The tables of a reference golden (tests/golden/<name>.npz): C_l tables
    with the multipole in column 0, D_l = l(l+1)/2pi C_l in the others."""

    def __init__(self, name):
        self.g = np.load(os.path.join(GOLDEN_DIR, name + ".npz"))

    def col(self, table, name):
        cols = [str(c) for c in self.g[table + "__cols"]]
        return self.g[table][:, 0], self.g[table][:, cols.index(name)]

    def rel(self, table, name, mine, lmin, lmax):
        """(max |D_l(mine) / D_l(golden) - 1| over l = lmin..lmax, its l);
        mine: C_l indexed by l."""
        ell = np.arange(lmin, lmax + 1)
        lr, ref = self.col(table, name)
        err = np.abs(ell * (ell + 1) / (2 * np.pi) * mine[lmin:lmax + 1]
                     / np.interp(ell, lr, ref) - 1)
        return float(err.max()), int(ell[err.argmax()])

    def rel_te(self, table, mine, lmax):
        """(max |D_l^TE(mine) - golden| / sqrt(D_l^TT D_l^EE), its l), l = 2..lmax."""
        ell = np.arange(2, lmax + 1)
        lr, te = self.col(table, "TE")
        den = np.sqrt(np.interp(ell, lr, self.col(table, "TT")[1])
                      * np.interp(ell, lr, self.col(table, "EE")[1]))
        err = np.abs(ell * (ell + 1) / (2 * np.pi) * mine[2:lmax + 1]
                     - np.interp(ell, lr, te)) / den
        return float(err.max()), int(ell[err.argmax()])

    def rel_pk(self, pk_lin, h):
        """(max relative error, its k in 1/Mpc) of P(k, z = 0) against the
        table pk (every 5th k in 1e-3 < k < 0.9/Mpc, k and P in h units), as
        the JAX tests read it."""
        T = self.g["pk"]
        ks = T[:, 0] * h
        sel = (ks > 1e-3) & (ks < 0.9)
        mine = np.array([pk_lin(k, 0.0) for k in ks[sel][::5]])
        err = np.abs(mine / (T[sel, 1][::5] / h**3) - 1)
        return float(err.max()), float(ks[sel][::5][err.argmax()])


def golden_check(name, raw, lensed, pk_lin, h):
    """The contract of the golden `name`: {measure: (relative error, limit,
    where)}, where is the multipole (or k) of the largest error. raw and
    lensed: C_l dicts indexed by l to 2500; pk_lin(k, z): the linear P(k)."""
    g = Golden(name)

    def item(measure, tol):
        return (measure[0], tol, measure[1])

    if name == "g3_tensor":
        # tensor-only BB (clt) at l = 2-500, raw total TT (clt + cls), lensed
        # TT/EE/BB to l = 2000
        ell = np.arange(2, 501)
        lt, tt_t = g.col("clt", "TT")
        ls, tt_s = g.col("cls", "TT")
        ref_tt = np.interp(ell, lt, tt_t) + np.interp(ell, ls, tt_s)
        err = np.abs(ell * (ell + 1) / (2 * np.pi) * raw["tt"][2:501] / ref_tt - 1)
        rel = {"tensor_bb": item(g.rel("clt", "BB", raw["bb"], 2, 500), 1e-2),
               "raw_tt": (float(err.max()), CL_TOL, int(ell[err.argmax()]))}
        for n in ("tt", "ee", "bb"):
            rel[f"lensed_{n}"] = item(g.rel("cl_lensed", n.upper(), lensed[n], 2, 2000), 1e-2)
        return rel
    if name == "g8_curved":
        # tensor BB (clt) at l = 2-500 within 1e-2, total TT at l <= 500
        return {"tensor_bb": item(g.rel("clt", "BB", raw["bb"], 2, 500), 1e-2),
                "raw_tt": item(g.rel("cl", "TT", raw["tt"], 2, 500), CL_TOL)}
    rel = {"raw_tt": item(g.rel("cl", "TT", raw["tt"], 2, 2500), CL_TOL),
           "raw_ee": item(g.rel("cl", "EE", raw["ee"], 2, 2500), CL_TOL),
           "bb": item(g.rel("cl", "BB", raw["bb"], 2, 400), 1e-2),
           "lensed_tt": item(g.rel("cl_lensed", "TT", lensed["tt"], 2, 2400), CL_TOL),
           "lensed_ee": item(g.rel("cl_lensed", "EE", lensed["ee"], 2, 2400), CL_TOL),
           "pk": item(g.rel_pk(pk_lin, h), PK_TOL)}
    if name == "g18_closed":
        # and phiphi to l = 2000 within 3e-2
        rel["raw_pp"] = item(g.rel("cl", "phiphi", raw["pp"], 2, 2000), 3e-2)
    else:
        # g29_open01, g30_closed01: and raw TE against sqrt(TT EE)
        rel["raw_te"] = item(g.rel_te("cl", raw["te"], 2500), CL_TOL)
    return rel


def main():
    import torch

    import classpp_public_torch as cpt
    from .configs import CONFIGS, GOLDEN_ONLY

    names = sys.argv[1:] or sorted(GOLDEN_ONLY)
    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 1
    print(f"[card] {torch.cuda.get_device_name(0)}", flush=True)
    ok = True
    for name in names:
        t0 = time.time()
        c = cpt.Class(device="cuda")
        c.set(dict({**CONFIGS, **GOLDEN_ONLY}[name]))
        c.compute(["lensing"])
        raw, lensed = c.raw_cl(2500), c.lensed_cl(2500)
        torch.cuda.synchronize()
        rel = golden_check(name, raw, lensed, c.pk_lin, c.cosmo.params.h)
        bad = sorted(k for k, (v, tol, _) in rel.items() if not v <= tol)
        ok = ok and not bad
        print(f"[golden] {name} ({time.time() - t0:.3f} s) "
              + json.dumps({k: {"rel": v, "tol": tol, "at": at} for k, (v, tol, at) in rel.items()})
              + (f" OUT OF CONTRACT: {bad}" if bad else ""), flush=True)
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())

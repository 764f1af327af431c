"""The accessors a cell reads, and the numbers that compare two sides' reads.

A configuration's `reads` lists the classy calls its likelihood makes after
`compute()`: `lensed_cl` (`lmax`, `spectra`, `bands`), `pk` and `pk_lin` on
`n` log-spaced k from `k_min` to `k_max` (1/Mpc) at redshift `z`, `sigma8`,
and `density_cl` (`lmax`, `bands`). `perform` makes them on the program's
`Class` or on the reference's, in the same order.

The numbers, each from the relative gap r of the program's read a against
the reference's b:
- `cl_band`: lensed C_l with r = (a - b) / |b| (TE over sqrt(|TT EE|)). For
  each spectrum the read's `bands` give [start, stop, width] in l; the
  number is the largest |median of r| over every band of every spectrum.
- `nc_band`: the number counts' dd, dl and ll, each bin pair on its own,
  with r = (a - b) / max(|b|, the median of |b| over the spectrum's pairs)
  at each l: a pair whose spectrum is all but zero against the others is
  measured against the median pair. The largest |median of r| over every
  band of every pair of every spectrum.
- `pk_gap`: the widest |r| over the P(k) grids and sigma8.
A band median follows a shift of the whole spectrum, of one bin's pairs or
of one band of l, and stays still where single multipoles swing: the
spectra that integrate the latest source samples move with the last bits of
the thermodynamics, which move those samples (PERF.md). A non-finite value
or a shape that differs is an infinite gap. `parts` gives every read's
widest gap, where it lies, and its median gap, for the record.
"""

from __future__ import annotations

import numpy as np

NUMBER_OF = {"lensed_cl": "cl_band", "pk": "pk_gap", "pk_lin": "pk_gap", "sigma8": "pk_gap",
             "density_cl": "nc_band"}
NC_SPECTRA = ("dd", "ll", "dl")


def k_grid(read: dict) -> np.ndarray:
    return np.geomspace(read["k_min"], read["k_max"], read["n"])


def perform(cls, reads: list) -> dict:
    """The reads of one point: {call: arrays}, numpy on the host."""
    out = {}
    for r in reads:
        call = r["call"]
        if call == "lensed_cl":
            d = cls.lensed_cl(r["lmax"])
            out[call] = {s: np.asarray(d[s], dtype=float) for s in r["spectra"]}
        elif call in ("pk", "pk_lin"):
            fn = getattr(cls, call)
            out[call] = np.array([fn(float(k), r["z"]) for k in k_grid(r)])
        elif call == "sigma8":
            out[call] = np.array([cls.sigma8()])
        elif call == "density_cl":
            d = cls.density_cl(r["lmax"])
            out[call] = {s: np.asarray(d[s], dtype=float) for s in ("ell",) + NC_SPECTRA}
        else:
            raise ValueError(f"read {call!r}: the benchmark reads {sorted(NUMBER_OF)}")
    return out


def _sound(a: np.ndarray, b: np.ndarray) -> bool:
    return a.shape == b.shape and bool(np.isfinite(a).all() and np.isfinite(b).all())


def _rel(a: np.ndarray, b: np.ndarray, scale: np.ndarray) -> np.ndarray:
    """|a - b| / scale, all infinite where the shapes differ or a value is not
    finite."""
    if not _sound(a, b):
        return np.full(max(b.size, 1), np.inf)
    return np.abs(a - b) / np.maximum(scale, 1e-300)


def bands(spec) -> list:
    """[(lo, hi)] of a band spec [start, stop, width]: bands of `width` l
    from `start`, the last one ending at `stop`; a remainder shorter than
    half a width joins the band before it."""
    start, stop, width = spec
    out = [(lo, min(lo + width, stop)) for lo in range(start, stop, width)]
    if len(out) > 1 and out[-1][1] - out[-1][0] < width / 2:
        out[-2:] = [(out[-2][0], stop)]
    return out


def _cl_scale(b: dict, s: str) -> np.ndarray:
    return np.sqrt(np.abs(b["tt"] * b["ee"])) if s == "te" else np.abs(b[s])


def _nc_scale(b: np.ndarray) -> np.ndarray:
    return np.maximum(np.abs(b), np.median(np.abs(b), axis=0))


def cl_band(a: dict, b: dict, spec: dict) -> tuple:
    """(the largest |band median of r| of the lensed spectra, where)."""
    worst, where = 0.0, ""
    for s, sb in spec.items():
        if not _sound(a[s], b[s]):
            return float("inf"), f"{s} not finite or reshaped"
        r = (a[s] - b[s]) / np.maximum(_cl_scale(b, s), 1e-300)
        for lo, hi in bands(sb):
            m = abs(float(np.median(r[lo:hi])))
            if m > worst:
                worst, where = m, f"{s} l=[{lo},{hi})"
    return worst, where


def nc_band(a: dict, b: dict, spec: dict) -> tuple:
    """(the largest |band median of r| over the pairs of the counts, where)."""
    if a["ell"].shape != b["ell"].shape or (a["ell"] != b["ell"]).any():
        return float("inf"), "l grids differ"
    ell = b["ell"]
    worst, where = 0.0, ""
    for s, sb in spec.items():
        if not _sound(a[s], b[s]):
            return float("inf"), f"{s} not finite or reshaped"
        r = (a[s] - b[s]) / np.maximum(_nc_scale(b[s]), 1e-300)
        for lo, hi in bands(sb):
            med = np.abs(np.median(r[:, (ell >= lo) & (ell < hi)], axis=1))
            i = int(np.argmax(med))
            if med[i] > worst:
                worst, where = float(med[i]), f"{s} pair {i} l=[{lo},{hi})"
    return worst, where


def parts(prog: dict, ref: dict) -> list:
    """(number, read, part, widest |r|, where, median |r|) of every part of
    every read."""
    out = []
    for call, a in prog.items():
        b, name = ref[call], NUMBER_OF[call]
        if call == "lensed_cl":
            for s in a:
                r = _rel(a[s][2:], b[s][2:], _cl_scale(b, s)[2:])
                i = int(np.argmax(r))
                out.append((name, call, s, float(r[i]), f"l={i + 2}", float(np.median(r))))
        elif call == "density_cl":
            same = a["ell"].shape == b["ell"].shape and (a["ell"] == b["ell"]).all()
            for s in NC_SPECTRA:
                r = _rel(a[s], b[s], np.abs(b[s])) if same else np.full(1, np.inf)
                i = np.unravel_index(int(np.argmax(r)), r.shape)
                where = f"pair {i[0]} l={int(b['ell'][i[1]])}" if same else "l grids differ"
                out.append((name, call, s, float(r[i]), where, float(np.median(r))))
        else:
            r = _rel(a, b, np.abs(b))
            i = int(np.argmax(r))
            out.append((name, call, "", float(r[i]), f"i={i}", float(np.median(r))))
    return out


def located(prog: dict, ref: dict, reads: list) -> dict:
    """{number: (value, where)} of the program's reads against the
    reference's."""
    out = {}
    for r in reads:
        call = r["call"]
        if call == "lensed_cl":
            out["cl_band"] = cl_band(prog[call], ref[call], r["bands"])
        elif call == "density_cl":
            out["nc_band"] = nc_band(prog[call], ref[call], r["bands"])
        else:
            g = _rel(prog[call], ref[call], np.abs(ref[call]))
            i = int(np.argmax(g))
            if float(g[i]) >= out.get("pk_gap", (0.0, ""))[0]:
                out["pk_gap"] = (float(g[i]), f"{call} i={i}")
    return out


def numbers(prog: dict, ref: dict, reads: list) -> dict:
    """{number: value} of the program's reads against the reference's."""
    return {n: v for n, (v, _) in located(prog, ref, reads).items()}


def judge(gaps: dict, limits: dict) -> tuple:
    """(every number within its limit, {number: {"value", "limit"}})."""
    checks = {n: {"value": v, "limit": limits[n]} for n, v in sorted(gaps.items())}
    return all(c["value"] <= c["limit"] for c in checks.values()), checks

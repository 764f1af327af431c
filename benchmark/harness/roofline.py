"""The least time a kernel's work could take on the card, from its shapes and
counts: a frozen copy of chip_smoke.py's `bound` (:383-388), of its work
count for perturb_ark (:932-941) and of its count for recfast_history
(:1049-1069), kept here so that no change of the program moves the
yardstick.

The peaks are NVIDIA's published H100 SXM rates at the 700 W limit: HBM3 at
3.35 TB/s, and float64 outside the tensor cores taken as half the 67 TFLOP/s
float32 rate.
"""

from __future__ import annotations

PEAK_BYTES_S = 3.35e12
PEAK_F64_FLOPS = 33.5e12


def bound(nbytes: float, flops: float) -> tuple:
    """(seconds, "bytes" or "operations"): the larger of the bytes over the
    memory rate and the float64 operations over the peak rate."""
    tb, tf = nbytes / PEAK_BYTES_S, flops / PEAK_F64_FLOPS
    return (tb, "bytes") if tb >= tf else (tf, "operations")


def perturb_ark_flops(nsteps_sum: float, size: int, n_ncdm: int, n_ncdm_block: int,
                      n_stiff: int) -> float:
    """Each attempted step is 6 stages of the right-hand side (~12 n + 400
    operations), the stage combinations (30 (n + n_stiff)) and the solution
    and error sums (24 n), at the width n the lanes keep once the ncdm block
    has collapsed to its 3 fluid moments per species."""
    n_late = size - (n_ncdm_block - 3 * n_ncdm if n_ncdm else 0)
    return nsteps_sum * (6 * (12 * n_late + 400) + 30 * (n_late + n_stiff) + 24 * n_late)


def perturb_ark_bytes(input_bytes: float, n_lanes: int) -> float:
    """Every input read once and the source table written once (both in
    `input_bytes`), and the 6 per-lane doubles of the lane table."""
    return input_bytes + 6 * 8 * n_lanes


def recfast_integrated_intervals(z_desc, xe_desc, nz: int, zHe3: float, dzHe3: float,
                                 trigHe: float, fHe: float) -> int:
    """The intervals the history integrates after the HeI Saha phase ends:
    walking down in z, the first row below zHe3 + dzHe3 whose previous row's
    y1 = (x_e - 1)/fHe is no longer above trigHe."""
    y1 = 1.0
    for i, (z, xe) in enumerate(zip(z_desc, xe_desc)):
        if z <= zHe3 + dzHe3:
            if not y1 > trigHe:
                return nz - i
            y1 = (xe - 1.0) / fHe
    return 0


def recfast_history_flops(nz: int, n_int: int, injection: bool) -> float:
    """One derivative evaluation per interval for dT/dz and sixteen per
    integrated interval, ~350 operations each (fourteen exp/pow/log/sqrt),
    ~250 more with energy injection."""
    return (600.0 if injection else 350.0) * (nz + 16.0 * n_int)

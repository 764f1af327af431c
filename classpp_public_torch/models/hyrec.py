"""HyRec-2011 recombination: the staged history on the uniform ln a grid,
with the effective 3-level rate (`model="recfast"`, what `recombination =
HyRec` selects) or the full EMLA + two-photon radiative transfer
(`model="full"`, `recombination = hyrec_full`).

Counterpart of classpp_public_tpu/models/hyrec.py (`_load_tables`,
`_read_specs` :70-125, `make_hyrec_ctx` :153, the elementary pieces :185-362,
the two-photon core :365-572, `build_history` :574-751, `_cubic_resample`
:754, `hyrec_injection_grid` :785, `compute_recombination_hyrec` :846).
Physics: Ali-Haimoud & Hirata 2011 (hyrec/history.c:242 rec_build_history,
hyrec/hydrogen.c, hyrec/helium.c).

Where it runs. The history (108 487 dependent steps of d ln a = 8.49e-5) is
the kernel `hyrec_history` (csrc/hyrec.cu) for CUDA tensors and the host
loop `hyrec_history_plain` for CPU tensors. The plain loop works in Python
floats with libm's exp/log/pow, and its per-bin sums follow the kernel's
fixed reduction order (`_tree_sum`), so that the host build of the kernel's
code (csrc/hyrec_host.cpp) reproduces it to the last bits. The context, the
injection table, the resampling to the RECFAST z grid and the derived
columns are host code.
"""

from __future__ import annotations

import ctypes
import math
from functools import lru_cache
from pathlib import Path
from typing import NamedTuple

import numpy as np
import torch

from .. import constants as const
from ..ops import cuda

# launches of the kernel hyrec_history (counted only where launched)
launches = 0

# dimensions and constants (hyrec/hydrogen.h:14-26, 77-80), eV-cgs units
EI = 13.598286071938324
E21 = 10.198714553953742
E31 = 12.087365397278509
E41 = 12.748393192442178
E32 = 1.8886508433247664
E42 = 2.5496786384884356
KBOLTZ = 8.617343e-5          # eV/K
L2S1S = 8.2206                # 2s->1s two-photon rate, s^-1
HPC = 1.239841874331e-04      # h*c in eV cm
MH_EV = 0.93878299831e9       # H atom mass, eV/c^2

NSUBLYA = 140
NSUBLYB = 271
NVIRT = 311
NDIFF = 80
NSUBDIFF = NSUBLYA - NDIFF // 2
NSPEC = NVIRT + 2             # photon-history reads per evaluation
NROW = NVIRT + 3              # ring columns: virtual bins, then Ly a/b/g

TR_MIN, TR_MAX, NTR = 0.004, 0.4, 100
TM_TR_MIN, TM_TR_MAX, NTM = 0.1, 1.0, 40

DLNA = 8.49e-5
RING = 512                    # > max lookback (~357 steps) for zstart = 1e4
# the kernel's block reduction: 32-lane trees over the bins padded to
# NWARP * 32, then a 16-lane tree over the NWARP warp sums
NWARP = 10
NPAD = 32 * NWARP
MODELS = ("recfast", "full")
NZCOL = 19                    # columns of the kernel's redshift-only table (hy::NZCOL)

_DATA = Path(__file__).resolve().parents[1] / "data" / "hyrec"

# phases of the staged history (build_history)
PH_HE_SAHA, PH_HE_POSTSAHA, PH_HE_EVOL, PH_H_POSTSAHA = 0, 1, 2, 3
PH_H2G_TMSS, PH_H2G_TM, PH_HMLA, PH_PEEBLES = 4, 5, 6, 7


@lru_cache(maxsize=8)
def _load_tables(alpha_file=None, r_inf_file=None, two_photon_file=None):
    """Rate tables: logAlpha (2, NTM, NTR), logR2p2s (NTR,), and the
    two-photon rows Eb, A1s, A2s, A3s3d, A4s4d (NVIRT each) (hydrogen.c:97-128,
    :268-295); the paths default to the port's copy in data/hyrec and are the
    hyrec_*_file precision inputs."""
    alpha = np.loadtxt(alpha_file or _DATA / "Alpha_inf.dat").reshape(NTR, NTM, 2)
    log_alpha = np.log(alpha).transpose(2, 1, 0).copy()      # (2, NTM, NTR)
    log_r2p2s = np.log(np.loadtxt(r_inf_file or _DATA / "R_inf.dat").reshape(NTR))
    twog = np.loadtxt(two_photon_file or _DATA / "two_photon_tables.dat").T.copy()   # (5, NVIRT)
    # normalize the differential 2s->1s rate to L2s1s (hydrogen.c:292-295)
    twog[2, :NSUBLYA] *= L2S1S / twog[2, :NSUBLYA].sum()
    return log_alpha, log_r2p2s, twog


def _read_specs(Eb):
    """(src_row, offset_steps, 4 cubic weights) of every photon-history read
    in fplus_from_fminus (hydrogen.c:600-654): rows 0..NVIRT-1 of the ring
    are the virtual bins, NVIRT..NVIRT+2 the Ly a/b/g lines; the lookbacks
    are constant in time."""
    src = np.zeros(NSPEC, dtype=np.int32)
    d = np.zeros(NSPEC)
    for b in range(NVIRT - 1):
        src[b] = b + 1
        d[b] = math.log(Eb[b + 1] / Eb[b]) / DLNA
    src[NSUBLYA - 1] = NVIRT + 0
    d[NSUBLYA - 1] = math.log(E21 / Eb[NSUBLYA - 1]) / DLNA
    src[NSUBLYB - 1] = NVIRT + 1
    d[NSUBLYB - 1] = math.log(E31 / Eb[NSUBLYB - 1]) / DLNA
    src[NVIRT - 1] = NVIRT + 2
    d[NVIRT - 1] = math.log(E41 / Eb[NVIRT - 1]) / DLNA
    src[NVIRT] = NSUBLYA
    d[NVIRT] = math.log(Eb[NSUBLYA] / E21) / DLNA
    src[NVIRT + 1] = NSUBLYB
    d[NVIRT + 1] = math.log(Eb[NSUBLYB] / E31) / DLNA
    # cubic Lagrange at index (m - d), clamped to ix <= m - 3 (rec_interp1d,
    # hyrectools.c:104-133)
    off = np.maximum(np.ceil(d - 1e-12), 3.0)
    f = off - d
    w = np.stack([-f * (1.0 - f) * (2.0 - f) / 6.0,
                  (1.0 + f) * (1.0 - f) * (2.0 - f) / 2.0,
                  (1.0 + f) * f * (2.0 - f) / 2.0,
                  (1.0 + f) * f * (f - 1.0) / 6.0], axis=1)
    return src, off.astype(np.int32), w


class HyrecTables(NamedTuple):
    """The rate tables and read specs of one history (float64 / int32
    tensors on one device)."""

    log_alpha: torch.Tensor   # (2, NTM, NTR)
    log_r2p2s: torch.Tensor   # (NTR,)
    twog: torch.Tensor        # (5, NVIRT): Eb, A1s, A2s, A3s3d, A4s4d
    read_src: torch.Tensor    # (NSPEC,) int32
    read_off: torch.Tensor    # (NSPEC,) int32
    read_w: torch.Tensor      # (NSPEC, 4)

    def to(self, device) -> "HyrecTables":
        return HyrecTables(*(t.to(device).contiguous() for t in self))


class HyrecCtx(NamedTuple):
    """Scalars (REC_COSMOPARAMS) and tables of one cosmology."""

    T0: float           # K
    nH0: float          # m^-3
    fHe: float
    omh2: float
    okh2: float
    odeh2: float
    ogh2: float
    onuh2_fac: float    # 0.2271..*Nnueff
    w0: float
    wa: float
    tables: HyrecTables


# order of hy::Params in csrc/hyrec.cuh
HY_PARAMS = ("T0", "nH0", "fHe", "omh2", "okh2", "odeh2", "ogh2", "onuh2_fac", "w0", "wa")


def make_hyrec_ctx(params, bg, YHe: float, Neff: float, pr=None) -> HyrecCtx:
    """make_hyrec_ctx (hyrec.py:153): the densities from the background
    result, the tables from the hyrec_*_file precision inputs."""
    h2 = params.h * params.h
    obh2 = params.omega_b
    omh2 = (float(bg.Omega0_b) + float(bg.Omega0_cdm) + float(bg.Omega0_ncdm_tot)) * h2
    others = (float(bg.Omega0_g) + float(bg.Omega0_ur) + float(bg.Omega0_b)
              + float(bg.Omega0_cdm) + float(bg.Omega0_ncdm_tot))
    log_alpha, log_r2p2s, twog = _load_tables(
        getattr(pr, "hyrec_Alpha_inf_file", "") or None,
        getattr(pr, "hyrec_R_inf_file", "") or None,
        getattr(pr, "hyrec_two_photon_tables_file", "") or None)
    src, off, w = _read_specs(twog[0])
    t = torch.as_tensor
    tables = HyrecTables(t(log_alpha), t(log_r2p2s), t(twog), t(src), t(off), t(w))
    return HyrecCtx(
        T0=float(params.T_cmb), nH0=11.223846333047 * obh2 * (1.0 - YHe),
        fHe=YHe / (1.0 - YHe) / 3.97153, omh2=omh2, okh2=params.Omega_k * h2,
        odeh2=(1.0 - params.Omega_k - others) * h2, ogh2=4.48162687719e-7 * params.T_cmb**4,
        onuh2_fac=0.227107317660239 * Neff,
        w0=params.w0_fld if params.use_fld else -1.0,
        wa=params.wa_fld if params.use_fld else 0.0, tables=tables)


def hyrec_params(ctx: HyrecCtx) -> torch.Tensor:
    """The HY_PARAMS vector (float64, host) of one cosmology."""
    return torch.tensor([float(getattr(ctx, n)) for n in HY_PARAMS], dtype=torch.float64)


def z_grid(zstart: float) -> np.ndarray:
    """The history's descending z grid, uniform in ln a (build_history)."""
    nz = int(np.floor(2 + np.log(1.0 + zstart) / DLNA))
    return (1.0 + zstart) * np.exp(-DLNA * np.arange(nz)) - 1.0


# --- elementary pieces (Python floats; every `**` is libm's pow) ------------


def hubble_s(p, z):
    """H(z) in s^-1 (history.c:69 rec_HubbleConstant); p: HY_PARAMS by name."""
    ai = 1.0 + z
    rho = (p["omh2"] * ai**3 + p["okh2"] * ai**2
           + p["odeh2"] * ai ** (3.0 * (1.0 + p["w0"]))
           * math.exp(3.0 * p["wa"] * (math.log(ai) - 1.0 + 1.0 / ai))
           + p["ogh2"] * ai**4 * (1.0 + p["onuh2_fac"]))
    return 3.2407792896393e-18 * math.sqrt(rho)


def _chi_heat(xe):
    """Fraction of injected energy into heat (Galli et al. 2013, history.c:111)."""
    if not xe < 1.0:
        return 1.0
    xc = xe if xe > 0.0 else 0.0
    fit = 0.996857 * (1.0 - (1.0 - xc**0.300134) ** 1.51035)
    return fit if fit < 1.0 else 1.0


def _chi_ion(xe):
    """Fraction into H ionization (hydrogen.c:58)."""
    if not xe < 1.0:
        return 0.0
    xc = xe if xe > 0.0 else 0.0
    return 0.369202 * (1.0 - xc**0.463929) ** 1.70237


def tm_ss(xe, Tr, H, fHe, nH, er):
    """Steady-state matter temperature, K (history.c:104 rec_Tmss); nH in
    cm^-3, er the injected energy rate in eV/cm^3/s."""
    Tr4 = Tr**4
    return Tr / (1.0 + H / 4.91466895548409e-22 / Tr4 * (1.0 + xe + fHe) / xe) \
        + 2.0 / 3.0 / KBOLTZ * _chi_heat(xe) / nH * er / (4.91466895548409e-22 * Tr4 * xe)


def dtm_dlna(xe, Tm, Tr, H, fHe, nH, er):
    """dTm/dlna, K (history.c:127 rec_dTmdlna)."""
    return -2.0 * Tm + 4.91466895548409e-22 * Tr**4 * xe / (1.0 + xe + fHe) * (Tr - Tm) / H \
        + 2.0 / 3.0 / KBOLTZ * _chi_heat(xe) / nH * er / (1.0 + xe + fHe) / H


def saha_xe_H(p, z):
    """Hydrogen Saha xe (helium.c:72 rec_saha_xe_H)."""
    ai = 1.0 + z
    Tr = p["T0"] * ai
    nH = p["nH0"] * ai**3
    s = 2.4127161187130e21 * Tr * math.sqrt(Tr) * math.exp(-157801.37882 / Tr) / nH
    return 2.0 / (1.0 + math.sqrt(1.0 + 4.0 / s))


def saha_HeII(p, z):
    """(xe, xHeIII) in HeII<->III equilibrium (helium.c:28 rec_sahaHeII)."""
    ai = 1.0 + z
    Tr = p["T0"] * ai
    nH = p["nH0"] * ai**3
    s = 2.414194e21 * Tr * math.sqrt(Tr) * math.exp(-631462.7 / Tr) / nH
    f = p["fHe"]
    xHeIII = 2.0 * s * f / (1.0 + s + f) / (1.0 + math.sqrt(1.0 + 4.0 * s * f / (1.0 + s + f) ** 2))
    return 1.0 + f + xHeIII, xHeIII


def saha_HeI(p, z):
    """xe in HeI<->II equilibrium (helium.c:50 rec_sahaHeI)."""
    ai = 1.0 + z
    Tr = p["T0"] * ai
    nH = p["nH0"] * ai**3
    s = 2.414194e21 * Tr * math.sqrt(Tr) * math.exp(-285325.0 / Tr) / nH * 4.0
    q = 2.0 * s * p["fHe"] / (1.0 + s) / (1.0 + math.sqrt(1.0 + 4.0 * s * p["fHe"] / (1.0 + s) ** 2))
    return 1.0 + q


def helium_dxedt(p, xe, H, z):
    """HeII->I recombination rate dxe/dt (helium.c:99 rec_helium_dxedt)."""
    exp, sqrt = math.exp, math.sqrt
    ai = 1.0 + z
    Tr = p["T0"] * ai
    nH = p["nH0"] * ai**3
    s0 = 2.414194e21 * Tr * sqrt(Tr) / nH * 4.0
    s = s0 * exp(-285325.0 / Tr)
    xHII = saha_xe_H(p, z)
    xHeII = xe - xHII
    xHeI = p["fHe"] - xHeII
    y2s = exp(46090.0 / Tr) / s0
    y2p = exp(39101.0 / Tr) / s0 * 3.0
    etacinv = H / (nH * nH * xe) * Tr * sqrt(Tr) * exp(115.920 - 157801.37882 / Tr)
    g2pinc = (1.976e6 / (1.0 - exp(-6989.0 / Tr))
              + 6.03e6 / (exp(19754.0 / Tr) - 1.0)
              + 1.06e8 / (exp(21539.0 / Tr) - 1.0)
              + 2.18e6 / (exp(28496.0 / Tr) - 1.0)
              + 3.37e7 / (exp(29224.0 / Tr) - 1.0)
              + 1.04e6 / (exp(32414.0 / Tr) - 1.0)
              + 1.51e7 / (exp(32781.0 / Tr) - 1.0))
    tau2p = 4.277e-14 * nH / H * xHeI
    dnuline = g2pinc * tau2p / (4.0 * math.pi**2)
    tauc = dnuline / etacinv
    enh = sqrt(1.0 + math.pi**2 * tauc) + 7.74 * tauc / (1.0 + 70.0 * tauc)
    pesc = enh / tau2p
    pesc = pesc + (1.0 - exp(-1.023e-7 * tau2p)) \
        * (0.964525 * exp(2947.0 / Tr) - enh * exp(-6.14e13 / etacinv)) / tau2p
    ydown = 50.94 * y2s + 1.7989e9 * y2p * pesc
    xdown = ydown * xHeII * xe
    xup = ydown * xHeI * s
    return xup - xdown + H * ai * (saha_xe_H(p, z - 0.5) - saha_xe_H(p, z + 0.5))


def _cubic_w(f):
    return ((f * (f - 1.0) * (2.0 - f) / 6.0), ((1.0 + f) * (1.0 - f) * (2.0 - f) / 2.0),
            ((1.0 + f) * f * (2.0 - f) / 2.0), ((1.0 + f) * f * (f - 1.0) / 6.0))


def _dot4(a, c):
    return ((a[0] * c[0] + a[1] * c[1]) + a[2] * c[2]) + a[3] * c[3]


_DLOGTR = (math.log(TR_MAX) - math.log(TR_MIN)) / (NTR - 1)
_DTMTR = (TM_TR_MAX - TM_TR_MIN) / (NTM - 1)
_LOG_TR_MIN = math.log(TR_MIN)


def interpolate_rates(tab, TR, TM_TR):
    """(Alpha[2], Beta[2], R2p2s) from the tabulated effective rates, 4-point
    cubic in TM/TR and log TR (hydrogen.c:137 interpolate_rates). tab: the
    host lists of `_host_tables`."""
    la, lr = tab["log_alpha"], tab["log_r2p2s"]
    x1 = (TM_TR - TM_TR_MIN) / _DTMTR
    iTM = min(max(int(math.floor(x1)), 1), NTM - 3)
    c1 = _cubic_w(x1 - iTM)
    x2 = (math.log(TR) - _LOG_TR_MIN) / _DLOGTR
    iTR = min(max(int(math.floor(x2)), 1), NTR - 3)
    c2 = _cubic_w(x2 - iTR)
    Alpha, Beta = [], []
    for lev in range(2):
        temp = [_dot4(la[lev][iTM - 1 + jj][iTR - 1: iTR + 3], c2) for jj in range(4)]
        Alpha.append(math.exp(_dot4(temp, c1)))
        Beta.append(math.exp(_dot4(la[lev][NTM - 1][iTR - 1: iTR + 3], c2)))
    factor = 3.016103031869581e21 * TR * math.sqrt(TR) * math.exp(-3.399571517984581 / TR)
    Beta = [Beta[0] * factor, Beta[1] * (factor / 3.0)]
    R2p2s = math.exp(_dot4(lr[iTR - 1: iTR + 3], c2))
    return Alpha, Beta, R2p2s


def hmla_dxedlna(tab, xe, nH, H, TM, TR, er):
    """Steady-state 2s/2p EMLA with Sobolev Ly-alpha, no feedback
    (hydrogen.c:218 rec_HMLA_dxedlna); nH in cm^-3, TM and TR in eV."""
    Alpha, Beta, R2p2s = interpolate_rates(tab, TR, TM / TR)
    x1s_db = (1.0 - xe) * math.exp(-E21 / TR)
    RLya = 4.662899067555897e15 * H / nH / (1.0 - xe)
    m00 = Beta[0] + 3.0 * R2p2s + L2S1S
    m01 = -R2p2s
    b0 = xe * xe * nH * Alpha[0] + L2S1S * x1s_db
    m11 = Beta[1] + R2p2s + RLya
    m10 = -3.0 * R2p2s
    b1 = xe * xe * nH * Alpha[1] + 3.0 * RLya * x1s_db
    det = m00 * m11 - m01 * m10
    x2s = (m11 * b0 - m01 * b1) / det
    x2p = (m00 * b1 - m10 * b0) / det
    C_2p = (RLya + R2p2s * L2S1S / m00) / (m11 - R2p2s * 3.0 * R2p2s / m00)
    inj = _chi_ion(xe) / nH * er * (1.0 / EI + (1.0 - C_2p) / E21)
    return (x1s_db * (L2S1S + 3.0 * RLya) - x2s * L2S1S - x2p * RLya + inj) / H


def peebles_dxedlna(xe, nH, H, TM, TR, fudge, er):
    """Peebles effective 3-level rate (hydrogen.c:45); fudge 1.14 is
    rec_HRecFast_dxedlna (hydrogen.c:72). nH in cm^-3, T in eV."""
    t4 = TM / KBOLTZ / 1e4
    alphaB = fudge * 4.309e-13 * t4 ** (-0.6166) / (1.0 + 0.6703 * t4**0.5300)
    RLya = 4.662899067555897e15 * H / nH / (1.0 - xe)
    four_betaB = 3.016103031869581e21 * TR * math.sqrt(TR) * math.exp(-0.25 * EI / TR) * alphaB
    C = (3.0 * RLya + L2S1S) / (3.0 * RLya + L2S1S + four_betaB)
    inj = _chi_ion(xe) / nH * er * (1.0 / EI + (1.0 - C) / E21)
    return (-nH * xe * xe * alphaB
            + four_betaB * (1.0 - xe) * math.exp(-E21 / TR)) * C / H + inj / H


# --- the two-photon radiative-transfer core (model "full") -----------------


def _map(fn, t: torch.Tensor) -> torch.Tensor:
    """fn (libm's exp or log, as the kernel's host build calls them) on every
    element of a host float64 vector."""
    return torch.from_numpy(np.fromiter(map(fn, t.tolist()), dtype=np.float64, count=t.numel()))


def _tree_sum(v: torch.Tensor) -> list:
    """Sums of the rows of v (k, NVIRT) in the kernel's block-reduction
    order: 32-value halving trees over consecutive chunks of each row padded
    with zeros to NPAD, then a 16-value halving tree over the NWARP chunk
    sums."""
    c = torch.nn.functional.pad(v, (0, NPAD - v.shape[1])).reshape(v.shape[0], NWARP, 32)
    while c.shape[-1] > 1:
        n = c.shape[-1] // 2
        c = c[..., :n] + c[..., n:]
    c = torch.nn.functional.pad(c[..., 0], (0, 16 - NWARP))
    while c.shape[-1] > 1:
        n = c.shape[-1] // 2
        c = c[..., :n] + c[..., n:]
    return c[:, 0].tolist()


def _fplus(tab, ring, m):
    """All photon-history reads of one evaluation (fplus_from_fminus,
    hydrogen.c:600): the ring at fixed lookbacks, cubic in log f^-. ring:
    (RING, NROW) log f^-; rows < m are the history. Returns (NSPEC,)."""
    w = tab["read_w"]
    v = [ring[(m - tab["read_off"] - 1 + k) % RING, tab["read_src"]] for k in range(4)]
    return _map(math.exp, ((v[0] * w[:, 0] + v[1] * w[:, 1]) + v[2] * w[:, 2]) + v[3] * w[:, 3])


def _diffusion_rates(tab, TM):
    """A_{b,b+-1} diffusion rates in the Ly-alpha wings (populate_Diffusion,
    hydrogen.c:336): two sequential detailed-balance recurrences. Returns
    (Aup, Adn) as (NVIRT,) tensors and (A2p_up, A2p_dn)."""
    Eb, A1s = tab["Eb"], tab["A1s"]
    exp = math.exp
    DE2 = E21 * E21 * 2.0 * TM / MH_EV
    Aup = [0.0] * NVIRT
    Adn = [0.0] * NVIRT
    # red wing: b = NSUBDIFF .. NSUBLYA-1, upward
    b0 = NSUBDIFF
    d = Eb[b0 + 1] - Eb[b0]
    aup = DE2 / (d * d) * A1s[b0]
    Aup[b0] = aup
    for b in range(b0 + 1, NSUBLYA):
        dEdn = Eb[b] - Eb[b - 1]
        dEup = Eb[b + 1] - Eb[b] if b < NSUBLYA - 1 else E21 - Eb[b]
        adn = exp(dEdn / TM) * aup
        aup = (DE2 * A1s[b] - dEdn * dEdn * adn) / (dEup * dEup)
        Aup[b], Adn[b] = aup, adn
    A2p_dn = exp((E21 - Eb[NSUBLYA - 1]) / TM) / 3.0 * aup
    # blue wing: b = NSUBLYA .. NSUBLYA+NDIFF/2-1, downward
    b1 = NSUBLYA + NDIFF // 2 - 1
    d = Eb[b1] - Eb[b1 - 1]
    adn = DE2 / (d * d) * A1s[b1]
    Adn[b1] = adn
    for b in range(b1 - 1, NSUBLYA - 1, -1):
        dEup = Eb[b + 1] - Eb[b]
        dEdn = Eb[b] - Eb[b - 1] if b > NSUBLYA else Eb[b] - E21
        aup = exp(-dEup / TM) * adn
        adn = (DE2 * A1s[b] - dEup * dEup * aup) / (dEdn * dEdn)
        Aup[b], Adn[b] = aup, adn
    A2p_up = exp((E21 - Eb[NSUBLYA]) / TM) / 3.0 * adn
    f64 = torch.float64
    return torch.tensor(Aup, dtype=f64), torch.tensor(Adn, dtype=f64), A2p_up, A2p_dn


def _thomas3(diag, up, dn, rhs):
    """Thomas solve of a diagonally dominant tridiagonal system (lists) for
    three right-hand sides (solveTXeqB, hydrogen.c:510)."""
    n = len(diag)
    r0, r1, r2 = rhs
    alpha, g0, g1, g2 = [0.0] * n, [0.0] * n, [0.0] * n, [0.0] * n
    ap = p0 = p1 = p2 = 0.0
    for i in range(n):
        d, l = diag[i] - dn[i] * ap, dn[i]
        ap = up[i] / d
        p0, p1, p2 = (r0[i] - l * p0) / d, (r1[i] - l * p1) / d, (r2[i] - l * p2) / d
        alpha[i], g0[i], g1[i], g2[i] = ap, p0, p1, p2
    x0, x1, x2 = [0.0] * n, [0.0] * n, [0.0] * n
    q0 = q1 = q2 = 0.0
    for i in range(n - 1, -1, -1):
        a = alpha[i]
        q0, q1, q2 = g0[i] - a * q0, g1[i] - a * q1, g2[i] - a * q2
        x0[i], x1[i], x2[i] = q0, q1, q2
    return x0, x1, x2


def twophoton_dxedlna(tab, xe, nH, H, TM, TR, ring, m, er):
    """Full two-photon + diffusion dxe/dlna (rec_HMLA_2photon_dxedlna,
    hydrogen.c:663) and the new log f^- row for slot m (hydrogen.c:730-749);
    nH in cm^-3, TM and TR in eV, the per-bin quantities (NVIRT,) tensors.
    Returns (dxedlna, row (NROW,))."""
    exp, log = math.exp, math.log
    Eb, A2s, A3s3d, A4s4d = tab["Eb_t"], tab["A2s_t"], tab["A3s3d_t"], tab["A4s4d_t"]
    fp = _fplus(tab, ring, m)
    fplus, (fLy0, fLy1) = fp[:NVIRT], fp[NVIRT:].tolist()
    Alpha, Beta, R2p2s = interpolate_rates(tab, TR, TM / TR)
    RLya = 4.662899067555897e15 * H / nH / (1.0 - xe)
    e32, e42 = exp(-E32 / TR), exp(-E42 / TR)

    # real-real block and sources (populateTS_2photon, hydrogen.c:391)
    Trr00 = Beta[0] + 3.0 * R2p2s + 3.0 * RLya * (1.664786871919931 * e32 + 1.953125 * e42)
    Trr01 = -R2p2s
    sr0 = nH * Alpha[0] * xe * xe \
        + 3.0 * RLya * (1.0 - xe) * (1.664786871919931 * fLy1 + 1.953125 * exp(-E41 / TR))
    Trr11 = Beta[1] + R2p2s + RLya
    Trr10 = -3.0 * R2p2s
    sr1 = nH * Alpha[1] * xe * xe + 3.0 * RLya * (1.0 - xe) * fLy0

    dbfact = _map(exp, (Eb - E21) / TR)
    Tvr0 = -A2s / torch.abs(dbfact - 1.0)
    Trv0 = Tvr0 * dbfact
    Tvr1 = (-e32 / 3.0 * A3s3d / torch.abs(_map(exp, (Eb - E31) / TR) - 1.0)
            - e42 / 3.0 * A4s4d / torch.abs(_map(exp, (Eb - E41) / TR) - 1.0))
    Trv1 = Tvr1 * 3.0 * dbfact
    sums_T = (Tvr0, Tvr1)                   # summed before the corrections below

    Aup, Adn, A2p_up, A2p_dn = _diffusion_rates(tab, TM)
    # Gamma_b from the rows before the Ly-a-neighbour corrections (hydrogen.c:457)
    gamma = -(Trv0 + Trv1) + Aup + Adn
    lo, hi, ly = NSUBDIFF, NSUBLYA + NDIFF // 2, NSUBLYA
    Tvv1 = torch.zeros(NVIRT, dtype=torch.float64)       # T_{b,b-1}
    Tvv2 = torch.zeros(NVIRT, dtype=torch.float64)       # T_{b,b+1}
    Tvv1[lo:hi] = -Aup[lo - 1:hi - 1]
    Tvv2[lo:hi] = -Adn[lo + 1:hi + 1]
    Tvv1[ly] = 0.0
    Tvv2[ly - 1] = 0.0
    Tvr1, Trv1 = Tvr1.clone(), Trv1.clone()
    Tvr1[ly - 1] = Tvr1[ly - 1] - A2p_dn
    Trv1[ly - 1] = Trv1[ly - 1] - Aup[ly - 1]
    Tvr1[ly] = Tvr1[ly] - A2p_up
    Trv1[ly] = Trv1[ly] - Adn[ly]
    dtau = gamma * (1.0 - xe) * tab["cube"] * nH / 8.0 / math.pi / H
    thick = dtau > 1e-30
    Dt = torch.where(thick, dtau, 1.0)
    one_m_emD = 1.0 - _map(exp, -Dt)
    Pib = one_m_emD / Dt
    Tvv0 = torch.where(thick, gamma / (1.0 - Pib), 1.0)
    Trv0, Trv1, Tvr0, Tvr1 = (torch.where(thick, v, 0.0) for v in (Trv0, Trv1, Tvr0, Tvr1))
    sv = torch.where(thick, Tvv0 * (1.0 - xe) * fplus * Pib, (1.0 - xe) * fplus)

    # solve the real + virtual system (solve_real_virt, hydrogen.c:534):
    # diagonal outside the diffusion window, Thomas inside, 2x2 Schur after
    sl = slice(NSUBDIFF, NSUBDIFF + NDIFF)
    sol = _thomas3(Tvv0[sl].tolist(), Tvv2[sl].tolist(), Tvv1[sl].tolist(),
                   (Tvr0[sl].tolist(), Tvr1[sl].tolist(), sv[sl].tolist()))
    inv0, inv1, invs = Tvr0 / Tvv0, Tvr1 / Tvv0, sv / Tvv0
    for v, x in zip((inv0, inv1, invs), sol):
        v[sl] = torch.tensor(x, dtype=torch.float64)
    s = _tree_sum(torch.stack([*sums_T, Trv0 * inv0, Trv0 * inv1, Trv1 * inv0, Trv1 * inv1,
                               Trv0 * invs, Trv1 * invs]))
    Trr_new00 = (Trr00 - s[0]) - s[2]
    Trr_new01 = Trr01 - s[3]
    Trr_new10 = Trr10 - s[4]
    Trr_new11 = ((Trr11 - s[1]) + A2p_dn + A2p_up) - s[5]
    sr_new0 = sr0 - s[6]
    sr_new1 = sr1 - s[7]
    det = Trr_new00 * Trr_new11 - Trr_new01 * Trr_new10
    xr0 = (Trr_new11 * sr_new0 - Trr_new01 * sr_new1) / det
    xr1 = (Trr_new00 * sr_new1 - Trr_new10 * sr_new0) / det
    xv = invs - inv0 * xr0 - inv1 * xr1

    # DM injection (hydrogen.c:714-727): C_2p from the base 2x2 blocks
    m00 = Beta[0] + 3.0 * R2p2s + L2S1S
    C_2p = (RLya + R2p2s * L2S1S / m00) / (Beta[1] + R2p2s + RLya - R2p2s * 3.0 * R2p2s / m00)
    xedot = -nH * xe * xe * (Alpha[0] + Alpha[1]) + xr0 * Beta[0] + xr1 * Beta[1] \
        + _chi_ion(xe) / nH * er * (1.0 / EI + (1.0 - C_2p) / E21)

    # the new f^- row (hydrogen.c:730-749)
    zero = torch.zeros(1, dtype=torch.float64)
    xv_up, xv_dn = torch.cat([xv[1:], zero]), torch.cat([zero, xv[:-1]])
    feq = -xr0 * Tvr0 - xr1 * Tvr1 - (xv_up * Tvv2 + xv_dn * Tvv1)
    feq = feq / ((1.0 - xe) * (1.0 - Pib) * Tvv0)
    row = torch.empty(NROW, dtype=torch.float64)
    row[:NVIRT] = _map(log, torch.where(thick, fplus + (feq - fplus) * one_m_emD, fplus))
    lr0 = log(xr0 / (1.0 - xe))
    row[NVIRT:] = torch.tensor([log(xr1 / 3.0 / (1.0 - xe)), lr0 - E32 / TR, lr0 - E42 / TR],
                               dtype=torch.float64)
    return xedot / H, row


# --- the staged history ----------------------------------------------------


def _host_tables(tables: HyrecTables) -> dict:
    """The tables as host lists (scalar code) and tensors (per-bin code)."""
    t = tables.to("cpu")
    twog = t.twog.tolist()
    return dict(log_alpha=t.log_alpha.tolist(), log_r2p2s=t.log_r2p2s.tolist(),
                Eb=twog[0], A1s=twog[1], Eb_t=t.twog[0], A2s_t=t.twog[2], A3s3d_t=t.twog[3],
                A4s4d_t=t.twog[4], cube=torch.tensor([(HPC / e) ** 3 for e in twog[0]],
                                                     dtype=torch.float64),
                read_src=t.read_src.long(), read_off=t.read_off.long(), read_w=t.read_w)


def hyrec_history_plain(hp: torch.Tensor, tables: HyrecTables, z: torch.Tensor,
                        inj, model: str, phase_starts=None):
    """Plain version of `hyrec_history`: the staged history (build_history,
    hyrec.py:574-751) as a host loop. hp: the HY_PARAMS vector; z: the
    descending grid (nz,) of `z_grid`; inj: the injection rate [eV/cm^3/s]
    on that grid or None. Returns (xe, Tm), (nz,) each.

    Phases: He Saha -> He post-Saha -> He evolution -> H post-Saha -> H
    with Tm quasi-steady -> H with Tm evolved -> (full model: HMLA ->
    Peebles) ; every evolution step is the reference's two-step
    xe + dlna (1.25 f_n - 0.25 f_{n-2}). In the recfast model every hydrogen
    rate is rec_HRecFast_dxedlna and the photon ring is never read.
    phase_starts: a list that receives (phase, first step) of every phase."""
    if model not in MODELS:
        raise ValueError(f"hyrec_history: model {model!r} is not one of {MODELS}")
    p = dict(zip(HY_PARAMS, hp.tolist()))
    tab = _host_tables(tables)
    zg = z.tolist()
    nz = len(zg)
    er_tab = inj.tolist() if inj is not None else None
    full = model == "full"
    T0, nH0, fHe = p["T0"], p["nH0"], p["fHe"]
    exp, sqrt = math.exp, math.sqrt
    ring = torch.full((RING, NROW), -1.0, dtype=torch.float64) if full else None
    levels = torch.cat([tab["Eb_t"], torch.tensor([E21, E31, E41], dtype=torch.float64)])

    def thermal(slot, Tr_eV):
        ring[slot % RING] = -levels / Tr_eV

    def h_rate(xe_v, nH_v, H_v, TM_v, TR_v, m, er_v):
        """Hydrogen rate of the model (history.c:144-177); in the full model
        writes the new f^- row to slot m."""
        if full:
            d, row = twophoton_dxedlna(tab, xe_v, nH_v, H_v, TM_v, TR_v, ring, m, er_v)
            ring[m % RING] = row
            return d
        return peebles_dxedlna(xe_v, nH_v, H_v, TM_v, TR_v, 1.14, er_v)

    xe = saha_HeII(p, zg[0])[0]
    Tm = T0 * (1.0 + zg[0])
    xe_out, Tm_out = [xe], [Tm]
    phase = PH_HE_SAHA
    dxe_p = dxe_p2 = dTm_p = dTm_p2 = 0.0
    Hp = hubble_s(p, zg[0])
    for j in range(1, nz):
        z, zp = zg[j], zg[j - 1]
        ai = 1.0 + z
        Tr_K = T0 * ai
        H = hubble_s(p, z)
        nH_cm = nH0 * ai**3 * 1e-6
        Tr_eV = Tr_K * KBOLTZ
        aip = 1.0 + zp
        nHp_cm = nH0 * aip**3 * 1e-6
        Trp_K = T0 * aip
        Trp_eV = Trp_K * KBOLTZ
        er = er_tab[j] if er_tab is not None else 0.0
        erp = er_tab[j - 1] if er_tab is not None else 0.0

        if phase <= PH_H2G_TMSS:
            # no Tm evolution yet: the Tm derivative history is primed with
            # the current steady-state derivative
            if phase == PH_HE_SAHA:
                xe_new, xHeIII = saha_HeII(p, z)
                Tm_new = Tr_K
                done = xHeIII <= 1e-9
            elif phase == PH_HE_POSTSAHA:
                xeS = saha_HeI(p, z)
                nH = nH0 * ai**3
                s = 2.414194e21 * Tr_K * sqrt(Tr_K) * exp(-285325.0 / Tr_K) / nH * 4.0
                dxeSdt = -xeS * (xeS - 1.0) / (2.0 * xeS + s - 1.0) * (285325.0 / Tr_K - 1.5) * H
                Dxe = 0.01 * (1.0 + fHe - xeS)
                dd = (helium_dxedt(p, xeS + Dxe, H, z) - helium_dxedt(p, xeS - Dxe, H, z)) \
                    / (2.0 * Dxe)
                delta = dxeSdt / dd
                xe_new = xeS + delta
                Tm_new = Tr_K
                done = delta >= 5e-4
            elif phase == PH_HE_EVOL:
                dxe = helium_dxedt(p, xe, Hp, zp) / Hp
                xe_new = xe + DLNA * (1.25 * dxe - 0.25 * dxe_p2)
                Tm_new = tm_ss(xe_new, Tr_K, H, fHe, nH_cm, er)
                done = abs(xe_new - saha_xe_H(p, z)) <= 1e-4 and z <= 1650.0
            elif phase == PH_H_POSTSAHA:
                nH = nH0 * ai**3
                s = 2.4127161187130e21 * Tr_K * sqrt(Tr_K) * exp(-157801.37882 / Tr_K) / nH
                xeS = 2.0 / (1.0 + sqrt(1.0 + 4.0 / s))
                dxeS = -(EI / Tr_eV - 1.5) / (2.0 * xeS + s) * xeS * xeS
                eps = 0.01 * (1.0 - xeS)
                d_hi = h_rate(xeS + eps, nH_cm, H, Tr_eV, Tr_eV, j, er)
                d_lo = h_rate(xeS - eps, nH_cm, H, Tr_eV, Tr_eV, j, er)
                delta = dxeS / ((d_hi - d_lo) / (2.0 * eps))
                xe_new = xeS + delta
                Tm_new = tm_ss(xe_new, Tr_K, H, fHe, nH_cm, er)
                done = delta >= 5e-5
            else:                                   # PH_H2G_TMSS
                Tmp = tm_ss(xe, Trp_K, Hp, fHe, nHp_cm, erp)
                dxe = h_rate(xe, nHp_cm, Hp, Tmp * KBOLTZ, Trp_eV, j - 1, erp)
                xe_new = xe + DLNA * (1.25 * dxe - 0.25 * dxe_p2)
                Tm_new = tm_ss(xe_new, Tr_K, H, fHe, nH_cm, er)
                done = 1.0 - Tm_new / Tr_K >= 5e-4 or z <= 700.0
            if full and phase < PH_H_POSTSAHA:
                thermal(j, Tr_eV)
            if phase in (PH_HE_EVOL, PH_H2G_TMSS):
                dxe_n, dxe_n2 = dxe, dxe_p
            else:
                # the AB2 history seeded by a finite difference
                # (history.c:281-287)
                dxe_n, dxe_n2 = (xe_new - xe) / DLNA, dxe_p
            dTm_n = dtm_dlna(xe_new, Tm_new, Tr_K, H, fHe, nH_cm, er)
            dTm_n2 = dTm_p
        else:
            if phase == PH_H2G_TM:
                dxe = h_rate(xe, nHp_cm, Hp, Tm * KBOLTZ, Trp_eV, j - 1, erp)
                done = z <= 700.0
            elif phase == PH_HMLA:
                dxe = (hmla_dxedlna(tab, xe, nHp_cm, Hp, Tm * KBOLTZ, Trp_eV, erp) if full
                       else peebles_dxedlna(xe, nHp_cm, Hp, Tm * KBOLTZ, Trp_eV, 1.14, erp))
                done = z <= 20.0
            else:                                   # PH_PEEBLES
                dxe = peebles_dxedlna(xe, nHp_cm, Hp, Tm * KBOLTZ, Trp_eV,
                                      1.0 if full else 1.14, erp)
                done = False
            dTm = dtm_dlna(xe, Tm, Trp_K, Hp, fHe, nHp_cm, erp)
            xe_new = xe + DLNA * (1.25 * dxe - 0.25 * dxe_p2)
            Tm_new = Tm + DLNA * (1.25 * dTm - 0.25 * dTm_p2)
            dxe_n, dxe_n2, dTm_n, dTm_n2 = dxe, dxe_p, dTm, dTm_p
        if done and phase < PH_PEEBLES:
            phase += 1
            if phase_starts is not None:
                phase_starts.append((phase, j + 1))
        xe, Tm = xe_new, Tm_new
        dxe_p, dxe_p2, dTm_p, dTm_p2 = dxe_n, dxe_n2, dTm_n, dTm_n2
        Hp = H
        xe_out.append(xe)
        Tm_out.append(Tm)
    return (torch.tensor(xe_out, dtype=torch.float64),
            torch.tensor(Tm_out, dtype=torch.float64))


def hyrec_history(hp: torch.Tensor, tables: HyrecTables, z: torch.Tensor, inj,
                  model: str):
    """(xe, Tm) on the history's z grid: the kernel hyrec_history
    (csrc/hyrec.cu) for CUDA tensors, the plain loop for CPU tensors. hp, the
    tables, z and inj (or None) all on one device."""
    global launches
    dev = hp.device
    if dev.type == "cpu":
        return hyrec_history_plain(hp, tables, z, inj, model)
    if dev.type != "cuda":
        raise ValueError(f"hyrec_history: unsupported device {dev}")
    if model not in MODELS:
        raise ValueError(f"hyrec_history: model {model!r} is not one of {MODELS}")
    nz = z.shape[0]
    shapes = {"hp": (hp, (len(HY_PARAMS),)), "z": (z, (nz,)),
              "log_alpha": (tables.log_alpha, (2, NTM, NTR)),
              "log_r2p2s": (tables.log_r2p2s, (NTR,)), "twog": (tables.twog, (5, NVIRT)),
              "read_w": (tables.read_w, (NSPEC, 4))}
    if inj is not None:
        shapes["inj"] = (inj, (nz,))
    for name, (t, shape) in shapes.items():
        if tuple(t.shape) != shape or t.dtype != torch.float64 or not t.is_contiguous() \
                or t.device != dev:
            raise ValueError(f"hyrec_history: {name} must be {shape} contiguous float64 on {dev}")
    for name, t in (("read_src", tables.read_src), ("read_off", tables.read_off)):
        if tuple(t.shape) != (NSPEC,) or t.dtype != torch.int32 or t.device != dev:
            raise ValueError(f"hyrec_history: {name} must be ({NSPEC},) int32 on {dev}")
    lib = cuda.library()
    xe = torch.empty(nz, dtype=torch.float64, device=dev)
    Tm = torch.empty(nz, dtype=torch.float64, device=dev)
    full = model == "full"
    ring = torch.full((RING, NROW) if full else (1,), -1.0, dtype=torch.float64, device=dev)
    zt = torch.empty((nz, NZCOL), dtype=torch.float64, device=dev)
    params = (ctypes.c_double * len(HY_PARAMS))(*hp.tolist())
    err = lib.hyrec_history_launch(
        params, tables.log_alpha.data_ptr(), tables.log_r2p2s.data_ptr(),
        tables.twog.data_ptr(), tables.read_src.data_ptr(), tables.read_off.data_ptr(),
        tables.read_w.data_ptr(), z.data_ptr(), int(nz),
        inj.data_ptr() if inj is not None else None, int(full), ring.data_ptr(), zt.data_ptr(),
        xe.data_ptr(), Tm.data_ptr(), cuda.stream_ptr(dev))
    cuda.check(err, "hyrec_history")
    launches += 1
    return xe, Tm


def _cubic_resample(ytab, x0, dx, x):
    """4-point cubic Lagrange on a uniform grid at the points x
    (array_interpolate_cubic_equal / rec_interp1d)."""
    n = ytab.shape[0]
    raw = (x - x0) / dx
    ix = torch.clamp(torch.floor(raw).long(), 1, n - 3)
    f = raw - ix
    w = torch.stack([-f * (1.0 - f) * (2.0 - f) / 6.0, (1.0 + f) * (1.0 - f) * (2.0 - f) / 2.0,
                     (1.0 + f) * f * (2.0 - f) / 2.0, (1.0 + f) * f * (f - 1.0) / 6.0], dim=-1)
    idx = ix[:, None] - 1 + torch.arange(4)[None, :]
    return torch.sum(ytab[idx] * w, dim=-1)


def hyrec_injection_grid(params, ctx: HyrecCtx, zstart: float) -> np.ndarray:
    """DM energy-injection rate [eV/cm^3/s] on the history's z grid
    (energy_injection_rate, hyrec/history.c:380-470): the on-the-spot rate
    from annihilation (variation and halo terms) and decay, convolved with
    the deposition kernel when 'on the spot = no' (trapezoid in z' with
    dz = 1, each step added before its integrand/first ratio is tested
    against 0.02). Host numpy, in blocks of rows of the grid (the (rows,
    2048) arrays of the whole grid would take gigabytes)."""
    z = z_grid(zstart)
    nz = z.shape[0]
    ann, dec = params.annihilation, params.decay

    def onthespot(zv):
        if params.annihilation_variation == 0.0:
            ann_at_z = ann
        else:
            lo = np.log((1.0 + params.annihilation_z) / (1.0 + params.annihilation_zmax))
            lmin = np.log((1.0 + params.annihilation_zmin) / (1.0 + params.annihilation_zmax))
            lz = np.log((1.0 + zv) / (1.0 + params.annihilation_zmax))
            mid = np.exp(params.annihilation_variation * (lz**2 - lo**2))
            hi = np.exp(params.annihilation_variation * (-lo**2))
            lo_b = np.exp(params.annihilation_variation * (lmin**2 - lo**2))
            ann_at_z = ann * np.where(zv > params.annihilation_zmax, hi,
                                      np.where(zv > params.annihilation_zmin, mid, lo_b))
        rho_cdm = ctx.omh2 * 1.44729366e-9                     # kg/m^3
        u_min = (1.0 + zv) / (1.0 + params.annihilation_z_halo)
        erfc = (1.0 + 0.278393 * u_min + 0.230389 * u_min**2
                + 0.000972 * u_min**3 + 0.078108 * u_min**4) ** (-4)
        c2 = 2.99792458e8 ** 2
        return (rho_cdm**2 / c2 * (1.0 + zv) ** 3
                * ((1.0 + zv) ** 3 * ann_at_z + params.annihilation_f_halo * erfc)
                + rho_cdm * (1.0 + zv) ** 3 * dec) / 1.0e6 / 1.60217653e-19

    if ann <= 0.0 or params.on_the_spot:
        return onthespot(z) if (ann > 0.0 or dec > 0.0) else np.zeros(nz)

    factor = 2.99792458e8 * 6.6524616e-29 * ctx.nH0 / (3.2407792896393e-18 * np.sqrt(ctx.omh2))
    NP, chunk = 2048, 2048
    out = np.empty(nz)
    for a in range(0, nz, chunk):
        zc = z[a:a + chunk, None]
        zp = zc + np.arange(NP)[None, :] * 1.0                # dz = 1
        kern = factor * (1.0 + zc) ** 8 / (1.0 + zp) ** 7.5 \
            * np.exp(2.0 / 3.0 * factor * ((1.0 + zc) ** 1.5 - (1.0 + zp) ** 1.5)) * onthespot(zp)
        ratio = kern / kern[:, :1]
        keep = np.concatenate([np.ones((zc.shape[0], 1), bool),
                               np.cumprod(ratio[:, :-1] > 0.02, axis=1).astype(bool)], axis=1)
        w = np.where(keep, 1.0, 0.0)
        w[:, 0] = 0.5
        out[a:a + chunk] = np.sum(w * kern, axis=1)
    return out


def compute_recombination_hyrec(params, pr, rec_ctx, bg, model="recfast", device="cpu"):
    """The recombination table (RecoTable) from the HyRec history, resampled
    to the recfast_Nz0 grid as thermodynamics_recombination_with_hyrec
    (thermodynamics_module.cpp:3199-3278), H from the background spline.
    The history runs on `device`; the rest on the host."""
    from .thermodynamics import RecoTable

    dev = torch.device(device)
    zstart = pr.recfast_z_initial
    ctx = make_hyrec_ctx(params, bg, rec_ctx.YHe, params.N_eff, pr=pr)
    zg = torch.as_tensor(z_grid(zstart))
    inj = None
    if params.annihilation > 0.0 or params.decay > 0.0:
        inj = torch.as_tensor(hyrec_injection_grid(params, ctx, zstart)).to(dev)
    xe_hi, Tm_hi = (v.cpu() for v in hyrec_history(
        hyrec_params(ctx).to(dev), ctx.tables.to(dev), zg.to(dev), inj, model))

    Nz = pr.recfast_Nz0
    i = torch.arange(Nz, dtype=torch.float64)
    z = zstart * (1.0 - (i + 1.0) / Nz)
    lna = -torch.log1p(z)
    lna0 = -math.log(1.0 + zstart)
    xe = _cubic_resample(xe_hi, lna0, DLNA, lna)
    Tm = _cubic_resample(Tm_hi, lna0, DLNA, lna)
    Hz = rec_ctx.H_of_z.eval(-torch.log1p(z))[:, 0] * const.c_SI / const.Mpc_over_m
    Tr = ctx.T0 * (1.0 + z)
    YHe = rec_ctx.YHe
    wb = const.k_B / (const.c_SI**2 * const.m_H) \
        * (1.0 + (1.0 / const.not4 - 1.0) * YHe + xe * (1.0 - YHe)) * Tm
    dTm = -2.0 * Tm + 4.91466895548409e-22 * Tr**4 * xe / (1.0 + xe + ctx.fHe) * (Tr - Tm) / Hz
    cb2 = wb * (1.0 - dTm / Tm / 3.0)
    dkap = (1.0 + z) ** 2 * rec_ctx.Nnow * xe * const.sigma_T * const.Mpc_over_m
    return RecoTable(*(v.flip(0) for v in (z, xe, Tm, wb, cb2, dkap)))

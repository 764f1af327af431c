#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port once on one NVIDIA card.

Runs twenty-eight configurations through `classpp_public_torch.Class(device="cuda")`,
stage by stage, at full width and depth, the thermodynamics of a seventeenth
and the tensor stage of an eighteenth:

- `planck_row2`: flat LambdaCDM with massless neutrinos, lensed TT/TE/EE/phiphi
  to l = 2500 plus P(k) to k = 10/Mpc;
- `row2_exact`: the base_2018_plikHM_TTTEEE_lowl_lowE_lensing parameter set,
  with one 0.06 eV massive-neutrino species and halofit (P(k) to 20/Mpc);
- `g3_tensor`: tests/golden/gen/g3_tensor.ini, scalar and tensor modes
  (r = 0.1, primordial B-modes to l = 500), lensed TT/EE/BB to l = 2500;
- `g8_curved` and `g18_closed`: tests/golden/gen/g8_curved.ini (open,
  Omega_k = 0.01) and g18_closed.ini (closed, Omega_k = -0.01), scalars and
  tensors, lensed C_l to l = 2500, P(k) to 1/Mpc;
- the thermodynamics variants, each its golden's .ini uncut: `g5_hyrec`
  (recombination = HyRec, lensed C_l to 2500, P(k) to 10/Mpc),
  `g16_injection` and `g22_injection_bos` (DM annihilation on the spot and
  beyond it), `g11a_reio_bins` and `g11b_reio_manytanh` (binned and many-tanh
  reionization), the last four with lensed C_l to l = 1200;
- `hyrec_full`: g5_hyrec's cosmology through the two-photon HyRec model, the
  thermodynamics stage only (no golden holds it);
- `planck_row2_ss005`: planck_row2 at perturb_sampling_stepsize 0.05 (1179 tau
  samples, more than the 1024 a pass of the LOS scans holds);
- `ncdm_row3` (bench.py:62-69): three massive-neutrino species, held to its
  probe row;
- the number counts and galaxy lensing: `g19_ncl_full` (nCl,sCl, two Gaussian
  bins, every contribution, galaxy and magnification bias), `g27_pd` (CMB x
  number counts: phi-dens and T-dens) and `nc_des_y1` (the five DES Y1
  redMaGiC lens bins, every contribution and bin pair, l_max_lss 1000);
- `g32_texact`: tests/golden/gen/g32_texact.ini, tensor method exact with one
  0.06 eV ncdm species (its Psi_l(q) hierarchy in the tensor integrator),
  lensed TT/EE/BB, l_max_scalars 1200, l_max_tensors 500;
- `texact_ncdm3`: g32_texact with ncdm_row3's three species, the tensor stage
  alone (a 896-wide tensor state: 65 KB of shared memory a lane, above the
  48 KB a launch gets by default);
- the Newtonian gauge (the Newtonian instance of perturb_ark): `g9_newt`
  (tests/golden/gen/g9_newt.ini: flat LambdaCDM, lensed to l = 2500, P(k) to
  10/Mpc), and `row2_newt`, `g8_newt` and `g18_newt`, row2_exact, g8_curved
  and g18_closed with `gauge = newtonian`;
- the isocurvature initial conditions (an initial-condition branch of
  perturb_ark; all the modes of a point in one launch): `g21_isocorr`
  (tests/golden/gen/g21_isocorr.ini: ad, cdi and nid, correlated, lensed to
  l = 2500), `g21_newt` (the same in the Newtonian gauge), `g31_peric`
  (g31_peric.ini: ad and cdi, tCl, pCl, P(k) to 1/Mpc) and `row2_iso`
  (row2_exact with ad, bi and niv: one ncdm species and halofit);
- HMcode-2016: `g6_hmcode` (tests/golden/gen/g6_hmcode.ini: mPk only, P(k) to
  20/Mpc at z = 0, 1, 3) and `row2_hmcode` (row2_exact with `non linear =
  hmcode` and c_min = 2.6: the HMcode ratio on the phi+psi source of its
  lensed C_l; its perturbations are row2_exact's);
- scalar-field dark energy: `g13_scf` (tests/golden/gen/g13_scf.ini: the
  quintessence field closes the budget; the Klein-Gordon march in the
  Omega_scf shooting of lambda, and the scf instance of perturb_ark; lensed
  C_l to l = 1200, P(k) to 1/Mpc);
- interacting dark matter with interacting dark radiation: `g34_idmdr_l`
  (tests/golden/gen/g34_idmdr_l.ini: ETHOS idm_dr with per-l damping
  coefficients; the T_idm march and the idm instance of perturb_ark; lensed
  C_l to l = 1200, P(k) with its dark acoustic oscillations to 1/Mpc);

and checks:

1. the hand-written CUDA kernels (csrc/*.cu) build with nvcc for sm_90a;
2. each path launched each kernel it runs (the growth march on every path),
   and a curved path none of the flat scans (and a flat one none of the
   curved scans), a HyRec path hyrec_history and not recfast_history (and a
   RECFAST path the reverse), and a path with isocurvature modes perturb_ark
   once, transfer_los once per initial condition and lensing_wigner once, an
   HMcode path hmcode_sigma four times and hmcode_onehalo once per nonlinear
   computation (the P(k) stage, and the phi+psi ratio with C_l) and
   halofit_sigma never (any other path neither HMcode kernel), an scf path
   scf_march (any other path not), an idm_dr path idm_march exactly once (any
   other path not): launch counters, set to 0 just before the path and read
   just after;
3. each result against the reference C++ build: the probe
   tests/golden/bench_probe.json for planck_row2 (and planck_row2_ss005),
   row2_exact and ncdm_row3 (rel TT/EE/TE <= 3e-3 at l = 220, 1000, 2000,
   2500; rel P(0.1) <= 1e-2), the goldens
   tests/golden/*.npz for the others under the contracts of the JAX tests
   (classpp_public_torch/tools/golden_check.py; g3_tensor:
   tests/test_extended.py:58-92; g8_curved: tests/test_curved.py:176-196;
   g18_closed: tests/test_curved.py:112-157; g5_hyrec: tests/test_hyrec.py;
   g16/g22: tests/test_injection.py; g11a/g11b: tests/test_reio.py, tau_reio
   included; g19_ncl_full, g27_pd: tests/test_numbercounts.py; g32_texact:
   tests/test_tensor_method.py; g9_newt: tests/test_newt_golden.py;
   g21_isocorr: tests/test_isocurvature.py with each initial-condition pair
   under tests/test_peric_output.py's contract; g31_peric:
   tests/test_peric_output.py; g6_hmcode: tests/test_hmcode.py; g13_scf:
   tests/test_scf.py, with the tuned lambda printed beside the reference's
   2.085983; g34_idmdr_l: tests/test_idm_dr.py), for
   nc_des_y1 positive autos and every cross
   inside the Cauchy-Schwarz envelope of its autos, for row2_iso positive
   autos and every initial-condition pair's cross inside its envelope, and
   for each Newtonian twin its synchronous
   configuration's run in this process under tests/test_gauge.py's contract
   (golden_check.gauge_check; g8_newt and g18_newt also print their errors
   against the synchronous golden), and for row2_hmcode its k and tau grids
   and source table equal to row2_exact's bit for bit and its raw TT/TE/EE to
   1e-13 (REUSES: the plain integrator does not run again; its lensed C_l and
   P_nl against halofit's are printed);
4. each kernel against its plain PyTorch version on the very tensors each
   path fed it (hyrec_history in both models, recfast_history with and
   without injection, tb_march through every reionization profile,
   growth_march on every path), with both timed on the card (CUDA events: the
   kernels the median of 3 after a warm-up; the plain versions one call, the
   integrators on a stride of the lanes, or on 8 scalar and 4 tensor lanes
   of a curved path, the lowest and highest k among them, or on texact_ncdm3
   its two lowest-k, its slowest and its highest-k tensor lanes; on the
   Newtonian paths also the two lowest-k and the slowest scalar lanes, and at
   least one P(k)-tail lane; on the isocurvature paths the two lowest-k
   lanes of every isocurvature mode, the slowest lane and, with P(k), a
   P(k)-tail lane; the two HMcode kernels on every call the path made, per
   element; scf_march on the first bisection batch and the final shot, per
   element, and the shooting walked again with the plain loop: the same
   tree path as on the card, or the two tuned lambda within 1e-10;
   idm_march per column; perturb_ark's idm instance on the stride lanes and
   the dark-acoustic lane nearest 0.03/Mpc), beside
   the least time the card could take for the same work (`bound_ms`);
5. the three LOS scans that no path above runs past 1024 tau samples
   (transfer_tensor_los, transfer_los_curved, transfer_tensor_los_curved) on
   g3_tensor's and g8_curved's captured inputs refined fourfold in tau
   (> 2048 samples, by a cubic spline of the sources in tau), against their
   plain versions; and the scaled errors of the paths that ran at commit
   5099a0e beside those printed there (`PRIOR_SCALED_ERR`).

Usage: python3 chip_smoke.py   (from the repository root; needs one card)

Prints per-phase seconds, the command time, a JSON line of kernel results,
the card's name and power limit, and as its last line {"ok": true, "device":
{...}}. Any failure raises and exits non-zero.
"""

import json
import os
import subprocess
import sys
import time

T_START = time.time()
ROOT = os.path.dirname(os.path.abspath(__file__))

CL_TOL, PK_TOL = 3e-3, 1e-2
# kernel vs plain version: max |kernel - plain| over each output column,
# relative to that column's max |plain|. Both are float64 and differ only in
# summation order and in the last bit of sin/cos/exp/lgamma. The LOS scan
# runs the upward Bessel recurrence through the band x < l < x + 6 x^(1/3) + 2
# that its mask keeps, where the recurrence is unstable and amplifies those
# last-bit differences (by up to ~1e9 at l ~ 10): measured ~1.5e-7 of scale.
# The lensing passes have no such band: ~1e-12 (BB, a difference of terms).
# The Gaussian-window sums differ in the order of the sum (strided partials
# and a tree against a sequential trapezoid) and in exp's last bit: ~1e-15.
# The tensor LOS scan runs the same recurrence through the same band: the
# same limit. The Tb march is 4096 dependent steps of a few operations, FMA
# contraction its only difference: 1e-10 of each column's scale.
# The curved scans run the hyperspherical recurrence through the same kind of
# band (beta sin_K < l < beta sin_K + 6 (beta sin_K)^(1/3) + 2): the same
# limit. The growth march is 8190 dependent RK4 sub-steps of a linear
# right-hand side whose table values both versions compute alike; FMA
# contraction is its only difference: 1e-12 of D and of f, per node.
# The selection-window scan runs the same recurrence through the same band
# (each row's x = k (tau0 - tau)); held per row of its output relative to the
# row's max |plain|. Its limit is about 100 times its own measurement on the
# paths' tensors (3.2e-9 on g19_ncl_full and g27_pd, 5.8e-9 on nc_des_y1; NVIDIA
# H100 80GB HBM3 at 700 W): a dropped series term or a float32 intermediate
# shows, the last-bit spread of the band does not.
NC_SCAN_TOL = 6e-7
GROWTH_TOL = 1e-12
# The Klein-Gordon march, per chain and column (phi, phi'), relative to the
# column's max |plain|: 8190 dependent RK4 sub-steps of a right-hand side with
# an exp, a sqrt and two float64 divisions (two pow when alpha != 0); the
# background coefficients are the same formulas in both versions. They differ
# in FMA contraction and in the last bit of the card's exp/sqrt/pow against
# libm's; the attractor solution damps a perturbation of its path, so those
# bits do not grow along the chain. The host build of the kernel's code equals
# the plain loop bit for bit (tests/test_torch_scf.py). A float32 intermediate
# would show at ~1e-7, a dropped term far above.
SCF_MARCH_TOL = 1e-10
# The T_idm march, per column (T_idm, c^2_idm) relative to the column's max
# |plain|: 32 767 dependent implicit-Euler steps, and then the sound speed,
# which multiplies T's last bits by Gamma/H (up to ~1e17 in the tight-coupling
# era, where c^2 is rounding noise: a last-bit change of T moves it by O(1)).
# The kernel rounds every product and sum alone (no FMA contraction) and
# IEEE-divides, so it is the plain loop's arithmetic, as its host build is
# (tests/test_torch_idm_dr.py: equal bits); a contraction would show at
# ~1e-2 of c^2's scale.
IDM_MARCH_TOL = 1e-12
# the tuned lambda of the card's shooting against the plain one's, where their
# walks part (a midpoint whose f is within the last bits of 0)
SCF_LAMBDA_TOL = 1e-10
# The two HMcode kernels are held per element, relative to the plain value
# (sigma^2, sigma_d^2 and the one-halo integral are sums of positive terms;
# dsigma^2/dR of terms of one sign where it matters): both are float64 and
# differ in the order of the sums, FMA contraction and libm's last bits, where
# the NFW window's terms cancel at small k r_v / c. The host build of the
# kernels' code (csrc/hmcode_host.cpp) differs from the plain versions by
# 2.4e-14 (dsigma^2/dR) and 3.9e-16 (one-halo) on the CPU tests' inputs.
HMCODE_TOL = 1e-11
KERNEL_TOL = {"transfer_los": 1e-6, "lensing_wigner": 1e-9, "halofit_sigma": 1e-11,
              "transfer_tensor_los": 1e-6, "tb_march": 1e-10, "transfer_los_curved": 1e-6,
              "transfer_tensor_los_curved": 1e-6, "nc_scan": NC_SCAN_TOL,
              "growth_march": GROWTH_TOL, "hmcode_sigma": HMCODE_TOL,
              "hmcode_onehalo": HMCODE_TOL, "scf_march": SCF_MARCH_TOL,
              "idm_march": IDM_MARCH_TOL}
# A path whose perturbations must equal another path's bit for bit (the same
# cosmology and k grid; only the nonlinear method differs, which enters after
# the perturbation stage): the equality is held instead of a second plain
# integration, and the raw TT/TE/EE, which the nonlinear ratio does not touch
# (it scales the phi+psi source alone), to REUSE_CL_TOL relative.
REUSES = {"row2_hmcode": "row2_exact"}
REUSE_CL_TOL = 1e-13
# recfast_history, per row and column relative to the plain loop: libm's and
# the card's exp/pow differ in the last bit, which the explicit RK4 through
# the stiff HeI equation amplifies (measured against the JAX package's XLA
# arithmetic on the host: 4.9e-8 of x_e in the HeI rows); a phase switch
# decided by last bits may also move by one interval, which the smoothed
# phase boundaries keep continuous.
RECFAST_TOL = 1e-6
# hyrec_history against its plain loop, x_e and T_m per step relative: libm
# against the card's exp/pow/log and FMA contraction (in the two-photon model
# the per-bin sums in the same tree order). HyRec has no stiff phase to
# amplify last bits as RECFAST's HeI phase does: measured 8.8e-16 (3-level
# model) and 8.3e-15 (two-photon) on the card, so a float32 intermediate or a
# dropped small term shows
HYREC_TOL = 1e-11
# tensor_rkck against the plain integrator, per lane and source column:
# |kernel - plain| <= TENSOR_TOL_FACTOR rtol max|plain| (an accept/reject at
# the threshold may go the other way), step counts within PERTURB_STEPS_TOL.
TENSOR_TOL_FACTOR = 10.0
TENSOR_STRIDE = 40    # lanes of the plain comparison: every 40th and the last
# the tensor-only phase of three exact ncdm species compares its two lowest-k
# lanes, its slowest lane and its highest-k lane (the plain integrator steps its
# lanes in lockstep on an 896-wide state, so the slowest lane sets its time)
TENSOR_FEW_LANES = {"texact_ncdm3": 2}
# a curved path compares this many lanes, spread evenly in index from the
# lowest k (nu = 3 when closed) to the highest
CURVED_LANES = {"perturb_ark": 8, "tensor_rkck": 4}
# perturb_ark: the kernel and the plain integrator round differently (FMA
# contraction, libm), so an accept/reject decided at the threshold can go the
# other way; the two solutions then differ by the lane's own tolerance. Lanes
# are classed by their tolerance rows: CMB lanes (every row tight); P(k)-tail
# lanes (radiation rows at rtol_rad = 30 rtol with an absolute floor atol_rad
# = 1e-4, matter rows tight); tail lanes beyond the lensing potential's reach
# (every row at 30 rtol). Per class and source column, max |kernel - plain|
# over the class is held to
#   F (rtol_rad max|plain| + atol_rad)            the four radiation columns;
#   F (rtol_rad + atol_rad / s_rad) max|plain|    the columns derived from the
#       radiation rows, which carry the floor relative to the radiation
#       perturbation's own size s_rad = max |delta_g|, |delta_ur| on the class;
#   F_ncdm rtol_mat max|plain|                    the two ncdm columns;
#   F rtol_mat max|plain|                         every other (matter, metric)
#       column, so that the floor enters no column it does not belong to,
# with F = PERTURB_TOL_FACTOR and F_ncdm = PERTURB_NCDM_FACTOR. On the CMB
# lanes (atol 1e-11) every limit is 1e-4 of the column's scale (1e-3 for
# ncdm); measured there: equal step counts and <= 6e-13 of scale. On the
# highest tail lanes the radiation perturbation is itself of the floor's size
# (s_rad = 4e-4 at k = 11/Mpc on planck_row2): its columns are noise there
# (measured up to 1.2 of their scale apart) and only the matter and metric
# columns, which P(k) is made of, are held (measured <= 3e-7 of scale against
# 3e-3). The ncdm fluid oscillates through all ~32 000 steps of the
# k = 20/Mpc lane of row2_exact and the phase difference of two integrations
# adds up over them (measured 5.5e-3 of delta_ncdm's scale = 18 rtol_mat
# there, with the step counts 627 apart), hence its own factor.
# Step counts are held per lane to PERTURB_STEPS_TOL of the plain count
# (measured: equal on the CMB lanes, 2.0e-2 apart on that k = 20/Mpc lane).
PERTURB_TOL_FACTOR = 10.0
PERTURB_NCDM_FACTOR = 100.0
PERTURB_STEPS_TOL = 0.05
PERTURB_RADIATION_COLS = ("delta_g", "theta_g", "delta_ur", "theta_ur")
PERTURB_DERIVED_COLS = ("t0", "t1", "t2", "p", "phi_prime", "H_T_Nb_prime", "theta_tot")
PERTURB_NCDM_COLS = ("delta_ncdm", "theta_ncdm")
PERTURB_STRIDE = 24   # lanes of the plain comparison: every 24th and the last
# a wider stride where the plain integrator is slow: ncdm_row3's three species
# make a 910-wide state (every 48th lane and the last)
PERTURB_STRIDE_OF = {"ncdm_row3": 48}
# the Newtonian paths (the gauge's new code on the card): the plain comparison
# also takes their two lowest-k lanes and their slowest lane, and must hold at
# least one P(k)-tail lane (the tail keeps its tolerances tight in this gauge)
NEWT_PATHS = ("g9_newt", "row2_newt", "g8_newt", "g18_newt")
# the isocurvature paths (the initial-condition branch's code on the card):
# the plain comparison takes the two lowest-k lanes of every isocurvature
# mode, the slowest lane and, with P(k), the lowest-k P(k)-tail lane of the
# last mode, and none of the stride (its lanes are the adiabatic ones of the
# earlier paths)
ISO_PATHS = ("g21_isocorr", "g21_newt", "g31_peric", "row2_iso")
# Raw phiphi at l = 2 of the g1 cosmology (g9_newt's) is a draw of the tau
# sampling, whose late samples the last bits of the thermodynamics table move
# (ROADMAP Queue 3; tests/torch_phiphi_sampling.py): the JAX package draws
# 5.2e-3 to 2.0e-2 there as omega_cdm moves by 1e-12, against a limit of
# 1e-2. On these paths that multipole is printed beside its limit and the
# gate holds raw phiphi over l = 3..2500.
SAMPLING_DRAW = ("g9_newt",)
# the scalar-field paths: perturb_ark's scf instance prints the step counts of
# its compared lanes beside the plain integrator's
SCF_PATHS = ("g13_scf",)
# the idm_dr paths: perturb_ark's idm instance prints the step counts of its
# compared lanes, among them the dark-acoustic lane nearest IDM_DAO_K
IDM_PATHS = ("g34_idmdr_l",)
IDM_DAO_K = 0.03
# The plain integrator steps all its lanes in lockstep (~6 ms a step on the
# card with the ncdm block), so a lane of more steps than this is left out of
# the comparison: the k = 22.6/Mpc tail lane of row2_exact (~31 000 steps, the
# ncdm fluid oscillating) alone would take ~200 s.
PLAIN_MAX_STEPS = 10_000
# card peaks for `bound_ms`: HBM3 rate, and the float64 rate outside the tensor
# cores taken as half the published 67 TFLOP/s float32 rate
PEAK_BYTES_S, PEAK_F64_FLOPS = 3.35e12, 33.5e12


def phase(name, t0):
    print(f"[phase] {name}: {time.time() - t0:.3f} s", flush=True)


def probe_check(row, cl, pk):
    """The bench.py rule (bench.py:91-118) against the probe row `row`
    (golden_check.probe_rel)."""
    from classpp_public_torch.tools.golden_check import probe_rel

    worst = probe_rel(row, cl, pk)
    ok = all(v <= (PK_TOL if k == "rel_pk" else CL_TOL) for k, v in worst.items())
    return ok, worst


def timed(fn, reps=3, warmup=True):
    """Median wall time of fn() on the card in ms (CUDA events) and its result.
    The plain versions are timed once, without a warm-up (reps=1,
    warmup=False): they build nothing, and the plain lensing alone takes ~7 s
    a call."""
    import torch

    if warmup:
        fn()
    torch.cuda.synchronize()
    times, out = [], None
    for _ in range(reps):
        a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        a.record()
        out = fn()
        b.record()
        torch.cuda.synchronize()
        times.append(a.elapsed_time(b))
    return sorted(times)[len(times) // 2], out


def spy(module, name, captured, size=lambda args: 0, every=False):
    """Wrap module.name so that its calls record their arguments in
    captured[name], keeping the call of the largest size(args) (the latest
    among equals), and with `every` each call in order in captured[name +
    "/all"]; returns the original function."""
    orig = getattr(module, name)

    def wrapper(*args, **kwargs):
        if every:
            captured.setdefault(name + "/all", []).append((args, kwargs))
        if name not in captured or size(args) >= size(captured[name][0]):
            captured[name] = (args, kwargs)
        return orig(*args, **kwargs)

    setattr(module, name, wrapper)
    return orig


def compare(name, kern, plain):
    """(max_abs_err, scaled error) between two (..., ncol) outputs."""
    import torch

    if kern.shape != plain.shape:
        raise RuntimeError(f"{name}: kernel shape {tuple(kern.shape)} != plain "
                           f"{tuple(plain.shape)}")
    if not bool(torch.isfinite(kern).all()):
        raise RuntimeError(f"{name}: kernel output is not finite")
    diff = (kern - plain).abs()
    return float(diff.max()), float(diff.max() / plain.abs().max().clamp_min(1e-300))


def columns(kname, kern, plain, axis):
    """max_abs_err and the largest scaled error over the slices of the
    outputs along `axis`, each relative to its own max |plain|."""
    errs = [compare(kname, kern.select(axis, i), plain.select(axis, i))
            for i in range(kern.shape[axis])]
    return dict(max_abs_err=max(e[0] for e in errs), scaled_err=max(e[1] for e in errs))


def bound(nbytes, flops):
    """(bound_ms, bound_by): the larger of bytes over the memory rate and
    float64 operations over the peak rate."""
    tb, tf = nbytes / PEAK_BYTES_S * 1e3, flops / PEAK_F64_FLOPS * 1e3
    return (tb, "bytes") if tb >= tf else (tf, "operations")


def nbytes(*tensors):
    return sum(t.numel() * t.element_size() for t in tensors)


class Kernel:
    """One hand-written kernel: its module, launch counter, the wrapper the
    main path calls (spied on to capture its arguments; `size` picks the
    largest of several calls), its source and the JAX program it replaces."""

    def __init__(self, name, module, counter, fn, source, replaces, size=lambda args: 0,
                 every=False):
        self.name, self.module, self.counter, self.fn = name, module, counter, fn
        self.source, self.replaces, self.size, self.every = source, replaces, size, every


def expected_kernels(out, sgnK, recombination="recfast", last="lensing", every=(), scf=False,
                     idm=False):
    """(the kernels a path with OutputSelection `out`, curvature sign sgnK and
    `recombination` must launch, those it must not launch): a curved path
    runs the hyperspherical scans and not the flat ones, a flat path the
    reverse; a HyRec path hyrec_history and not recfast_history, a RECFAST
    path the reverse; a path with a scalar field (`scf`) scf_march, any other
    path not; a path with idm_dr (`idm`) idm_march exactly once, any other
    path not. Every path launches growth_march. A path that stops
    after the thermodynamics (`last`) launches its recombination kernel,
    tb_march and growth_march, and none else of `every`; one that runs the
    tensor perturbations alone, those and tensor_rkck. The third item holds
    exact counts: a path with isocurvature modes launches perturb_ark once
    (every mode in one launch), transfer_los once per initial condition and
    lensing_wigner once (on the total C_l)."""
    hyrec = recombination in ("hyrec", "hyrec_full")
    reco = {"hyrec_history"} if hyrec else {"recfast_history"}
    other_reco = {"recfast_history"} if hyrec else {"hyrec_history"}
    early = reco | {"tb_march", "growth_march"} | ({"scf_march"} if scf else set()) \
        | ({"idm_march"} if idm else set())
    exact = {"idm_march": 1} if idm else {}
    if last == "thermodynamics":
        return early, set(every) - early, exact
    if last == "tensor_perturbations":
        return early | {"tensor_rkck"}, set(every) - early - {"tensor_rkck"}, exact
    names = early | {"perturb_ark"}
    if len(out.ics) > 1:
        exact["perturb_ark"] = 1
        if out.has_cls:
            exact["transfer_los"] = len(out.ics)
            if out.lensing:
                exact["lensing_wigner"] = 1
    scans = set()
    if out.has_cls:
        scans = {"transfer_los"} | ({"transfer_tensor_los"} if "t" in out.modes else set())
        if out.lensing:
            names.add("lensing_wigner")
    if out.has_nc:
        names.add("nc_scan")
    # the nonlinear stage with mPk, the phi+psi ratio with C_l and a method
    # (each one compute_nonlinear: halofit's sums, or HMcode's four sigma
    # launches and one one-halo launch)
    nl_calls = int(out.has_pk) + int(bool(out.non_linear) and out.has_cls)
    hmcode = {"hmcode_sigma", "hmcode_onehalo"}
    if out.non_linear == "hmcode":
        names |= hmcode
        exact.update(hmcode_sigma=4 * nl_calls, hmcode_onehalo=nl_calls)
        other_nl = {"halofit_sigma"}
    else:
        if nl_calls:
            names.add("halofit_sigma")
        other_nl = hmcode
    if "t" in out.modes:
        names.add("tensor_rkck")
    curved = {f"{n}_curved" for n in scans}
    other = other_reco | other_nl | (set() if scf else {"scf_march"}) \
        | (set() if idm else {"idm_march"})
    if sgnK:
        return names | curved, {"transfer_los", "transfer_tensor_los"} | other, exact
    return names | scans, {"transfer_los_curved", "transfer_tensor_los_curved"} | other, exact


def run_config(name, params, kernels, last="lensing"):
    """One path: the configuration through Class(device="cuda") stage by
    stage up to `last` with every launch counter set to 0 just before and
    read just after; checks the kernels launched, shapes, finiteness and the
    reference (probe or golden), or for a path that stops after the
    thermodynamics that its x_e and T_b tables are finite (for one that runs
    the tensor perturbations alone, last = "tensor_perturbations", that its
    tensor sources are). Returns (launch counts, captured kernel arguments,
    stage seconds)."""
    import numpy as np
    import torch

    import classpp_public_torch as cpt

    c = cpt.Class(device=torch.device("cuda"))
    c.set(dict(params))
    cosmo = c.cosmo
    captured = {}
    originals = {k.name: spy(k.module, k.fn, captured, k.size, k.every) for k in kernels}
    for k in kernels:
        setattr(k.module, k.counter, 0)
    t_all = time.time()
    stage_s = {}
    stage_names = ["background", "thermodynamics", "tensor_perturbations"] \
        if last == "tensor_perturbations" else cosmo.stages(last)
    for st in stage_names:
        t0 = time.time()
        getattr(cosmo, st)
        torch.cuda.synchronize()
        stage_s[st] = time.time() - t0
        phase(f"{name} stage {st}", t0)
    scf = cosmo.params.Omega_scf != 0.0
    idm = cosmo.params.Omega_idm_dr > 0.0
    if scf:
        # the shooting's walk and target, for check_scf_march
        captured["scf_background"] = (cosmo.background[0], cosmo.params)
    if last in ("thermodynamics", "tensor_perturbations"):
        phase(f"{name} total", t_all)
        counts = read_counts(name, kernels, originals)
        check_launches(name, counts, *expected_kernels(
            cosmo.out, cosmo.sgnK, cosmo.params.recombination, last, counts, scf, idm))
        if last == "thermodynamics":
            th = cosmo.thermodynamics
            if not (bool(torch.isfinite(th.xe_of_z).all())
                    and bool(torch.isfinite(th.Tb_of_z).all())):
                raise RuntimeError(f"{name}: non-finite thermodynamics tables")
            print(f"[thermo] {name} tau_reio {th.tau_reio:.6f} z_reio {th.z_reio:.4f} z_star "
                  f"{th.z_star:.4f} z_d {th.z_d:.4f} rs_d {th.rs_d:.4f}", flush=True)
        else:
            tp = cosmo.tensor_perturbations
            if not bool(torch.isfinite(tp.sources).all()):
                raise RuntimeError(f"{name}: non-finite tensor sources")
            print(f"[shapes] {name} tensor k {tuple(tp.k.shape)} tau {tuple(tp.tau.shape)} "
                  f"sources {tuple(tp.sources.shape)} steps max {int(tp.stats_steps.max())} mean "
                  f"{float(tp.stats_steps.float().mean()):.1f} m_ncdm {cosmo.params.m_ncdm}",
                  flush=True)
        print(f"[stages] {name} " + " ".join(f"{k}={v:.3f}s" for k, v in stage_s.items()),
              flush=True)
        return counts, captured, stage_s
    t0 = time.time()
    out = cosmo.out
    cl = c.lensed_cl(2500) if out.lensing else None
    raw = c.raw_cl(2500 if out.has_cls else out.l_lss_max) if out.has_cls or out.has_nc \
        else None
    has_pk = cosmo.out.has_pk
    if has_pk:
        pk = c.pk_lin(0.1, 0.0)
        pk_nl = c.pk(0.1, 0.0)
    torch.cuda.synchronize()
    stage_s["accessors"] = time.time() - t0
    phase(f"{name} accessors", t0)
    phase(f"{name} total", t_all)
    counts = read_counts(name, kernels, originals)
    check_launches(name, counts, *expected_kernels(cosmo.out, cosmo.sgnK,
                                                   cosmo.params.recombination, scf=scf,
                                                   idm=idm))
    pt = cosmo.perturbations
    tr_shape = tuple(cosmo.transfer.delta.shape) if out.has_cls else None
    print(f"[shapes] {name} k {tuple(pt.k.shape)} tau {tuple(pt.tau.shape)} sources "
          f"{tuple(pt.sources.shape)} transfer {tr_shape} "
          f"steps max {int(pt.stats_steps.max())} mean {float(pt.stats_steps.float().mean()):.1f} "
          f"m_ncdm {cosmo.params.m_ncdm}"
          + (f" isocurvature {list(pt.sources_iso)}" if pt.sources_iso else ""), flush=True)
    if "t" in cosmo.out.modes:
        tp = cosmo.tensor_perturbations
        print(f"[shapes] {name} tensor k {tuple(tp.k.shape)} tau {tuple(tp.tau.shape)} sources "
              f"{tuple(tp.sources.shape)} transfer {tuple(cosmo.tensor_transfer.delta.shape)} "
              f"steps max {int(tp.stats_steps.max())} "
              f"mean {float(tp.stats_steps.float().mean()):.1f}", flush=True)
    for tname, tab in (("lensed", cl), ("raw", raw)):
        if tab is None or not out.has_cls:
            continue
        for spec in ("tt", "ee", "te", "bb", "pp"):
            arr = np.asarray(tab[spec])
            if arr.shape != (2501,) or not np.isfinite(arr).all():
                raise RuntimeError(f"{name} {tname} C_l[{spec}]: shape {arr.shape} or non-finite")
    if out.has_nc:
        check_nc_output(name, c, raw)
    if has_pk:
        nl = cosmo.nonlinear
        print(f"[nonlinear] {name} k_nl {[round(float(v), 6) for v in nl.k_nl]} "
              f"sigma8 {nl.sigma8:.6f}", flush=True)
        if not (np.isfinite(pk) and pk > 0 and 0.8 * pk <= pk_nl <= 1.5 * pk):
            raise RuntimeError(f"{name}: P(k=0.1) linear {pk}, nonlinear {pk_nl}")
    from classpp_public_torch.tools.configs import NEWT_TWIN, PROBE_ROW
    from classpp_public_torch.tools.golden_check import gauge_summary

    if name in NEWT_TWIN or name in NEWT_TWIN.values():
        GAUGE_RUNS[name] = gauge_summary(c)
    if name in REUSES.values():
        REUSE_RUNS[name] = reuse_summary(c, raw, cl)
    if name == "nc_des_y1":
        pass                        # no golden: check_nc_output held it
    elif name == "row2_iso":
        check_iso_output(name, c)   # no golden
    elif name in NEWT_TWIN:
        check_gauge_twin(name, NEWT_TWIN[name], c)
    elif name in REUSES:
        check_reuse(name, REUSES[name], c, raw, cl)   # no golden
    elif name not in PROBE_ROW:
        from classpp_public_torch.tools.golden_check import Golden, golden_check

        rel = golden_check(name, raw, cl, c.pk_lin, cosmo.params.h, cosmo.thermodynamics, c)
        if name in SAMPLING_DRAW:
            # raw phiphi at l = 2 beside its limit, not held; the gate holds
            # l = 3..2500 (SAMPLING_DRAW)
            g = Golden(name)
            tol = rel.pop("raw_pp")[1]
            rel["raw_pp_l2"] = (g.rel("cl", "phiphi", raw["pp"], 2, 2)[0], None, 2)
            v, at = g.rel("cl", "phiphi", raw["pp"], 3, 2500)
            rel["raw_pp_l3_2500"] = (v, tol, at)
        print(f"[golden] {name} " + json.dumps({k: {"rel": v, "tol": t, "at": at}
                                                for k, (v, t, at) in rel.items()}), flush=True)
        bad = {k: v for k, (v, t, _) in rel.items() if t is not None and not v <= t}
        if bad:
            raise RuntimeError(f"{name} out of its golden's contract: {bad}")
    else:
        ok, rel = probe_check(PROBE_ROW[name], cl, pk)
        print(f"[probe] {name} (row {PROBE_ROW[name]}) {json.dumps(rel)} (tol C_l {CL_TOL}, "
              f"P(k) {PK_TOL})", flush=True)
        if not ok:
            raise RuntimeError(f"{name} probe out of contract: {rel}")
    print(f"[stages] {name} " + " ".join(f"{k}={v:.3f}s" for k, v in stage_s.items()),
          flush=True)
    return counts, captured, stage_s


GAUGE_RUNS = {}   # gauge_summary of each Newtonian twin and its synchronous configuration
REUSE_RUNS = {}   # reuse_summary of each path that a path of REUSES is held to


def reuse_summary(c, raw, lensed):
    """What a path of REUSES is held to: the perturbation grids and source
    table (on the card), the raw C_l, and for the record the lensed C_l and
    the nonlinear P(k, z = 0) at k = 0.1, 1 and 10/Mpc."""
    import numpy as np

    pert = c.cosmo.perturbations
    return dict(k=pert.k_np, tau=pert.tau_np, sources=pert.sources,
                raw={s: np.asarray(raw[s]) for s in ("tt", "te", "ee", "pp")},
                lensed={s: np.asarray(lensed[s]) for s in ("tt", "ee", "pp")},
                pk_nl={kk: c.pk(kk, 0.0) for kk in (0.1, 1.0, 10.0)},
                method=c.cosmo.out.non_linear)


def check_reuse(name, twin, c, raw, lensed):
    """A path of REUSES against the path whose perturbations it shares, run
    earlier in this process: the k and tau grids and the source table equal
    bit for bit, and raw TT, EE (per multipole) and TE (against sqrt(TT EE))
    within REUSE_CL_TOL relative on l = 2..2500. Printed and not held: raw
    phiphi, lensed TT/EE/phiphi and the nonlinear P(k = 0.1, 1, 10/Mpc, z = 0)
    of this path against the other's (the nonlinear methods' difference)."""
    import numpy as np
    import torch

    if twin not in REUSE_RUNS:
        raise RuntimeError(f"{name}: {twin}, whose perturbations it reuses, did not run before it")
    ref, pert = REUSE_RUNS[twin], c.cosmo.perturbations
    same = (np.array_equal(pert.k_np, ref["k"]) and np.array_equal(pert.tau_np, ref["tau"])
            and pert.sources.shape == ref["sources"].shape
            and bool(torch.equal(pert.sources, ref["sources"])))
    print(f"[reuse] {name}: k, tau and the source table {tuple(pert.sources.shape)} equal to "
          f"{twin}'s bit for bit: {same}", flush=True)
    if not same:
        raise RuntimeError(f"{name}: its perturbations differ from {twin}'s")
    ell = slice(2, 2501)
    mine = {s: np.asarray(raw[s])[ell] for s in ("tt", "te", "ee")}
    want = {s: ref["raw"][s][ell] for s in ("tt", "te", "ee")}
    rel = {s: float(np.max(np.abs(mine[s] - want[s]) / np.abs(want[s]))) for s in ("tt", "ee")}
    rel["te"] = float(np.max(np.abs(mine["te"] - want["te"]) / np.sqrt(want["tt"] * want["ee"])))
    info = {"raw_pp": float(np.max(np.abs(np.asarray(raw["pp"])[ell] / ref["raw"]["pp"][ell]
                                           - 1.0)))}
    for s in ("tt", "ee", "pp"):
        info[f"lensed_{s}"] = float(np.max(np.abs(np.asarray(lensed[s])[ell]
                                                  / ref["lensed"][s][ell] - 1.0)))
    for kk, p_ref in ref["pk_nl"].items():
        info[f"pk_nl_k{kk:g}"] = c.pk(kk, 0.0) / p_ref - 1.0
    print(f"[reuse] {name}: raw TT/EE/TE against {twin}'s {json.dumps(rel)} (limit "
          f"{REUSE_CL_TOL}); not held, {c.cosmo.out.non_linear} against {ref['method']}, "
          f"largest relative difference on l = 2..2500 and P_nl(k, z = 0) / P_nl - 1: "
          f"{json.dumps(info)}", flush=True)
    bad = {s: v for s, v in rel.items() if not v <= REUSE_CL_TOL}
    if bad:
        raise RuntimeError(f"{name}: raw C_l differ from {twin}'s beyond {REUSE_CL_TOL}: {bad}")


def check_gauge_twin(name, twin, c):
    """A Newtonian twin against its synchronous configuration's run in this
    process under tests/test_gauge.py's contract; a curved twin's errors
    against the synchronous golden are printed too."""
    from classpp_public_torch.tools.golden_check import gauge_check, golden_check

    if twin not in GAUGE_RUNS:
        raise RuntimeError(f"{name}: its synchronous twin {twin} did not run before it")
    rel = gauge_check(name, GAUGE_RUNS[name], GAUGE_RUNS[twin])
    print(f"[gauge] {name} against {twin} " + json.dumps(
        {k: {"rel": v, "tol": t, "at": at} for k, (v, t, at) in rel.items()}), flush=True)
    if name in ("g8_newt", "g18_newt"):
        ref = golden_check(twin, GAUGE_RUNS[name]["raw"], GAUGE_RUNS[name]["lensed"], c.pk_lin,
                           c.cosmo.params.h)
        print(f"[golden, not held] {name} against {twin}'s golden " + json.dumps(
            {k: {"rel": v, "tol": t, "at": at} for k, (v, t, at) in ref.items()}), flush=True)
    bad = {k: v for k, (v, t, _) in rel.items() if t is not None and not v <= t}
    if bad:
        raise RuntimeError(f"{name} differs from its synchronous twin {twin} beyond "
                           f"tests/test_gauge.py's contract: {bad}")


def check_nc_output(name, c, raw):
    """The number-count keys of raw_cl: the JAX classy's key set for the
    output, finite, every auto positive, and every cross inside the
    Cauchy-Schwarz envelope of its two autos (exact on the k quadrature's
    multipoles; 1% headroom for the spline to every l)."""
    import numpy as np

    out = c.cosmo.out
    nbin, nd = len(out.selection_mean), out.non_diagonal
    pairs = [(i, j) for i in range(1, nbin + 1) for j in range(i, min(i + nd, nbin) + 1)]
    want = set()
    if out.nCl:
        want |= {f"dens[{i}]-dens[{j}]" for i, j in pairs}
    if out.sCl:
        want |= {f"lens[{i}]-lens[{j}]" for i, j in pairs}
    if out.nCl and out.sCl:
        want |= {f"dens[{i}]-lens[{j}]" for i in range(1, nbin + 1) for j in range(1, nbin + 1)
                 if abs(i - j) <= nd}
    if out.nCl and out.lCl and out.has_cls:
        want |= {f"phi-dens[{b}]" for b in range(1, nbin + 1)}
        if out.tCl:
            want |= {f"T-dens[{b}]" for b in range(1, nbin + 1)}
    got = {k for k in raw if "[" in k}
    if got != want:
        raise RuntimeError(f"{name}: raw_cl number-count keys {sorted(got ^ want)} differ")
    ell = np.arange(2, out.l_lss_max + 1)
    for key in sorted(want):
        if not np.isfinite(np.asarray(raw[key])[ell]).all():
            raise RuntimeError(f"{name} C_l[{key}] is not finite")
    split = [(key, *key.split("-")) for key in want if not key.startswith(("phi-", "T-"))]
    worst = check_envelope(name, {a: np.asarray(raw[key])[ell] for key, a, b in split if a == b},
                           {(a, b): np.asarray(raw[key])[ell] for key, a, b in split if a != b})
    print(f"[nc] {name}: {len(want)} spectra to l = {out.l_lss_max}, finite, autos positive; "
          f"largest cross over its envelope {worst:.6f}", flush=True)


def check_envelope(name, autos, crosses):
    """Every auto C_l positive and every cross {(a, b): C_l} inside the
    Cauchy-Schwarz envelope sqrt(C_aa C_bb) of its two autos (exact on the k
    quadrature's multipoles; 1% headroom for the spline to every l); returns
    the largest |C_ab| / sqrt(C_aa C_bb)."""
    import numpy as np

    for a, arr in autos.items():
        if not (arr > 0).all():
            raise RuntimeError(f"{name}: auto C_l of {a} not positive")
    worst = max((float(np.max(np.abs(arr) / np.sqrt(autos[a] * autos[b])))
                 for (a, b), arr in crosses.items()), default=0.0)
    if not worst <= 1.01:
        raise RuntimeError(f"{name}: a cross spectrum leaves its Cauchy-Schwarz envelope: {worst}")
    return worst


def check_iso_output(name, c):
    """An isocurvature path without a golden: each initial-condition pair's
    raw C_l finite, and in TT and EE the autos positive and every cross
    inside its envelope (check_envelope)."""
    import numpy as np

    from classpp_public_torch.tools.golden_check import pair_cls

    lmax = c.cosmo.out.l_scalar_max
    pairs = {ab: cl[2:] for ab, cl in pair_cls(c, lmax).items()}
    for (a, b), cl in pairs.items():
        if not np.isfinite(cl).all():
            raise RuntimeError(f"{name}: C_l of the pair {a}-{b} not finite")
    worst = max(check_envelope(f"{name} {col}",
                               {a: cl[:, i] for (a, b), cl in pairs.items() if a == b},
                               {ab: cl[:, i] for ab, cl in pairs.items() if ab[0] != ab[1]})
                for i, col in enumerate(("TT", "EE")))
    print(f"[iso] {name}: pairs {sorted(pairs)} to l = {lmax}, finite, autos positive; "
          f"largest cross over its envelope {worst:.6f}", flush=True)


def check_launches(name, counts, must, must_not, exact):
    missing = sorted(n for n in must if counts[n] <= 0)
    if missing:
        raise RuntimeError(f"{name}: kernels not launched on the main path: {missing}")
    off = {n: (counts[n], v) for n, v in exact.items() if counts[n] != v}
    if off:
        raise RuntimeError(f"{name}: launches (counted, expected) {off}")
    stray = sorted(n for n in must_not if counts[n] != 0)
    if stray:
        raise RuntimeError(f"{name}: kernels of another geometry, recombination code or "
                           f"nonlinear method launched: {stray}")


def read_counts(name, kernels, originals):
    """The launch counts of the path `name`, read just after it; puts the
    spied-on wrappers back."""
    counts = {k.name: getattr(k.module, k.counter) for k in kernels}
    for k in kernels:
        setattr(k.module, k.fn, originals[k.name])
    print(f"[launches] {name} {counts}", flush=True)
    return counts


def compared_lanes(nl, stride, curved, name):
    """The lanes of a plain comparison: every stride-th and the last, or on a
    curved path CURVED_LANES[name] spread evenly from the first to the last."""
    import numpy as np

    if curved:
        return sorted(set(np.linspace(0, nl - 1, CURVED_LANES[name]).round().astype(int).tolist()))
    return sorted(set(range(0, nl, stride)) | {nl - 1})


def print_lane_steps(name, tag, k, steps_kernel, steps_plain, kinds=None):
    """The step counts of the compared lanes; kinds: each lane's initial
    condition, printed before its k."""
    kinds = kinds or [""] * len(k)
    print(f"[{name}] {tag} steps per compared lane (k/Mpc: kernel, plain): "
          + ", ".join(f"{kind + ' ' if kind else ''}{float(kk):.5g}: {int(a)}, {int(b)}"
                      for kind, kk, a, b in zip(kinds, k, steps_kernel, steps_plain)), flush=True)


def check_perturb_ark(solve, args, tag, curved=False):
    """The integrator kernel against its plain version on every
    PERTURB_STRIDE-th lane (PERTURB_STRIDE_OF on the paths named there) and
    the last (highest k) of the captured call, or
    on a curved path on CURVED_LANES lanes from the lowest k to the highest,
    or on an isocurvature path as ISO_PATHS says; lanes of more than
    PLAIN_MAX_STEPS steps are left out."""
    import torch

    from classpp_public_torch.models.perturbations.equations import IC_KINDS
    from classpp_public_torch.models.perturbations.indices import SrcIdx

    lanes, taus, tables, (rtol, atol) = args[:4]
    ic = args[4] if len(args) > 4 else None
    idx = tables.idx
    nl = lanes.k.shape[0]
    ms, (S, nsteps) = timed(lambda: solve.integrate_sources(lanes, taus, tables, (rtol, atol),
                                                            ic))
    stride = PERTURB_STRIDE_OF.get(tag, PERTURB_STRIDE)
    picked = compared_lanes(nl, stride, curved, "perturb_ark")
    slow = int(nsteps.argmax())
    if tag in NEWT_PATHS:
        picked = sorted(set(picked) | {0, 1, slow})
    if tag in IDM_PATHS:
        picked = sorted(set(picked) | {int((lanes.k - IDM_DAO_K).abs().argmin())})
    if ic is not None:
        codes = ic.cpu()
        iso_lanes = [torch.nonzero(codes == c).flatten().tolist() for c in range(1, len(IC_KINDS))]
        picked = {slow} | {i for lanes_c in iso_lanes for i in lanes_c[:2]}
        tail = [i for i in max(iso_lanes, key=lambda v: v[0] if v else -1)
                if float(atol[i, idx.delta_cdm]) > 1e-11]
        picked = sorted(picked | set(tail[:1]))
    long_lanes = [i for i in picked if int(nsteps[i]) > PLAIN_MAX_STEPS]
    if long_lanes:
        print(f"[perturb_ark] {tag}: lanes of more than {PLAIN_MAX_STEPS} steps left out of "
              f"the plain comparison: " + ", ".join(
                  f"k = {float(lanes.k[i]):.4g}/Mpc ({int(nsteps[i])} steps)" for i in long_lanes),
              flush=True)
    sel = torch.as_tensor([i for i in picked if i not in long_lanes], device=taus.device)
    rt_sel, at_sel = rtol[sel].contiguous(), atol[sel].contiguous()
    # P(k)-tail lanes carry the 3e-8 absolute floor on the matter rows
    n_tail = int((at_sel[:, idx.delta_cdm] > 1e-11).sum())
    idr = ("fluid" if idx.idr_fluid else "free-streaming") if idx.has_idm_dr else ""
    print(f"[perturb_ark] {tag}: gauge {idx.gauge}"
          f"{', idm_dr (' + idr + ' idr)' if idr else ''}"
          f"; slowest lane k = {float(lanes.k[slow]):.5g}"
          f"/Mpc, {int(nsteps[slow])} steps; {n_tail} P(k)-tail lanes compared", flush=True)
    if tag in NEWT_PATHS and n_tail == 0:
        raise RuntimeError(f"perturb_ark ({tag}): no P(k)-tail lane in the plain comparison")
    # with P(k) some lanes carry the 3e-8 absolute floor
    if ic is not None and bool((atol > 1e-11).any()) and n_tail == 0:
        raise RuntimeError(f"perturb_ark ({tag}): no P(k)-tail lane in the plain comparison")
    ic_sel = ic[sel].contiguous() if ic is not None else None
    a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    a.record()
    Sp, np_ = solve.integrate_sources_plain(lanes.take(sel), taus, tables, (rt_sel, at_sel),
                                            ic_sel)
    b.record()
    torch.cuda.synchronize()
    plain_ms = a.elapsed_time(b)
    Sk = S[sel]
    if not bool(torch.isfinite(S).all()):
        raise RuntimeError(f"perturb_ark ({tag}): kernel output is not finite")
    # classes of lanes: those that share one row of tolerances
    _, cls_of = torch.unique(torch.cat([rt_sel, at_sel], dim=1), dim=0, return_inverse=True)
    worst, max_abs, bad = 0.0, 0.0, []
    for c in range(int(cls_of.max()) + 1):
        m = cls_of == c
        i0 = int(torch.nonzero(m)[0])
        rad = (float(rt_sel[i0, idx.delta_g]), float(at_sel[i0, idx.delta_g]))
        rtol_mat = float(rt_sel[i0, idx.delta_cdm])
        scales = [float(Sp[m][:, :, i].abs().max()) for i in range(SrcIdx.n)]
        s_rad = max(scales[SrcIdx.ix["delta_g"]], scales[SrcIdx.ix["delta_ur"]])
        cls_worst = (0.0, "")
        for i, (cname, scale) in enumerate(zip(SrcIdx.names, scales)):
            if cname in PERTURB_RADIATION_COLS:
                lim = PERTURB_TOL_FACTOR * (rad[0] * scale + rad[1])
            elif cname in PERTURB_DERIVED_COLS:
                lim = PERTURB_TOL_FACTOR * (rad[0] + rad[1] / s_rad) * scale
            elif cname in PERTURB_NCDM_COLS:
                lim = PERTURB_NCDM_FACTOR * rtol_mat * scale
            else:
                lim = PERTURB_TOL_FACTOR * rtol_mat * scale
            err = float((Sk[m][:, :, i] - Sp[m][:, :, i]).abs().max())
            max_abs = max(max_abs, err)
            cls_worst = max(cls_worst, (err / lim if lim > 0 else float(err > 0), cname))
            if not err <= lim:
                bad.append(f"class {c} column {cname}: |kernel - plain| {err:.3e} > {lim:.3e} "
                           f"(scale {scale:.3e})")
        worst = max(worst, cls_worst[0])
        k_cls = lanes.k[sel][m]
        print(f"[perturb_ark] {tag} class {c}: {int(m.sum())} lanes, k {float(k_cls.min()):.4g}"
              f"-{float(k_cls.max()):.4g}/Mpc, radiation rows (rtol, atol) {rad}, matter rows "
              f"rtol {rtol_mat}; worst column {cls_worst[1]} at {cls_worst[0]:.3e} of its limit",
              flush=True)
    if bad:
        raise RuntimeError(f"perturb_ark ({tag}) disagrees with its plain version:\n"
                           + "\n".join(bad))
    dn = (nsteps[sel] - np_).abs()
    dn_rel = float((dn / np_).max())
    if curved or tag in NEWT_PATHS or tag in SCF_PATHS or tag in IDM_PATHS:
        print_lane_steps("perturb_ark", tag, lanes.k[sel], nsteps[sel], np_)
    iso_equal = None
    if ic_sel is not None:
        kinds = [IC_KINDS[int(c)] for c in ic_sel.cpu()]
        print_lane_steps("perturb_ark", tag, lanes.k[sel], nsteps[sel], np_, kinds)
        iso = ic_sel != 0
        iso_equal = bool((nsteps[sel][iso] == np_[iso]).all())
        print(f"[perturb_ark] {tag}: isocurvature lanes compared {sorted(set(kinds) - {'ad'})}, "
              f"equal step counts on all of them: {iso_equal}", flush=True)
        if not iso_equal:
            raise RuntimeError(f"perturb_ark ({tag}): step counts differ from the plain "
                               "version's on an isocurvature lane")
    how = "ISO_PATHS' lanes" if ic is not None else f"stride {stride} and the last"
    print(f"[perturb_ark] {tag}: {len(sel)} of {nl} lanes compared ({how}), state "
          f"{idx.size}, {idx.n_ncdm} ncdm species; worst error "
          f"{worst:.3e} of its limit; max |nsteps_kernel - nsteps_plain| {int(dn.max())} "
          f"({dn_rel:.3e} of the plain count, limit {PERTURB_STEPS_TOL}); plain {plain_ms:.0f} ms "
          f"for {len(sel)} lanes, kernel {ms:.1f} ms for {nl}", flush=True)
    if not dn_rel <= PERTURB_STEPS_TOL:
        raise RuntimeError(f"perturb_ark ({tag}): step counts {dn_rel:.3e} apart")
    # least work: each attempted step is 6 stages of the right-hand side
    # (~12 n + 400 operations), the stage combinations (30 (n + n_stiff)) and
    # the solution and error sums (24 n), at the width the lanes keep once the
    # ncdm block has collapsed to its 3 fluid moments; every input read and
    # the source table written once
    n_late = idx.size - (idx.n_ncdm_block - 3 * idx.n_ncdm if idx.n_ncdm else 0)
    flops = float(nsteps.sum()) * (6 * (12 * n_late + 400)
                                   + 30 * (n_late + solve.stiff_count(idx)) + 24 * n_late)
    bms, bby = bound(nbytes(S, taus, rtol, atol, tables.bg.y, tables.bg.y2, tables.th.y,
                            tables.th.y2) + 6 * 8 * nl, flops)
    return dict(max_abs_err=max_abs, ms=ms, plain_ms=plain_ms, plain_lanes=len(sel),
                kernel_lanes=nl, nsteps_max_diff=int(dn.max()), bound_ms=bms, bound_by=bby,
                gauge=idx.gauge, nsteps_max=int(nsteps[slow]), nsteps_max_k=float(lanes.k[slow]),
                tail_lanes_compared=n_tail, scaled_err=worst,
                **({} if ic is None else dict(iso_steps_equal=iso_equal)))


def each_call(kname, captured, kernel, plain):
    """Every call the path made of a kernel's wrapper, again through the
    kernel and through its plain version: (max |kernel - plain|, the largest
    per-element |kernel - plain| / |plain|, the rows of all calls)."""
    import torch

    max_abs, worst, rows = 0.0, 0.0, 0
    for args, kw in captured[kname + "/all"]:
        kout, pout = kernel(*args, **kw), plain(*args, **kw)
        if kout.shape != pout.shape or not bool(torch.isfinite(kout).all()):
            raise RuntimeError(f"{kname}: kernel output of shape {tuple(kout.shape)} against "
                               f"{tuple(pout.shape)}, or not finite")
        diff = (kout - pout).abs()
        max_abs = max(max_abs, float(diff.max()))
        worst = max(worst, float((diff / pout.abs().clamp_min(1e-300)).max()))
        rows += args[0].shape[0]
    return max_abs, worst, rows


def check_hmcode_sigma(nonlinear, captured, tag):
    """hmcode_sigma against its plain version on every call the path made
    (every row's radii, the two Newton steps and r_nl, of each
    compute_nonlinear), per element; timed on the largest call. Work: per
    (spectrum, R, k) a sincos and ~30 operations above x = 0.01, ~15 below."""
    max_abs, worst, rows = each_call("hmcode_sigma", captured, nonlinear.hmcode_sigma,
                                     nonlinear.hmcode_sigma_plain)
    base, k, lnk, R = captured["hmcode_sigma"][0]
    ms, kout = timed(lambda: nonlinear.hmcode_sigma(base, k, lnk, R))
    plain_ms, _ = timed(lambda: nonlinear.hmcode_sigma_plain(base, k, lnk, R), 1, False)
    n = base.shape[0] * R.shape[1] * k.shape[0]
    small = int(sum(int((k[None, :] * R[i][:, None] < 0.01).sum()) for i in range(R.shape[0])))
    bms, bby = bound(nbytes(base, k, lnk, R, kout), 70.0 * (n - small) + 15.0 * small)
    calls = len(captured["hmcode_sigma/all"])
    print(f"[hmcode_sigma] {tag}: {calls} calls, {rows} spectra in all; the largest: base "
          f"{tuple(base.shape)} R {tuple(R.shape)} ({small} of {n} nodes below x = 0.01); "
          f"per-element error {worst:.3e} (limit {HMCODE_TOL}); kernel {ms:.3f} ms, plain "
          f"{plain_ms:.1f} ms", flush=True)
    return dict(ms=ms, plain_ms=plain_ms, bound_ms=bms, bound_by=bby, max_abs_err=max_abs,
                scaled_err=worst, calls=calls, spectra=rows, nspec=int(base.shape[0]),
                nR=int(R.shape[1]), nk=int(k.shape[0]))


def check_hmcode_onehalo(nonlinear, captured, tag):
    """hmcode_onehalo against its plain version on every call the path made
    (every row of each compute_nonlinear), per element; timed on the largest
    call. Work, counted from the run's data over the nodes with nu <= 10: two
    Si/Ci per node, the series (30 terms, ~12 operations each, and a log)
    below x = 4, else the Lentz steps (60, ~35 operations each, and a
    sincos), and ~200 more for the mass function, the powers and the window."""
    import torch

    max_abs, worst, rows = each_call("hmcode_onehalo", captured, nonlinear.hmcode_onehalo,
                                     nonlinear.hmcode_onehalo_plain)
    nu, m, rv, conc, eta, k = captured["hmcode_onehalo"][0]
    ms, kout = timed(lambda: nonlinear.hmcode_onehalo(nu, m, rv, conc, eta, k))
    plain_ms, _ = timed(lambda: nonlinear.hmcode_onehalo_plain(nu, m, rv, conc, eta, k), 1,
                        False)
    ks = nu[:, None, :] ** eta[:, None, None] * k[None, :, None] * rv[:, None, :] \
        / conc[:, None, :]

    def si_ci_ops(x):
        return torch.where(x < 4.0, 30 * 12.0 + 20.0, 60 * 35.0 + 40.0)

    live = (nu <= 10.0)[:, None, :]
    ops = (si_ci_ops(ks) + si_ci_ops(ks * (1.0 + conc[:, None, :])) + 200.0) * live
    bms, bby = bound(nbytes(nu, m, rv, conc, eta, k, kout), float(ops.sum()))
    calls = len(captured["hmcode_onehalo/all"])
    print(f"[hmcode_onehalo] {tag}: {calls} calls, {rows} rows in all; the largest: nu "
          f"{tuple(nu.shape)} k {tuple(k.shape)}, {int(live.sum())} of {nu.numel()} masses at "
          f"nu <= 10, {float((ks < 4.0).double().mean()):.3f} of first arguments below 4; "
          f"per-element error {worst:.3e} (limit {HMCODE_TOL}); kernel {ms:.3f} ms, plain "
          f"{plain_ms:.1f} ms", flush=True)
    return dict(ms=ms, plain_ms=plain_ms, bound_ms=bms, bound_by=bby, max_abs_err=max_abs,
                scaled_err=worst, calls=calls, rows=rows, nrow=int(nu.shape[0]),
                nm=int(nu.shape[1]), nk=int(k.shape[0]))


def host_timed(fn):
    """Host wall time of one call of fn() in ms (for the plain host loops) and
    its result; the card is synchronised before and after."""
    import torch

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) * 1e3, out


def check_recfast(thermo, args, tag):
    """recfast_history against its plain loop, per row and column; prints the
    first interval where the two differ by more than 1e-12."""
    import torch

    rp, H, Nz, *inj_conv = args
    ms, kout = timed(lambda: thermo.recfast_history(rp, H, Nz, *inj_conv))
    plain_ms, pout = host_timed(lambda: thermo.recfast_history_plain(rp, H, Nz, *inj_conv))
    k, p = kout.cpu(), pout.cpu()
    if k.shape != p.shape or not bool(torch.isfinite(k).all()):
        raise RuntimeError(f"recfast_history ({tag}): shape {tuple(k.shape)} or non-finite")
    rel = (k - p).abs() / p.abs().clamp_min(1e-300)
    worst = {n: float(rel[i].max()) for i, n in enumerate(thermo.RECO_COLUMNS)}
    over = torch.nonzero(rel.max(dim=0).values > 1e-12).flatten()
    first = Nz - 1 - int(over.max()) if len(over) else None   # row Nz-1-i is interval i
    # the derivative evaluations this history needed: one per interval for
    # dT/dz, sixteen per interval once the HeI Saha phase has ended
    pv = dict(zip(thermo.RF_PARAMS, rp.tolist()))
    z_desc, xe_desc = p[0].flip(0).tolist(), p[1].flip(0).tolist()
    y1, n_int = 1.0, 0
    for i, (z, xe) in enumerate(zip(z_desc, xe_desc)):
        if z <= pv["zHe3"] + pv["dzHe3"]:
            if not y1 > pv["trigHe"]:
                n_int = Nz - i
                break
            y1 = (xe - 1.0) / pv["fHe"]
    # ~350 operations per derivative evaluation (fourteen exp/pow/log/sqrt),
    # ~250 more with energy injection (the rate and the two chi fits); the
    # ln E spline of the injection beyond the spot read once
    inj_on = pv["inj_on"] != 0.0
    extra = nbytes(inj_conv[0].y, inj_conv[0].y2) if inj_conv and inj_conv[0] is not None else 0
    bms, bby = bound(nbytes(rp, H.y, H.y2, kout) + extra,
                     (600.0 if inj_on else 350.0) * (Nz + 16.0 * n_int))
    print(f"[recfast_history] {tag}: injection {'on' if inj_on else 'off'}"
          f"{' (beyond the spot)' if extra else ''}; {Nz} intervals, {n_int} integrated; "
          f"worst relative "
          f"difference per column {worst} (limit {RECFAST_TOL}); first interval over 1e-12: "
          f"{first}" + (f" (z = {float(p[0][Nz - 1 - first]):.2f})" if first is not None else ""),
          flush=True)
    if not max(worst.values()) <= RECFAST_TOL:
        raise RuntimeError(f"recfast_history ({tag}) disagrees with its plain loop: {worst}")
    return dict(max_abs_err=float((k - p).abs().max()), max_rel_err=max(worst.values()),
                ms=ms, plain_ms=plain_ms, bound_ms=bms, bound_by=bby,
                scaled_err=max(worst.values()) / RECFAST_TOL, first_interval_over_1e12=first)


def check_hyrec(hyrec, args, tag):
    """hyrec_history against its plain loop, x_e and T_m per step; prints
    the phase transitions and the first step where the two differ by more
    than 1e-12."""
    import torch

    hp, tables, z, inj, model = args
    ms, (xe, Tm) = timed(lambda: hyrec.hyrec_history(hp, tables, z, inj, model))
    starts = []
    plain_ms, (xep, Tmp) = host_timed(lambda: hyrec.hyrec_history_plain(
        hp, tables, z, inj, model, phase_starts=starts))
    kout, pout = torch.stack([xe, Tm]).cpu(), torch.stack([xep, Tmp])
    if not bool(torch.isfinite(kout).all()):
        raise RuntimeError(f"hyrec_history ({tag}): non-finite output")
    rel = (kout - pout).abs() / pout.abs().clamp_min(1e-300)
    worst = {"x_e": float(rel[0].max()), "T_m": float(rel[1].max())}
    over = torch.nonzero(rel.max(dim=0).values > 1e-12).flatten()
    first = int(over[0]) if len(over) else None
    nz = int(z.shape[0])
    zs = z.cpu()
    # work: ~400 float64 operations a step (two Saha or rate evaluations with
    # their pow/exp/sqrt, the two-step update, T_m); in the two-photon model
    # each rate evaluation is ~190 operations per virtual bin (six exp/log and
    # the row arithmetic), the two 40-step wing recurrences, three 80-row
    # Thomas solves and eight 311-value sums: ~62 000
    at = dict(starts)
    n_2g = 0
    if model == "full":
        n_2g = 2 * (at[4] - at[3]) + (at[6] - at[4])
    flops = 400.0 * nz + 62000.0 * n_2g
    bms, bby = bound(nbytes(hp, *tables, z, xe, Tm) + (nbytes(inj) if inj is not None else 0),
                     flops)
    print(f"[hyrec_history] {tag}: model {model}, injection {'on' if inj is not None else 'off'}; "
          f"{nz} steps, {n_2g} two-photon rate evaluations; phases start at (phase, step, z) "
          + ", ".join(f"({p}, {j}, {float(zs[j]):.2f})" for p, j in starts if j < nz)
          + f"; worst relative difference {worst} (limit {HYREC_TOL}); first step over 1e-12: "
          f"{first}" + (f" (z = {float(zs[first]):.2f})" if first is not None else ""), flush=True)
    if not max(worst.values()) <= HYREC_TOL:
        raise RuntimeError(f"hyrec_history ({tag}) disagrees with its plain loop: {worst}")
    return dict(max_abs_err=float((kout - pout).abs().max()), max_rel_err=max(worst.values()),
                ms=ms, plain_ms=plain_ms, bound_ms=bms, bound_by=bby, model=model,
                two_photon_evaluations=n_2g, scaled_err=max(worst.values()) / HYREC_TOL,
                first_step_over_1e12=first)


def check_tensor_rkck(tensors, args, tag, curved=False):
    """The tensor integrator kernel against its plain version on every
    TENSOR_STRIDE-th lane and the last, or on a curved path on CURVED_LANES
    lanes from the lowest k to the highest, or on the paths of
    TENSOR_FEW_LANES on that many lowest-k lanes, the slowest lane and the
    highest-k lane, per lane and source column."""
    import torch

    lanes, taus, tables, rtol = args
    idx = tables.idx
    nl, n = lanes.k.shape[0], idx.size
    ms, (S, nsteps) = timed(lambda: tensors.tensor_rkck(lanes, taus, tables, rtol))
    if tag in TENSOR_FEW_LANES:
        picked = sorted(set(range(TENSOR_FEW_LANES[tag])) | {int(nsteps.argmax()), nl - 1})
    else:
        picked = compared_lanes(nl, TENSOR_STRIDE, curved, "tensor_rkck")
    sel = torch.as_tensor(picked, device=taus.device)
    a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    a.record()
    Sp, np_ = tensors.tensor_rkck_plain(lanes.take(sel), taus, tables, rtol)
    b.record()
    torch.cuda.synchronize()
    plain_ms = a.elapsed_time(b)
    if not bool(torch.isfinite(S).all()):
        raise RuntimeError(f"tensor_rkck ({tag}): kernel output is not finite")
    Sk = S[sel]
    scale = Sp.abs().amax(dim=1)                                   # (lanes, 2)
    err = (Sk - Sp).abs().amax(dim=1)
    lim = TENSOR_TOL_FACTOR * rtol * scale
    ratio = torch.where(lim > 0, err / lim, (err > 0).to(err.dtype))
    dn = (nsteps[sel] - np_).abs()
    dn_rel = float((dn / np_).max())
    if curved or idx.n_exact:
        print_lane_steps("tensor_rkck", tag, lanes.k[sel], nsteps[sel], np_)
    slow = int(nsteps.argmax())
    scratch = tensors.check_lane_scratch(idx)
    print(f"[tensor_rkck] {tag}: method {idx.method}, {idx.n_exact} exact ncdm species, lane "
          f"scratch {scratch} bytes; slowest lane k = "
          f"{float(lanes.k[slow]):.5g}/Mpc, {int(nsteps[slow])} steps", flush=True)
    print(f"[tensor_rkck] {tag}: {len(sel)} of {nl} lanes compared, state {n}; worst "
          f"{float(ratio.max()):.3e} of the limit {TENSOR_TOL_FACTOR} rtol scale (columns S_T2, "
          f"S_P: {[round(float(v), 6) for v in ratio.amax(dim=0)]}); max |nsteps_kernel - "
          f"nsteps_plain| {int(dn.max())} ({dn_rel:.3e} of the plain count, limit "
          f"{PERTURB_STEPS_TOL}); steps per lane max {int(nsteps.max())} mean "
          f"{float(nsteps.float().mean()):.1f}; plain {plain_ms:.0f} ms for {len(sel)} lanes, "
          f"kernel {ms:.2f} ms for {nl}", flush=True)
    if not float(ratio.max()) <= 1.0:
        raise RuntimeError(f"tensor_rkck ({tag}) disagrees with its plain version: "
                           f"{float(ratio.max()):.3e} of the limit")
    if not dn_rel <= PERTURB_STEPS_TOL:
        raise RuntimeError(f"tensor_rkck ({tag}): step counts {dn_rel:.3e} apart")
    # least work per attempted step: six right-hand sides (~12 operations per
    # component and ~60 for the scalars and table reads; per exact ncdm
    # (species, q) ~20 for its eps = sqrt(q^2 + (a m/T0)^2) and qk/eps, which
    # the kernel recomputes per entry but the function needs once, and ~25 for
    # the stress sum), the stage combinations (~21 per component) and the
    # solution and error (~14)
    n_sq = idx.n_exact * idx.q_size_ncdm
    flops = float(nsteps.sum()) * (6 * (12 * n + 60 + 45 * n_sq) + 35 * n)
    bms, bby = bound(nbytes(S, taus, tables.bg.y, tables.bg.y2, tables.th.y, tables.th.y2)
                     + 4 * 8 * nl, flops)
    return dict(max_abs_err=float(err.max()), ms=ms, plain_ms=plain_ms, plain_lanes=len(sel),
                kernel_lanes=nl, state=n, lane_scratch_bytes=scratch,
                nsteps_max=int(nsteps.max()), nsteps_max_k=float(lanes.k[slow]),
                nsteps_mean=float(nsteps.float().mean()), nsteps_max_diff=int(dn.max()),
                bound_ms=bms, bound_by=bby, scaled_err=float(ratio.max()))


def check_growth(background, args, tag):
    """growth_march against its plain loop: D and f per node, relative."""
    import torch

    spl, ts, aH, y0 = args
    ms, (D, f) = timed(lambda: background.growth_march(spl, ts, aH, y0))
    plain_ms, (Dp, fp) = host_timed(lambda: background.growth_march_plain(spl, ts, aH, y0))
    kout, pout = torch.stack([D, f]).cpu(), torch.stack([Dp, fp])
    if kout.shape != pout.shape or not bool(torch.isfinite(kout).all()):
        raise RuntimeError(f"growth_march ({tag}): shape {tuple(kout.shape)} or non-finite")
    rel = ((kout - pout).abs() / pout.abs().clamp_min(1e-300)).amax(dim=1)
    n = int(ts.shape[0])
    nsub = (n - 1) * background.GROWTH_SUBSTEPS
    # the spline at 3 times a sub-step (~25 operations a column with its two
    # pow) and the coefficients (~10), then ~40 a sub-step for its four
    # right-hand sides and the update; each input read and D, f written once
    bms, bby = bound(nbytes(spl.y, spl.y2, ts, aH) + 2 * 8 * n, nsub * (3 * 85.0 + 40.0))
    print(f"[growth_march] {tag}: {n} nodes, {nsub} sub-steps; worst relative difference D "
          f"{float(rel[0]):.3e}, f {float(rel[1]):.3e} (limit {GROWTH_TOL}); D(a_ini) "
          f"{float(D[0]):.6e}, f today {float(f[-1]):.6f}", flush=True)
    return dict(max_abs_err=float((kout - pout).abs().max()), max_rel_err=float(rel.max()),
                ms=ms, plain_ms=plain_ms, bound_ms=bms, bound_by=bby, nodes=n,
                scaled_err=float(rel.max()))


def check_idm_march(thermo, args, tag):
    """idm_march against its plain loop: T_idm and c^2_idm per column,
    relative to the column's max |plain|."""
    import torch

    z, H, T_idr, gam, m_idm = args
    ms, (T, c2) = timed(lambda: thermo.idm_march(z, H, T_idr, gam, m_idm))
    plain_ms, (Tp, c2p) = host_timed(lambda: thermo.idm_march_plain(
        *(v.cpu() for v in (z, H, T_idr, gam)), m_idm))
    kout, pout = torch.stack([T, c2]).cpu(), torch.stack([Tp, c2p])
    if kout.shape != pout.shape or not bool(torch.isfinite(kout).all()):
        raise RuntimeError(f"idm_march ({tag}): shape {tuple(kout.shape)} or non-finite")
    n = int(z.shape[0])
    cols = columns("idm_march", kout, pout, 0)
    equal = bool(torch.equal(kout, pout))
    # each of the four columns read once, T and c^2 written once; ~10
    # operations a step of the chain (two divisions) and ~12 a node of c^2
    bms, bby = bound(nbytes(z, H, T_idr, gam) + 2 * 8 * n, 22.0 * n)
    gh = (gam / H).cpu()
    print(f"[idm_march] {tag}: {n} nodes, Gamma/H from {float(gh.min()):.3e} to "
          f"{float(gh.max()):.3e}; kernel {ms:.3f} ms, plain {plain_ms:.1f} ms, bound {bms:.5f} ms "
          f"({bby}); |kernel - plain| {cols['scaled_err']:.3e} of a column's max (limit "
          f"{IDM_MARCH_TOL}), equal bits: {equal}; T_idm today {float(Tp[-1]):.4e} K against "
          f"T_idr {float(T_idr[-1]):.4e} K", flush=True)
    return dict(ms=ms, plain_ms=plain_ms, bound_ms=bms, bound_by=bby, nodes=n, equal_bits=equal,
                **cols)


def check_scf_march(background, captured, tag):
    """scf_march against its plain loop on two launches of the path, the first
    (the bisection's lo and hi) and the last (the final shot), per chain and
    column relative to the column's max |plain|; a launch of the bisection's
    31 midpoints timed; then the shooting walked again on the host with the
    plain loop, one shot at a time as JAX's loop walks it: the walks must be
    equal, or the two tuned values within SCF_LAMBDA_TOL where they part."""
    import torch

    from classpp_public_torch.tools.golden_check import SCF_LAMBDA

    calls = captured["scf_march/all"]
    res, worst, max_abs = {}, 0.0, 0.0
    for which, (args, kw) in (("first", calls[0]), ("final", calls[-1])):
        ms, kout = timed(lambda: background.scf_march(*args, **kw))
        plain_ms, pout = host_timed(lambda: background.scf_march_plain(*args, **kw))
        kout = kout.cpu()
        if kout.shape != pout.shape or not bool(torch.isfinite(kout).all()):
            raise RuntimeError(f"scf_march ({tag}, {which}): shape {tuple(kout.shape)} against "
                               f"{tuple(pout.shape)}, or not finite")
        diff = (kout - pout).abs()
        err = float((diff / pout.abs().amax(dim=1, keepdim=True).clamp_min(1e-300)).max())
        worst, max_abs = max(worst, err), max(max_abs, float(diff.max()))
        nc, n = int(kout.shape[0]), int(kout.shape[1])
        # per chain: 2 (n - 1) sub-steps of four right-hand sides (~45
        # operations: the exp ~20, the sqrt, two divisions) and the update
        # (~20); the table: 6 (n - 1) times of two exp and ~15 more
        flops = nc * 2.0 * (n - 1) * (4 * 45.0 + 20.0) + 6.0 * (n - 1) * 55.0
        bms, bby = bound(nbytes(*args[:4], kout), flops)
        res[which] = dict(ms=ms, plain_ms=plain_ms, bound_ms=bms, bound_by=bby, chains=nc,
                          scaled_err=err)
        print(f"[scf_march] {tag} {which} launch: {nc} chains x {n} nodes, kernel {ms:.3f} ms, "
              f"plain {plain_ms:.0f} ms, bound {bms:.4f} ms ({bby}); worst |kernel - plain| "
              f"{err:.3e} of a column's max (limit {SCF_MARCH_TOL})", flush=True)
    batch = [c for c in calls if c[0][0].shape[0] > 2]
    ms_batch = timed(lambda: background.scf_march(*batch[0][0]))[0] if batch else None
    bg, params = captured["scf_background"]
    ti = params.scf_tuning_index
    pars0 = list(params.scf_parameters) or [10.0, 0.0, 0.0, 0.0, 1.0, 0.0]
    args = calls[0][0]
    t0 = time.time()
    f_plain = background.scf_omega_err(lambda p4: background.scf_march_plain(p4, *args[1:]),
                                       pars0, ti, float(args[2][-1]), bg.H0, bg.scf_target)
    x_plain, walk_plain = background.shoot_scf(f_plain, pars0, ti, bg.scf_target,
                                               params.attractor_ic_scf, 0)
    plain_s = time.time() - t0
    x_card, walk = bg.scf_parameters[ti], list(bg.scf_walk)
    same = walk == walk_plain
    part = next((i for i, (a, b) in enumerate(zip(walk, walk_plain)) if a != b),
                min(len(walk), len(walk_plain)))
    rel = abs(x_card - x_plain) / abs(x_plain)
    print(f"[scf_march] {tag}: {len(calls)} launches, the walk read {len(walk)} shots; "
          f"tuned scf_parameters[{ti}] {x_card!r} (reference {SCF_LAMBDA}, rel "
          f"{abs(x_card / SCF_LAMBDA - 1):.2e}); the plain walk ({len(walk_plain)} shots, "
          f"{plain_s:.1f} s on the host) "
          + ("is the same tree path" if same else
             f"parts from the card's at shot {part}: card {walk[part:part + 2]}, plain "
             f"{walk_plain[part:part + 2]}")
          + f"; plain tuned value {x_plain!r}, rel {rel:.2e}; a launch of "
          f"{batch[0][0][0].shape[0] if batch else 0} chains {ms_batch} ms", flush=True)
    if not same and not rel <= SCF_LAMBDA_TOL:
        raise RuntimeError(f"scf_march ({tag}): the card's shooting found {x_card!r}, the plain "
                           f"one {x_plain!r}")
    final = res.pop("final")
    return dict(max_abs_err=max_abs, scaled_err=worst, **{k: v for k, v in final.items()
                                                             if k != "scaled_err"},
                first_launch=res["first"], ms_31_chains=ms_batch, walk_shots=len(walk),
                same_walk=same, tuned=x_card, tuned_plain=x_plain)


def scan_work(q, taus, tau0, l_emit, curved):
    """Float64 operations of a LOS scan on its (q, tau) grid: per point ~8 per
    l of the recurrence (~12 curved, with its division) and ~60 per emitted l
    (~90 curved: d2Phi, csc^2 and the radial functions), plus ~40 for the
    series at the points where it applies (x < 1; curved beta x = q chi < 1)."""
    n_pts = float(q.numel() * taus.numel())
    n_series = float(((q[:, None] * (tau0 - taus)[None, :]) < 1.0).sum())
    per_l, per_emit = (12.0, 90.0) if curved else (8.0, 60.0)
    return n_pts * (per_l * int(l_emit[-1]) + per_emit * len(l_emit)) \
        + 40.0 * n_series * len(l_emit)


def nc_scan_work(x, l_emit):
    """Float64 operations of the selection-window scan on its (row, k, tau)
    points: ~6 per l of the recurrence, ~25 per emitted l (the radial function
    and the sum), and ~40 more for the series where x < 1."""
    n_pts = float(x.numel())
    n_series = float((x < 1.0).sum())
    return n_pts * (6.0 * int(l_emit[-1]) + 25.0 * len(l_emit)) + 40.0 * n_series * len(l_emit)


def check_kernels(tag, captured, mods, curved):
    """Every kernel the main path `tag` launched against its plain version on
    the tensors the path fed it; returns {kernel: measurements}. Raises where
    a kernel is beyond its tolerance."""
    import torch

    out = {}
    if "hyrec_history" in captured:
        out["hyrec_history"] = check_hyrec(mods["hyrec_history"], captured["hyrec_history"][0],
                                           tag)
    if "integrate_sources" in captured and tag in REUSES:
        print(f"[perturb_ark] {tag}: no plain comparison; its source table equals "
              f"{REUSES[tag]}'s bit for bit (check_reuse)", flush=True)
    elif "integrate_sources" in captured:
        out["perturb_ark"] = check_perturb_ark(mods["perturb_ark"],
                                               captured["integrate_sources"][0], tag, curved)

    if "hmcode_sigma" in captured:
        out["hmcode_sigma"] = check_hmcode_sigma(mods["hmcode_sigma"], captured, tag)
    if "hmcode_onehalo" in captured:
        out["hmcode_onehalo"] = check_hmcode_onehalo(mods["hmcode_onehalo"], captured, tag)

    if "halofit_sums" in captured:
        nonlinear = mods["halofit_sigma"]
        base, k_hf, R = captured["halofit_sums"][0]
        ms, kout = timed(lambda: nonlinear.halofit_sums(base, k_hf, R))
        plain_ms, pout = timed(lambda: nonlinear.halofit_sums_plain(base, k_hf, R))
        # per (z, R, k): one exp and two log (~20 operations each) and ~15 more
        bms, bby = bound(nbytes(base, k_hf, R, kout), 75.0 * R.numel() * k_hf.numel())
        print(f"[halofit_sigma] {tag}: base {tuple(base.shape)} R {tuple(R.shape)}", flush=True)
        out["halofit_sigma"] = dict(ms=ms, plain_ms=plain_ms, bound_ms=bms, bound_by=bby,
                                    **columns("halofit_sigma", kout, pout, -1))

    transfer = mods["transfer_los"]
    for name in ("transfer_los", "transfer_los_curved"):
        if name not in captured:
            continue
        args, kw = captured[name]
        ms, kout = timed(lambda: getattr(transfer, name)(*args, **kw))
        plain_ms, pout = timed(lambda: getattr(transfer, name + "_plain")(*args, **kw), 1, False)
        W, taus, tau0, q = args[:4]
        l_emit = args[5 if name.endswith("curved") else 4]
        bms, bby = bound(nbytes(W, taus, q, kout),
                         scan_work(q, taus, tau0, l_emit, name.endswith("curved")))
        print(f"[{name}] {tag}: W {tuple(W.shape)} out {tuple(kout.shape)}", flush=True)
        out[name] = dict(ms=ms, plain_ms=plain_ms, bound_ms=bms, bound_by=bby,
                         **columns(name, kout, pout, 1))

    if "nc_scan" in captured:
        nc = mods["nc_scan"]
        args, kw = captured["nc_scan"]
        ms, kout = timed(lambda: nc.nc_scan(*args, **kw))
        plain_ms, pout = timed(lambda: nc.nc_scan_plain(*args, **kw), 1, False)
        x, Wrow, radial, l_emit = args[:4]
        bms, bby = bound(nbytes(x, Wrow, kout), nc_scan_work(x, l_emit))
        print(f"[nc_scan] {tag}: x {tuple(x.shape)} (rows, k, tau), {len(l_emit)} emitted l to "
              f"{int(l_emit[-1])}, radial codes {list(radial)}; out {tuple(kout.shape)}",
              flush=True)
        out["nc_scan"] = dict(ms=ms, plain_ms=plain_ms, bound_ms=bms, bound_by=bby,
                              nrow=int(x.shape[0]), nk=int(x.shape[1]), ntau=int(x.shape[2]),
                              nl=len(l_emit), **columns("nc_scan", kout, pout, 1))

    if "lensing_wigner" in captured:
        lensing = mods["lensing_wigner"]
        args, kw = captured["lensing_wigner"]
        ms, kout = timed(lambda: lensing.lensing_wigner(*args, **kw))
        plain_ms, pout = timed(lambda: lensing.lensing_wigner_plain(*args, **kw), 1, False)
        cl_of_l, mu, w8, l_lensed = args[:4]
        # per mu: ~190 operations per unlensed l (the two d of the deflection
        # variances, then the twelve Wigner recurrences and their sums) and
        # ~100 per lensed l of the back-transform
        bms, bby = bound(nbytes(cl_of_l, mu, w8, kout),
                         float(mu.numel()) * (190.0 * (cl_of_l.shape[0] - 1)
                                              + 100.0 * int(l_lensed)))
        print(f"[lensing_wigner] {tag}: unlensed BB max {float(cl_of_l[:, 3].abs().max()):.3e}",
              flush=True)
        out["lensing_wigner"] = dict(ms=ms, plain_ms=plain_ms, bound_ms=bms, bound_by=bby,
                                     **columns("lensing_wigner", kout, pout, 1))

    thermo = mods["recfast_history"]
    if "recfast_history" in captured:
        out["recfast_history"] = check_recfast(thermo, captured["recfast_history"][0], tag)
    if "tb_march" in captured:
        args, _ = captured["tb_march"]
        ms, (Tb, d) = timed(lambda: thermo.tb_march(*args))
        plain_ms, (Tbp, dp) = host_timed(lambda: thermo.tb_march_plain(*args))
        kout, pout = torch.stack([Tb, d]).cpu(), torch.stack([Tbp, dp])
        n = Tb.shape[0]
        # per node: the march step and dT/dz, ~30 operations each
        bms, bby = bound(nbytes(*args[:5], Tb, d), 60.0 * n)
        print(f"[tb_march] {tag}: {n} nodes, march from node {int(args[7])}", flush=True)
        out["tb_march"] = dict(ms=ms, plain_ms=plain_ms, bound_ms=bms, bound_by=bby,
                               **columns("tb_march", kout, pout, 0))

    if "growth_march" in captured:
        out["growth_march"] = check_growth(mods["growth_march"], captured["growth_march"][0], tag)
    if "scf_march" in captured:
        out["scf_march"] = check_scf_march(mods["scf_march"], captured, tag)
    if "idm_march" in captured:
        out["idm_march"] = check_idm_march(mods["idm_march"], captured["idm_march"][0], tag)
    if "tensor_rkck" in captured:
        out["tensor_rkck"] = check_tensor_rkck(mods["tensor_rkck"],
                                               captured["tensor_rkck"][0], tag, curved)
    for name in ("transfer_tensor_los", "transfer_tensor_los_curved"):
        if name not in captured:
            continue
        args, kw = captured[name]
        ms, kout = timed(lambda: getattr(transfer, name)(*args, **kw))
        plain_ms, pout = timed(lambda: getattr(transfer, name + "_plain")(*args, **kw), 1, False)
        W, taus, tau0, q = args[:4]
        l_emit = args[5 if name.endswith("curved") else 4]
        bms, bby = bound(nbytes(W, taus, q, kout),
                         scan_work(q, taus, tau0, l_emit, name.endswith("curved")))
        print(f"[{name}] {tag}: W {tuple(W.shape)} out {tuple(kout.shape)}", flush=True)
        out[name] = dict(ms=ms, plain_ms=plain_ms, bound_ms=bms, bound_by=bby,
                         **columns(name, kout, pout, 1))

    scaled = {k: v.pop("scaled_err") for k, v in out.items()}
    SCALED[tag] = scaled
    print(f"[kernels] {tag} scaled error: {scaled}; tolerance {KERNEL_TOL} of max |plain|, "
          f"recfast_history {RECFAST_TOL} per row, hyrec_history {HYREC_TOL} per step, "
          f"perturb_ark and tensor_rkck 1.0 of their per-lane, per-column limits", flush=True)
    bad = [n for n, e in scaled.items() if not e <= KERNEL_TOL.get(n, 1.0)]
    if bad:
        raise RuntimeError(f"{tag}: kernels disagree with their plain versions beyond "
                           f"tolerance: {bad}")
    return out


REFINE = 4     # the refined-tau phase: 4 samples per interval of the path's grid


def refine_tau(taus, W, late=None):
    """The tau grid refined REFINE-fold (REFINE - 1 points inside each
    interval), the sources W / trapezoid weights splined in tau onto it (a
    natural cubic spline per (type, q)) and weighted by its trapezoid weights,
    and the late-source mask (a prefix of the grid) carried over."""
    import torch

    from classpp_public_torch.ops.quadrature import trapz_weights
    from classpp_public_torch.ops.splines import spline_d2, spline_eval

    n = taus.shape[0]
    f = torch.arange(REFINE, dtype=taus.dtype, device=taus.device) / REFINE
    t_new = torch.cat([(taus[:-1, None] + f[None, :] * torch.diff(taus)[:, None]).reshape(-1),
                       taus[-1:]]).contiguous()
    y = (W / trapz_weights(taus)).reshape(-1, n).T.contiguous()
    S_new = spline_eval(taus, y, spline_d2(taus, y), t_new).T.reshape(*W.shape[:-1], -1)
    W_new = (S_new * trapz_weights(t_new)).contiguous()
    late_new = None
    if late is not None:
        late_new = (t_new <= taus[late][-1]) if bool(late.any()) \
            else torch.zeros_like(t_new, dtype=torch.bool)
    return t_new, W_new, late_new


def check_refined_tau(captured, transfer):
    """The LOS scans no path runs past 1024 tau samples, on the inputs
    captured on g3_tensor and g8_curved with tau refined REFINE-fold, each
    against its plain version (launches made here are not counted)."""
    out = {}
    for tag, name in (("g3_tensor", "transfer_tensor_los"), ("g8_curved", "transfer_los_curved"),
                      ("g8_curved", "transfer_tensor_los_curved")):
        args, kw = captured[tag][name]
        i_late = 7 if name == "transfer_los_curved" else None
        t_new, W_new, late_new = refine_tau(args[1], args[0],
                                            args[i_late] if i_late is not None else None)
        new = [W_new, t_new] + list(args[2:])
        if i_late is not None:
            new[i_late] = late_new
        ms, kout = timed(lambda: getattr(transfer, name)(*new, **kw))
        plain_ms, pout = timed(lambda: getattr(transfer, name + "_plain")(*new, **kw), 1, False)
        tau0, q = new[2], new[3]
        l_emit = new[5 if name.endswith("curved") else 4]
        bms, bby = bound(nbytes(W_new, t_new, q, kout),
                         scan_work(q, t_new, tau0, l_emit, name.endswith("curved")))
        res = dict(ms=ms, plain_ms=plain_ms, bound_ms=bms, bound_by=bby, ntau=int(t_new.shape[0]),
                   from_path=tag, **columns(name, kout, pout, 1))
        print(f"[refined_tau] {name} on {tag}'s inputs: tau {int(args[1].shape[0])} -> "
              f"{res['ntau']}, W {tuple(W_new.shape)}; scaled error {res['scaled_err']:.3e} "
              f"(limit {KERNEL_TOL[name]}); kernel {ms:.2f} ms, plain {plain_ms:.0f} ms",
              flush=True)
        if not res["scaled_err"] <= KERNEL_TOL[name]:
            raise RuntimeError(f"{name} with {res['ntau']} tau samples disagrees with its plain "
                               f"version: {res['scaled_err']:.3e}")
        res.pop("scaled_err")
        out[name] = res
    return out


# The scaled errors (kernel vs plain) that chip_smoke.py printed at commit
# 5099a0e for the paths it drove (NVIDIA H100 80GB HBM3, 700 W): the exact
# ncdm block and the growth march add code that those paths do not run
# (tensor_rkck with no exact species runs the arithmetic it ran; D and f feed
# no other stage), so each should print the same error again.
PRIOR_SCALED_ERR = {
    "planck_row2": {"perturb_ark": 0.5618799667387414, "halofit_sigma": 1.8478273803406114e-16,
        "transfer_los": 4.4437836747931904e-08, "lensing_wigner": 1.0221964890521095e-12,
        "recfast_history": 0.05939776493160124, "tb_march": 7.9324953437532275e-16},
    "row2_exact": {"perturb_ark": 1.0931460285967364e-08, "halofit_sigma": 3.6640293745745595e-16,
        "transfer_los": 4.057055956343156e-08, "lensing_wigner": 1.0195875815053596e-12,
        "recfast_history": 0.030823707573104573, "tb_march": 5.299930513032124e-16},
    "g3_tensor": {"perturb_ark": 1.1530214980152129e-09, "transfer_los": 4.018858338393332e-08,
        "lensing_wigner": 1.3090935683406288e-15, "recfast_history": 0.02217806901964524,
        "tb_march": 7.954893429391944e-16, "tensor_rkck": 5.804170502089567e-10,
        "transfer_tensor_los": 5.439818822737725e-09},
    "g8_curved": {"perturb_ark": 7.501770789471937e-10, "halofit_sigma": 2.0926156718595554e-16,
        "transfer_los_curved": 6.903038776810008e-08, "lensing_wigner": 1.1788036695546696e-15,
        "recfast_history": 0.022177995424852798, "tb_march": 7.928849762594652e-16,
        "tensor_rkck": 5.479404707179538e-10, "transfer_tensor_los_curved": 9.884294630760786e-09},
    "g18_closed": {"perturb_ark": 1.5067570433155278e-09, "halofit_sigma": 1.9085498999199042e-16,
        "transfer_los_curved": 6.922692846799493e-08, "lensing_wigner": 1.3580517155419417e-15,
        "recfast_history": 0.022178142614441357, "tb_march": 6.648995482642576e-16,
        "tensor_rkck": 5.65304219488308e-10, "transfer_tensor_los_curved": 9.599384839663895e-09},
    "g5_hyrec": {"hyrec_history": 8.817051442044188e-05, "perturb_ark": 0.617022186890438,
        "halofit_sigma": 3.6862683191296e-16, "transfer_los": 3.552546515277659e-08,
        "lensing_wigner": 1.0427296633166732e-12, "tb_march": 9.271980157426458e-16},
    "g16_injection": {"perturb_ark": 1.0161939060221722e-09,
        "transfer_los": 6.041295582295815e-08, "lensing_wigner": 1.082365828072719e-12,
        "recfast_history": 0.030823440562491658, "tb_march": 1.062814871099748e-15},
    "g22_injection_bos": {"perturb_ark": 7.385876591101924e-10,
        "transfer_los": 4.798350890044443e-08, "lensing_wigner": 1.0632382840535906e-12,
        "recfast_history": 0.030823440562491658, "tb_march": 7.258420508201523e-16},
    "g11a_reio_bins": {"perturb_ark": 1.1530214980152129e-09,
        "transfer_los": 2.3626296479071612e-08, "lensing_wigner": 1.0662069256103238e-12,
        "recfast_history": 0.02217806901964524, "tb_march": 7.602493887529517e-16},
    "g11b_reio_manytanh": {"perturb_ark": 1.1530214980152129e-09,
        "transfer_los": 5.0203211734954065e-08, "lensing_wigner": 1.0918470304619696e-12,
        "recfast_history": 0.02217806901964524, "tb_march": 7.238316065464541e-16},
    "planck_row2_ss005": {"perturb_ark": 0.5975413179200423,
        "halofit_sigma": 2.3239407699957674e-16, "transfer_los": 4.716831185786212e-08,
        "lensing_wigner": 1.0267924229106014e-12, "recfast_history": 0.05939776493160124,
        "tb_march": 7.9324953437532275e-16},
    "ncdm_row3": {"perturb_ark": 1.096137864220525e-09, "halofit_sigma": 1.932804585615471e-16,
        "transfer_los": 4.824569866179129e-08, "lensing_wigner": 1.012234581257675e-12,
        "recfast_history": 0.02232957887283823, "tb_march": 7.916140485037109e-16},
    "g19_ncl_full": {"perturb_ark": 1.1530214980152129e-09, "nc_scan": 3.219394003757003e-09,
        "recfast_history": 0.02217806901964524, "tb_march": 7.954893429391944e-16},
    "g27_pd": {"perturb_ark": 1.3050447557740227e-09, "transfer_los": 4.018858338393332e-08,
        "nc_scan": 3.219394003757003e-09, "lensing_wigner": 1.015216790636024e-12,
        "recfast_history": 0.02217806901964524, "tb_march": 7.954893429391944e-16},
    "nc_des_y1": {"perturb_ark": 5.036052639094108e-05, "nc_scan": 5.8245299606316415e-09,
        "recfast_history": 0.02217806901964524, "tb_march": 7.954893429391944e-16},
    "hyrec_full": {"hyrec_history": 0.0008261464041298425, "tb_march": 6.628786035995634e-16},
}
SCALED = {}   # this run's scaled errors, by path and kernel (check_kernels)


def compare_prior():
    """Each (path, kernel) scaled error beside the one printed at 5099a0e."""
    same, diff = [], []
    for tag, kerr in PRIOR_SCALED_ERR.items():
        for kname, old in kerr.items():
            new = SCALED.get(tag, {}).get(kname)
            (same if new == old else diff).append(f"{tag}/{kname}: now {new!r}, then {old!r}")
    print(f"[unchanged] {len(same)} of {len(same) + len(diff)} scaled errors equal to those "
          f"printed at 5099a0e"
          + ("; differing: " + "; ".join(diff) if diff else ""), flush=True)


def kernel_table():
    """The seventeen kernels, each with the wrapper the main path calls."""
    from classpp_public_torch.models import (background, hyrec, lensing, nonlinear,
                                             numbercounts, thermodynamics, transfer)
    from classpp_public_torch.models.perturbations import solve, tensors

    src, tpu = "classpp_public_torch/csrc/", "classpp_public_tpu/models/"
    return [
        Kernel("perturb_ark", solve, "launches", "integrate_sources", src + "perturb_ark.cu",
               tpu + "perturbations/solve.py:151"),
        Kernel("halofit_sigma", nonlinear, "launches", "halofit_sums", src + "halofit_sigma.cu",
               tpu + "nonlinear.py:433", size=lambda a: a[2].numel()),
        Kernel("transfer_los", transfer, "launches", "transfer_los", src + "transfer_los.cu",
               tpu + "transfer.py:360", size=lambda a: a[0].numel()),
        Kernel("lensing_wigner", lensing, "launches", "lensing_wigner",
               src + "lensing_wigner.cu", tpu + "lensing.py:94"),
        Kernel("recfast_history", thermodynamics, "recfast_launches", "recfast_history",
               src + "recfast.cu", tpu + "thermodynamics.py:443"),
        Kernel("tb_march", thermodynamics, "tb_march_launches", "tb_march", src + "recfast.cu",
               tpu + "thermodynamics.py:742"),
        Kernel("tensor_rkck", tensors, "launches", "tensor_rkck", src + "tensor_rkck.cu",
               tpu + "perturbations/tensors.py:384"),
        Kernel("transfer_tensor_los", transfer, "tensor_launches", "transfer_tensor_los",
               src + "transfer_tensor_los.cu", tpu + "transfer.py:854"),
        Kernel("transfer_los_curved", transfer, "curved_launches", "transfer_los_curved",
               src + "transfer_los_curved.cu", tpu + "transfer.py:534"),
        Kernel("transfer_tensor_los_curved", transfer, "tensor_curved_launches",
               "transfer_tensor_los_curved", src + "transfer_tensor_los_curved.cu",
               tpu + "transfer.py:757"),
        Kernel("hyrec_history", hyrec, "launches", "hyrec_history", src + "hyrec.cu",
               tpu + "hyrec.py:781"),
        Kernel("nc_scan", numbercounts, "launches", "nc_scan", src + "nc_scan.cu",
               tpu + "numbercounts.py:629", size=lambda a: a[0].numel()),
        Kernel("growth_march", background, "growth_launches", "growth_march",
               src + "growth_march.cu", "classpp_public_tpu/ops/ode.py:305"),
        Kernel("hmcode_sigma", nonlinear, "hmcode_sigma_launches", "hmcode_sigma",
               src + "hmcode_sigma.cu", tpu + "nonlinear.py:211",
               size=lambda a: a[0].shape[0] * a[3].shape[1], every=True),
        Kernel("hmcode_onehalo", nonlinear, "hmcode_onehalo_launches", "hmcode_onehalo",
               src + "hmcode_onehalo.cu", tpu + "nonlinear.py:349",
               size=lambda a: a[0].numel() * a[5].numel(), every=True),
        Kernel("scf_march", background, "scf_launches", "scf_march", src + "scf_march.cu",
               tpu + "background.py:302", every=True),
        Kernel("idm_march", thermodynamics, "idm_march_launches", "idm_march",
               src + "idm_march.cu", tpu + "thermodynamics.py:1017"),
    ]


def main():
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is False)",
              file=sys.stderr)
        return 1
    sys.path.insert(0, ROOT)
    from classpp_public_torch.models import transfer
    from classpp_public_torch.ops import cuda
    from classpp_public_torch.tools.configs import CONFIGS, TENSOR_ONLY, THERMO_ONLY

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         check=True).stdout.strip().splitlines()[0]
    print(f"[card] {smi}", flush=True)
    print(f"[env] python {sys.version.split()[0]} torch {torch.__version__} "
          f"cuda {torch.version.cuda}", flush=True)

    t0 = time.time()
    lib_path = cuda.build(verbose=True)
    cuda.library()
    phase(f"build kernels ({os.path.relpath(lib_path, ROOT)})", t0)

    kernels = kernel_table()
    mods = {k.name: k.module for k in kernels}
    # --- the main paths, each with its own launch counts and reference check
    counts, captured = {}, {}
    for tag, params in CONFIGS.items():
        counts[tag], captured[tag], _ = run_config(tag, params, kernels)
    for tag, params in THERMO_ONLY.items():
        counts[tag], captured[tag], _ = run_config(tag, params, kernels, "thermodynamics")
    for tag, params in TENSOR_ONLY.items():
        counts[tag], captured[tag], _ = run_config(tag, params, kernels, "tensor_perturbations")
    paths = {**CONFIGS, **THERMO_ONLY, **TENSOR_ONLY}

    # --- each kernel against its plain version, on the tensors of each path
    results = {}
    for tag, params in paths.items():
        t0 = time.time()
        results[tag] = check_kernels(tag, captured[tag], mods, params.get("Omega_k", 0.0) != 0.0)
        phase(f"{tag} kernel vs plain comparison", t0)

    t0 = time.time()
    refined = check_refined_tau(captured, transfer)
    phase("refined-tau LOS scans vs plain", t0)
    compare_prior()

    # one entry per kernel: the numbers of the last path that ran it (its
    # launches beside its times) head the entry, and those of the other paths
    # that ran it follow under their names (the refined-tau phase, whose
    # launches are not counted, under "refined_tau")
    entries = []
    for k in kernels:
        ran = [tag for tag in paths if k.name in results[tag]]
        if not ran:
            raise RuntimeError(f"{k.name}: no path ran the kernel")
        main_tag = ran[-1]
        e = dict(name=k.name, route="cuda", source=k.source, replaces=k.replaces,
                 launches=counts[main_tag][k.name], library_ms=None, path=main_tag,
                 **results[main_tag][k.name])
        for tag in paths:
            if tag != main_tag and k.name in results[tag]:
                e[tag] = dict(launches=counts[tag][k.name], library_ms=None,
                              **results[tag][k.name])
        if k.name in refined:
            e["refined_tau"] = dict(library_ms=None, **refined[k.name])
        entries.append(e)
    print(f"[time] command {time.time() - T_START:.1f} s", flush=True)
    print(json.dumps({"kernels": entries}), flush=True)
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

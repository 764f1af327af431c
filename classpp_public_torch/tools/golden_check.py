#!/usr/bin/env python3
"""The reference goldens' contracts, and a check of configurations against them.

`golden_check(name, raw, lensed, pk_lin, h, thermo, cls)` holds the spectra (and
for the thermodynamics variants the x_e history and tau_reio) of a run of the
configuration `name` to its golden (tests/golden/<name>.npz, built by the
reference C++ code; g11a/g11b share g11_reio.npz) under the contract of the
JAX package's test of that golden: g3_tensor (tests/test_extended.py:58-92),
g8_curved (tests/test_curved.py:176-196), g18_closed
(tests/test_curved.py:112-157), g29_open01 and g30_closed01
(tests/test_curved_large.py:43-102), g5_hyrec (tests/test_hyrec.py),
g16_injection and g22_injection_bos (tests/test_injection.py:40-66,
:121-147), g11a_reio_bins and g11b_reio_manytanh (tests/test_reio.py:51-90),
the number counts g7_ncl, g19_ncl_full and g27_pd (tests/test_numbercounts.py:
the autos against the golden, the crosses that pass through small values or
zero against the sqrt(auto x auto) envelope of the golden), g32_texact and
g33_tphotons (tests/test_tensor_method.py), g1_lcdm (tests/test_endtoend.py:37-80
and the growth factor of tests/test_background.py:77-92; g1_lcdm_halofit is the
same configuration with halofit on, as test_endtoend.py runs it), g1h_halofit
(tests/test_endtoend.py:83-100), g2_ncdm (tests/test_ncdm.py:39-97),
g8s_curved (tests/test_curved.py:39-89), g9_newt (the Newtonian gauge,
tests/test_newt_golden.py), and the isocurvature goldens g21_isocorr
(tests/test_isocurvature.py; each ic pair's C_l under tests/test_peric_output.py's
contract) and g31_peric (tests/test_peric_output.py: the pair C_l, the ad and
cdi P(k), the total P(k) and the sum total = ad + cdi + 2 cross), and HMcode's
g6_hmcode (tests/test_hmcode.py: the linear P(k) within 1e-2 and the HMcode
P(k) within 3e-2 at z = 0, 1, 3 on 1e-2 < k < 18/Mpc, k_nl rising with z,
0.05 < k_nl(0) < 1/Mpc), and scalar-field dark energy's g13_scf
(tests/test_scf.py: rho_scf, H and phi_scf over 0.01 < z < 1e10, Omega_scf
today, lensed TT and EE to l = 1100, P(k)), and interacting dark matter's
g17_idm_dr and g34_idmdr_l (tests/test_idm_dr.py: lensed TT and EE to
l = 1100 within 3e-3, P(k) for 1e-3 < k < 0.9/Mpc within 2e-2); and the probe
rows of
tests/golden/bench_probe.json (`probe_rel`; lcdm_row1 here, the others in
chip_smoke.py, which uses this module for its golden paths).

`gauge_check(name, newt, sync)` holds a Newtonian-gauge twin (configs.NEWT_TWIN:
row2_newt, g8_newt, g18_newt, g21_newt) to its synchronous configuration under
tests/test_gauge.py's contract; the script runs both of a twin.

Run as a script it drives configurations through Class(device="cuda") and
prints each measure against its limit with the multipole of the largest
error; it exits 1 if any is out of its contract.

Usage (from the repository root, needs one card and nvcc):
    python3 -m classpp_public_torch.tools.golden_check g29_open01 g30_closed01
    python3 -m classpp_public_torch.tools.golden_check g7_ncl g19_ncl_full g27_pd
    python3 -m classpp_public_torch.tools.golden_check g32_texact g33_tphotons g1_lcdm \
        g1_lcdm_halofit g1h_halofit g2_ncdm g8s_curved lcdm_row1
    python3 -m classpp_public_torch.tools.golden_check g9_newt row2_newt g8_newt g18_newt
    python3 -m classpp_public_torch.tools.golden_check g21_isocorr g31_peric g21_newt
    python3 -m classpp_public_torch.tools.golden_check g6_hmcode g13_scf
    python3 -m classpp_public_torch.tools.golden_check g17_idm_dr g34_idmdr_l
"""

import json
import os
import sys
import time

import numpy as np

GOLDEN_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..", "..", "tests",
                          "golden")
PROBE = os.path.join(GOLDEN_DIR, "bench_probe.json")
CL_TOL, PK_TOL = 3e-3, 1e-2
IDM_PK_TOL = 2e-2   # tests/test_idm_dr.py:73-76


def probe_rel(row, cl, pk, specs=("tt", "ee", "te")):
    """The bench.py rule (bench.py:91-118) against the probe row `row` of
    tests/golden/bench_probe.json: {rel_<spec>: worst relative error over the
    row's multipoles (TE against max(|TE|, 1e-3 TT))} for each of `specs`,
    which the row must hold, and rel_pk of P(k = 0.1/Mpc, z = 0)."""
    with open(PROBE) as f:
        ref = json.load(f)[row]
    worst = {}
    for spec in specs:
        errs = []
        for l_str, want in ref[spec].items():
            got = float(cl[spec][int(l_str)])
            den = abs(want) if spec != "te" else max(abs(want), 1e-3 * abs(ref["tt"][l_str]))
            errs.append(abs(got - want) / den)
        worst[f"rel_{spec}"] = max(errs)
    worst["rel_pk"] = abs(pk - ref["pk_0.1"]) / abs(ref["pk_0.1"])
    return worst


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

    def rel_pk(self, pk_lin, h, k_max=0.9, table="pk", z=0.0, k_min=1e-3, every=5):
        """(max relative error, its k in 1/Mpc) of P(k, z) against the golden
        table (every `every`-th k in k_min < k < k_max/Mpc, k and P in h
        units), as the JAX tests read it."""
        T = self.g[table]
        ks = T[:, 0] * h
        sel = (ks > k_min) & (ks < k_max)
        mine = np.array([pk_lin(k, z) for k in ks[sel][::every]])
        err = np.abs(mine / (T[sel, 1][::every] / h**3) - 1)
        return float(err.max()), float(ks[sel][::every][err.argmax()])

    def rel_growth(self, bg, bidx, zq):
        """(max of |D / D_golden - 1| and |f / f_golden - 1|, its z) at the
        background nodes nearest z = zq, the golden interpolated in ln a, as
        tests/test_background.py:77-92 reads it."""
        z_ref = self.col("background", "z")[1]
        loga_ref = -np.log1p(z_ref)
        order = np.argsort(loga_ref)
        loga, table = bg.loga.cpu().numpy(), bg.table.cpu().numpy()
        worst = (0.0, 0.0)
        for z in zq:
            i = int(np.argmin(np.abs(loga + np.log1p(z))))
            la = np.log(table[i, bidx["a"]])
            for name, col in (("gr.fac. D", "D"), ("gr.fac. f", "f")):
                ref = np.interp(la, loga_ref[order], self.col("background", name)[1][order])
                worst = max(worst, (abs(table[i, bidx[col]] - ref) / ref, z))
        return worst


    def rel_xe(self, table, thermo, zmin, zmax, log=False):
        """(max |x_e(mine) / x_e(golden) - 1| over zmin < z < zmax of the
        golden's table, its z): mine interpolated linearly in z, or in
        ln(1 + z) and ln x_e (log), as the JAX tests read it."""
        zr, xer = self.col(table, "z")[1], self.col(table, "x_e")[1]
        sel = (zr > zmin) & (zr < zmax)
        z_mine, xe_mine = np.asarray(thermo.z_grid), np.asarray(thermo.xe_of_z)
        if log:
            mine = np.exp(np.interp(np.log1p(zr[sel]), np.log1p(z_mine), np.log(xe_mine)))
        else:
            mine = np.interp(zr[sel], z_mine, xe_mine)
        err = np.abs(mine / xer[sel] - 1)
        return float(err.max()), float(zr[sel][err.argmax()])


    def nc_rel(self, key, mine, tol, env=None, lmax=300):
        """The measure of tests/test_numbercounts.py for the C_l `key` (a
        raw_cl key; its golden column contains it) at the golden's rows
        2 <= l <= lmax: |D_l(mine) / D_l(golden) - 1|, or with env = (key1,
        key2) |D_l(mine) - D_l(golden)| / sqrt(D_l^key1 D_l^key2) of the
        golden. Returns (max, tol, its l)."""
        cols = [str(c) for c in self.g["cl__cols"]]
        T = self.g["cl"]
        lr = T[:, 0].astype(int)
        m = (lr >= 2) & (lr <= lmax)
        ell = lr[m]

        def column(name):
            idx = [i for i, c in enumerate(cols) if name in c]
            if len(idx) != 1:
                raise KeyError(f"{name}: {len(idx)} golden columns match")
            return T[m, idx[0]]

        mine_dl = ell * (ell + 1) / (2 * np.pi) * np.asarray(mine)[ell]
        if env is None:
            err = np.abs(mine_dl / column(key) - 1)
        else:
            err = np.abs(mine_dl - column(key)) / np.sqrt(column(env[0]) * column(env[1]))
        return float(err.max()), tol, int(ell[err.argmax()])


def pair_cls(cls, lmax):
    """{(ic1, ic2): C_l (lmax + 1, 7) indexed by l} of each initial-condition
    pair of a Class run: the pair's C_l on the sparse l list splined to every
    integer l as the JAX output writer does (output.py:136-142)."""
    import torch

    from ..ops.splines import spline_d2, spline_eval

    sp = cls.cosmo.spectra
    l_f = sp.l_list.to(torch.float64)
    ells = torch.arange(2, lmax + 1, dtype=torch.float64, device=l_f.device)
    out = {}
    for pair, rows in sp.cl_pairs.items():
        vals = spline_eval(l_f, rows, spline_d2(l_f, rows), ells).cpu().numpy()
        out[pair] = np.concatenate([np.zeros((2, vals.shape[1])), vals])
    return out


def sum_identity(cls, lmax):
    """(max over l = 2..lmax and the TT, EE, TE columns of |total - (sum of
    the diagonal pairs + 2 sum of the others)| / max |total| of the column,
    its l): the raw C_l against its pairs (spectra_module.cpp:305-308)."""
    pairs = pair_cls(cls, lmax)
    tot = cls.cosmo.spectra.cl.cpu().numpy()[: lmax - 1]
    s = sum((1.0 if a == b else 2.0) * v[2:] for (a, b), v in pairs.items())
    worst = (0.0, 0)
    for c in range(3):
        err = np.abs(s[:, c] - tot[:, c]) / np.abs(tot[:, c]).max()
        worst = max(worst, (float(err.max()), int(err.argmax()) + 2))
    return worst


def pk_mode(cls, ic):
    """P(k, z) of the initial condition `ic` alone (the JAX writer's
    pk_<ic>.dat, output.py:178-200), log-log in k."""
    from ..models.nonlinear import pair_primordial_pk, pk_ic_deltas

    def pk(k, z):
        bg, _ = cls.cosmo.background
        pert = cls.cosmo.perturbations
        delta = pk_ic_deltas(pert, bg, float(z))[ic]
        val = 2.0 * np.pi**2 / pert.k**3 * pair_primordial_pk(cls.cosmo.primordial, ic, ic,
                                                                pert.k) * delta**2
        return float(np.exp(np.interp(np.log(k), np.log(pert.k_np),
                                      np.log(val.cpu().numpy()))))
    return pk


def iso_golden_check(name, g, raw, lensed, pk_lin, h, cls):
    """The contracts of the isocurvature goldens: g21_isocorr
    (tests/test_isocurvature.py: raw TT/EE 3e-3 to l = 2500, TE 3e-3 of
    sqrt(TT EE), lensed TT/EE 3e-3 to 2400) and g31_peric
    (tests/test_peric_output.py: total, ad and cdi P(k) 1e-2 over 1e-3 < k <
    0.6 h/Mpc, total = ad + cdi + 2 cross to 1e-10); each pair's C_l over
    l = 2..1100 (tests/test_peric_output.py): the autos 3e-3 relative, the
    crosses 3e-3 of the ad auto's largest value."""
    rel = {}
    if name == "g21_isocorr":
        rel["raw_tt"] = (*g.rel("cl", "TT", raw["tt"], 2, 2500), CL_TOL)
        rel["raw_ee"] = (*g.rel("cl", "EE", raw["ee"], 2, 2500), CL_TOL)
        rel["raw_te"] = (*g.rel_te("cl", raw["te"], 2500), CL_TOL)
        for n in ("tt", "ee"):
            rel[f"lensed_{n}"] = (*g.rel("cl_lensed", n.upper(), lensed[n], 2, 2400), CL_TOL)
    else:
        k_lo, k_hi = 1e-3 * h, 0.6 * h
        rel["pk"] = (*g.rel_pk(pk_lin, h, k_hi, "pk", 0.0, k_lo), PK_TOL)
        for ic in ("ad", "cdi"):
            rel[f"pk_{ic}"] = (*g.rel_pk(pk_mode(cls, ic), h, k_hi, f"pk_{ic}", 0.0, k_lo),
                               PK_TOL)
        v, at = sum_identity(cls, 1200)
        rel["sum_identity"] = (v, at, 1e-10)
    ell = np.arange(2, 1101)
    fac = ell * (ell + 1) / (2 * np.pi)
    for (n1, n2), cl in pair_cls(cls, 1100).items():
        tab = f"cls_{n1}" if n1 == n2 else f"cls_{n1}_{n2}"
        for c, col in ((0, "TT"), (1, "EE")):
            lr, ref = g.col(tab, col)
            mine, want = fac * cl[2:1101, c], np.interp(ell, lr, ref)
            if n1 == n2:
                err = np.abs(mine / want - 1)
            else:
                env = np.interp(ell, *g.col("cls_ad", col))
                err = np.abs(mine - want) / np.abs(env).max()
            rel[f"{tab}_{col}"] = (float(err.max()), int(ell[err.argmax()]), CL_TOL)
    return {k: (v, tol, at) for k, (v, at, tol) in rel.items()}


def nc_golden_check(name, raw):
    """The contracts of tests/test_numbercounts.py for g7_ncl, g19_ncl_full
    and g27_pd: {measure: (error, limit, l)}. raw: the raw_cl dict to l >= 300."""
    g = Golden(name)
    rel = {}
    dd = ("dens[1]-dens[1]", "dens[2]-dens[2]")
    if name in ("g7_ncl", "g19_ncl_full"):
        for k in dd:
            rel[k] = g.nc_rel(k, raw[k], 1e-2)
        rel["dens[1]-dens[2]"] = g.nc_rel("dens[1]-dens[2]", raw["dens[1]-dens[2]"], 1e-2, dd)
    if name == "g7_ncl":
        for k in ("lens[1]-lens[1]", "lens[1]-lens[2]", "lens[2]-lens[2]"):
            rel[k] = g.nc_rel(k, raw[k], 2.5e-2)
        for k in ("dens[1]-lens[1]", "dens[1]-lens[2]", "dens[2]-lens[2]"):
            rel[k] = g.nc_rel(k, raw[k], 2e-2)
        rel["dens[2]-lens[1]"] = g.nc_rel("dens[2]-lens[1]", raw["dens[2]-lens[1]"], 1e-2,
                                          ("dens[2]-dens[2]", "lens[1]-lens[1]"))
    elif name == "g19_ncl_full":
        for k in ("dens[1]-lens[1]", "dens[1]-lens[2]", "dens[2]-lens[2]"):
            rel[k] = g.nc_rel(k, raw[k], 1e-2, (f"dens[{k[5]}]-dens[{k[5]}]",
                                                 f"lens[{k[-2]}]-lens[{k[-2]}]"))
    elif name == "g27_pd":
        for b in (1, 2):
            rel[f"phi-dens[{b}]"] = g.nc_rel(f"phi-dens[{b}]", raw[f"phi-dens[{b}]"], 1e-2,
                                             ("phiphi", f"dens[{b}]-dens[{b}]"))
            # the T-dens extension within 1.05 of the Cauchy-Schwarz envelope
            ell = np.arange(2, 301)
            td, tt = raw[f"T-dens[{b}]"][ell], raw["tt"][ell]
            ratio = np.abs(td) / np.sqrt(tt * raw[f"dens[{b}]-dens[{b}]"][ell])
            rel[f"T-dens[{b}]_envelope"] = (float(ratio.max()), 1.05, int(ell[ratio.argmax()]))
        if "T-lens[1]" in raw:
            raise RuntimeError("g27_pd: T-lens present without sCl")
    return rel


# the thermodynamics variants: (golden file, table prefix, x_e table, x_e
# window and limit, reference tau_reio or None)
VARIANTS = {
    "g16_injection": ("g16_injection", "", "thermo", (50.0, 1500.0), 1e-3, None),
    "g22_injection_bos": ("g22_injection_bos", "", "thermodynamics", (50.0, 1500.0), 2e-3, None),
    "g11a_reio_bins": ("g11_reio", "g11a_", "g11a_thermo", (-1.0, 45.0), 3e-3, 0.080889),
    "g11b_reio_manytanh": ("g11_reio", "g11b_", "g11b_thermo", (-1.0, 45.0), 3e-3, 0.057604),
}


def hmcode_golden_check(g, h, nl):
    """g6_hmcode under tests/test_hmcode.py's contract: the linear and the
    HMcode P(k) tables at z = 0, 1, 3 (log-interpolated in k, every golden k
    in 1e-2 < k < 18/Mpc) within 1e-2 and 3e-2, k_nl rising with z
    (measure: the larger of k_nl(0)/k_nl(1) and k_nl(1)/k_nl(3), limit 1) and
    0.05 < k_nl(0) < 1/Mpc (measure: the larger of 0.05/k_nl(0) and k_nl(0),
    limit 1)."""
    lnk = np.log(nl.k.cpu().numpy())

    def row(table, iz):
        lnp = np.log(table[iz].cpu().numpy())
        return lambda k, z: float(np.exp(np.interp(np.log(k), lnk, lnp)))

    rel = {}
    for iz, z in enumerate((0.0, 1.0, 3.0)):
        rel[f"pk_lin_z{z:g}"] = g.rel_pk(row(nl.pk_lin, iz), h, 18.0, f"z{iz + 1}_pk", z, 1e-2, 1) \
            + (PK_TOL,)
        rel[f"pk_nl_z{z:g}"] = g.rel_pk(row(nl.pk_nl, iz), h, 18.0, f"z{iz + 1}_pk_nl", z, 1e-2,
                                        1) + (3e-2,)
    rel = {k: (v, tol, at) for k, (v, at, tol) in rel.items()}
    k_nl = nl.k_nl.cpu().numpy()
    rel["k_nl_rising"] = (float(max(k_nl[0] / k_nl[1], k_nl[1] / k_nl[2])), 1.0,
                          [float(v) for v in k_nl])
    rel["k_nl0_in_0.05_1"] = (float(max(0.05 / k_nl[0], k_nl[0])), 1.0, float(k_nl[0]))
    return rel


SCF_LAMBDA, SCF_OMEGA = 2.085983, 0.690026   # the reference's shooting (tests/test_scf.py)


def scf_golden_check(g, lensed, pk_lin, h, cls):
    """g13_scf under tests/test_scf.py's contract: rho_scf, H and phi_scf
    within 1e-3, 1e-4, 1e-3 over 0.01 < z < 1e10 of the golden's background
    (interpolated in ln(1 + z)), Omega_scf today within 1e-4 of the
    reference's 0.690026, lensed TT and EE within 3e-3 and 6e-3 to l = 1100,
    P(k) within 1e-2 for 1e-3 < k < 0.9/Mpc."""
    bg, bidx = cls.cosmo.background
    t = bg.table.cpu().numpy()
    z = 1.0 / t[:, bidx["a"]] - 1.0
    zr = g.col("background", "z")[1]
    sel = (zr > 0.01) & (zr < 1e10)
    rel = {}
    for col, gcol, tol in (("rho_scf", "(.)rho_scf", 1e-3), ("H", "H [1/Mpc]", 1e-4),
                           ("phi_scf", "phi_scf", 1e-3)):
        ref = g.col("background", gcol)[1][sel]
        mine = np.interp(np.log1p(zr[sel]), np.log1p(z[::-1]), t[::-1, bidx[col]])
        err = np.abs(mine / ref - 1)
        rel[f"bg_{col}"] = (float(err.max()), tol, float(zr[sel][err.argmax()]))
    om = float(t[-1, bidx["rho_scf"]] / t[-1, bidx["H"]] ** 2)
    rel["Omega_scf"] = (abs(om / SCF_OMEGA - 1), 1e-4, 0.0)
    rel["lensed_tt"] = (*g.rel("cl_lensed", "TT", lensed["tt"], 2, 1100)[:1], 3e-3,
                        g.rel("cl_lensed", "TT", lensed["tt"], 2, 1100)[1])
    rel["lensed_ee"] = (*g.rel("cl_lensed", "EE", lensed["ee"], 2, 1100)[:1], 6e-3,
                        g.rel("cl_lensed", "EE", lensed["ee"], 2, 1100)[1])
    rel["pk"] = (*g.rel_pk(pk_lin, h)[:1], PK_TOL, g.rel_pk(pk_lin, h)[1])
    return rel


def golden_check(name, raw, lensed, pk_lin, h, thermo=None, cls=None):
    """The contract of the golden `name`: {measure: (relative error, limit,
    where)}, where is the multipole (or k, or z) of the largest error. raw
    and lensed: C_l dicts indexed by l to 2500; pk_lin(k, z): the linear
    P(k); thermo: the ThermoResult (the thermodynamics variants); cls: the
    Class (g1_lcdm's growth factor, g1h_halofit's nonlinear P(k), g2_ncdm's
    background and P_cb)."""

    def item(measure, tol):
        return (measure[0], tol, measure[1])

    if name == "lcdm_row1":
        return {k: (v, PK_TOL if k == "rel_pk" else CL_TOL, "probe")
                for k, v in probe_rel(name, raw, pk_lin(0.1, 0.0), specs=("tt",)).items()}

    if name in ("g7_ncl", "g19_ncl_full", "g27_pd"):
        return nc_golden_check(name, raw)
    if name in ("g21_isocorr", "g31_peric"):
        return iso_golden_check(name, Golden(name), raw, lensed, pk_lin, h, cls)
    if name in VARIANTS:
        fname, pre, xe_table, (zmin, zmax), xe_tol, tau_ref = VARIANTS[name]
        g = Golden(fname)
        rel = {"x_e": item(g.rel_xe(xe_table, thermo, zmin, zmax), xe_tol)}
        if tau_ref is not None:
            rel["tau_reio"] = (abs(float(thermo.tau_reio) / tau_ref - 1), 2e-3, tau_ref)
        for n in ("tt", "ee"):
            rel[f"lensed_{n}"] = item(g.rel(pre + "cl_lensed", n.upper(), lensed[n], 2, 1100),
                                      CL_TOL)
        return rel
    g = Golden("g1_lcdm" if name == "g1_lcdm_halofit" else name)
    if name == "g5_hyrec":
        # x_e through recombination (log interpolation), raw and lensed
        # TT/EE, P(k) to 9/Mpc
        rel = {"x_e": item(g.rel_xe("thermodynamics", thermo, 200.0, 1800.0, log=True), 1e-3)}
        for n in ("tt", "ee"):
            rel[f"raw_{n}"] = item(g.rel("cl", n.upper(), raw[n], 2, 2500), CL_TOL)
            rel[f"lensed_{n}"] = item(g.rel("cl_lensed", n.upper(), lensed[n], 2, 2400), CL_TOL)
        rel["pk"] = item(g.rel_pk(pk_lin, h, k_max=9.0), PK_TOL)
        return rel

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
    if name in ("g32_texact", "g33_tphotons"):
        # raw TT/EE to l = 1200, the (pure tensor) raw BB to l = 400
        return {"raw_tt": item(g.rel("cl", "TT", raw["tt"], 2, 1200), CL_TOL),
                "raw_ee": item(g.rel("cl", "EE", raw["ee"], 2, 1200), CL_TOL),
                "raw_bb": item(g.rel("cl", "BB", raw["bb"], 2, 400), 1e-2)}
    if name == "g6_hmcode":
        return hmcode_golden_check(g, h, cls.cosmo.nonlinear)
    if name == "g13_scf":
        return scf_golden_check(g, lensed, pk_lin, h, cls)
    if name in ("g17_idm_dr", "g34_idmdr_l"):
        # tests/test_idm_dr.py: lensed TT/EE to l = 1100, P(k) within 2e-2
        # (1.4% at the dark acoustic feature near k ~ 0.03/Mpc, where the
        # reference takes its first-order tca_idm_dr and JAX the implicit
        # exchange)
        return {f"lensed_{n}": item(g.rel("cl_lensed", n.upper(), lensed[n], 2, 1100), CL_TOL)
                for n in ("tt", "ee")} | {"pk": item(g.rel_pk(pk_lin, h), IDM_PK_TOL)}
    if name == "g1h_halofit":
        # halofit P(k) at z = 0, 1, 3 for 1e-2 < k < 9/Mpc
        return {f"pk_nl_z{z:g}": item(g.rel_pk(cls.pk, h, 9.0, tab, z, 1e-2, 1), 2.5e-2)
                for tab, z in (("z1_pk_nl", 0.0), ("z2_pk_nl", 1.0), ("z3_pk_nl", 3.0))}
    if name in ("g1_lcdm", "g1_lcdm_halofit"):
        rel = {"raw_tt": item(g.rel("cl", "TT", raw["tt"], 2, 2500), CL_TOL),
               "raw_ee": item(g.rel("cl", "EE", raw["ee"], 2, 2500), CL_TOL),
               "raw_pp": item(g.rel("cl", "phiphi", raw["pp"], 2, 2500), 1e-2),
               "raw_te": item(g.rel_te("cl", raw["te"], 2500), CL_TOL)}
        for n in ("tt", "ee", "bb"):
            rel[f"lensed_{n}"] = item(g.rel("cl_lensed", n.upper(), lensed[n], 2, 2500), CL_TOL)
        for tab, z in (("z1_pk", 0.0), ("z2_pk", 1.0), ("z3_pk", 3.0)):
            rel[f"pk_z{z:g}"] = item(g.rel_pk(pk_lin, h, 9.0, tab, z, 2e-4, 7), PK_TOL)
        bg, bidx = cls.cosmo.background
        rel["growth_D_f"] = item(g.rel_growth(bg, bidx, (0.0, 0.5, 2.0, 10.0)), 2e-3)
        return rel
    if name == "g2_ncdm":
        # rho_ncdm at z = 100, raw TT/EE/phiphi, lensed TT/EE/BB, P and P_cb
        bg, bidx = cls.cosmo.background
        zb = g.col("background", "z")[1]
        ref = sum(g.col("background", f"(.)rho_ncdm[{i}]")[1] for i in range(3))
        table = bg.table.cpu().numpy()
        z_mine = 1.0 / table[:, bidx["a"]] - 1.0
        mine = sum(np.interp(100.0, z_mine[::-1], table[::-1, bidx[f"rho_ncdm{i}"]])
                   for i in range(3))
        rel = {"rho_ncdm_z100": (abs(mine / np.interp(100.0, zb[::-1], ref[::-1]) - 1), 1e-3,
                                 100.0)}
        for n, col, tol in (("tt", "TT", CL_TOL), ("ee", "EE", CL_TOL), ("pp", "phiphi", 1e-2)):
            rel[f"raw_{n}"] = item(g.rel("cl", col, raw[n], 2, 2500), tol)
        for n in ("tt", "ee", "bb"):
            rel[f"lensed_{n}"] = item(g.rel("cl_lensed", n.upper(), lensed[n], 2, 2498), CL_TOL)
        rel["pk"] = item(g.rel_pk(pk_lin, h, 9.0, "pk", 0.0, 2e-4, 9), PK_TOL)
        rel["pk_cb"] = item(g.rel_pk(cls.pk_cb_lin, h, 9.0, "pk_cb", 0.0, 2e-4, 9), PK_TOL)
        return rel
    if name == "g9_newt":
        # tests/test_newt_golden.py: raw TT/EE 3e-3 and phiphi 1e-2 to 2500,
        # TE 3e-3 of sqrt(TT EE), lensed TT/EE 3e-3 to 2400, P(k) 1e-2 for
        # 1e-3 < k < 9/Mpc
        return {"raw_tt": item(g.rel("cl", "TT", raw["tt"], 2, 2500), CL_TOL),
                "raw_ee": item(g.rel("cl", "EE", raw["ee"], 2, 2500), CL_TOL),
                "raw_pp": item(g.rel("cl", "phiphi", raw["pp"], 2, 2500), 1e-2),
                "raw_te": item(g.rel_te("cl", raw["te"], 2500), CL_TOL),
                "lensed_tt": item(g.rel("cl_lensed", "TT", lensed["tt"], 2, 2400), CL_TOL),
                "lensed_ee": item(g.rel("cl_lensed", "EE", lensed["ee"], 2, 2400), CL_TOL),
                "pk": item(g.rel_pk(pk_lin, h, k_max=9.0), PK_TOL)}
    if name == "g8s_curved":
        # raw TT/EE to 2500, phiphi 3e-2 to 2000, TE, lensed TT/EE to 2400, P(k)
        return {"raw_tt": item(g.rel("cl", "TT", raw["tt"], 2, 2500), CL_TOL),
                "raw_ee": item(g.rel("cl", "EE", raw["ee"], 2, 2500), CL_TOL),
                "raw_pp": item(g.rel("cl", "phiphi", raw["pp"], 2, 2000), 3e-2),
                "raw_te": item(g.rel_te("cl", raw["te"], 2500), CL_TOL),
                "lensed_tt": item(g.rel("cl_lensed", "TT", lensed["tt"], 2, 2400), CL_TOL),
                "lensed_ee": item(g.rel("cl_lensed", "EE", lensed["ee"], 2, 2400), CL_TOL),
                "pk": item(g.rel_pk(pk_lin, h), PK_TOL)}
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


GAUGE_CL_TOL, GAUGE_PK_TOL, GAUGE_S8_TOL = 1.5e-2, 5e-2, 1e-2
GAUGE_PK_K = np.geomspace(1e-3, 0.9, 24)   # 1/Mpc, tests/test_gauge.py:62


def gauge_summary(cls):
    """What gauge_check reads of a run: its raw and lensed C_l (to 2500, or
    None), P(k) at GAUGE_PK_K and sigma8 (None without mPk)."""
    out = cls.cosmo.out
    has_pk = out.has_pk
    return dict(raw=cls.raw_cl(2500), lensed=cls.lensed_cl(2500) if out.lensing else None,
                pk=np.array([cls.pk_lin(k, 0.0) for k in GAUGE_PK_K]) if has_pk else None,
                sigma8=cls.sigma8() if has_pk else None)


def gauge_check(name, newt, sync):
    """tests/test_gauge.py's contract between a Newtonian twin and its
    synchronous configuration, each a gauge_summary: {measure: (relative
    difference, limit, where)}. row2_newt: raw TT/EE/phiphi and TE (against
    sqrt(TT EE)) to l = 600, lensed TT/EE to 598, P(k) at 24 k in
    1e-3-0.9/Mpc and sigma8 (:35-68); g21_newt the same C_l (it has no P(k));
    g8_newt, g18_newt: raw TT to l = 400 (:71-90). Beside each gated
    measure, `<measure>_full` is the same over the whole range (to 2500,
    lensed 2400), printed and not held (limit None)."""

    def rel(key, spec, lmax, tol):
        a, b = np.asarray(sync[key][spec]), np.asarray(newt[key][spec])
        ell = np.arange(2, lmax + 1)
        err = np.abs(b[ell] / a[ell] - 1.0)
        return (float(err.max()), tol, int(ell[err.argmax()]))

    def rel_te(lmax, tol):
        a, b = sync["raw"], newt["raw"]
        ell = np.arange(2, lmax + 1)
        den = np.sqrt(np.asarray(a["tt"])[ell] * np.asarray(a["ee"])[ell])
        err = np.abs(np.asarray(b["te"])[ell] - np.asarray(a["te"])[ell]) / den
        return (float(err.max()), tol, int(ell[err.argmax()]))

    out = {}
    if name in ("row2_newt", "g21_newt"):
        for spec in ("tt", "ee", "pp"):
            out[f"raw_{spec}"] = rel("raw", spec, 600, GAUGE_CL_TOL)
            out[f"raw_{spec}_full"] = rel("raw", spec, 2500, None)
        out["raw_te"] = rel_te(600, GAUGE_CL_TOL)
        out["raw_te_full"] = rel_te(2500, None)
        for spec in ("tt", "ee"):
            out[f"lensed_{spec}"] = rel("lensed", spec, 598, GAUGE_CL_TOL)
            out[f"lensed_{spec}_full"] = rel("lensed", spec, 2400, None)
        if newt["pk"] is not None:
            err = np.abs(newt["pk"] / sync["pk"] - 1.0)
            out["pk"] = (float(err.max()), GAUGE_PK_TOL, float(GAUGE_PK_K[err.argmax()]))
            out["sigma8"] = (abs(newt["sigma8"] / sync["sigma8"] - 1.0), GAUGE_S8_TOL, 8.0)
    else:
        out["raw_tt"] = rel("raw", "tt", 400, GAUGE_CL_TOL)
        out["raw_tt_full"] = rel("raw", "tt", 2500, None)
    return out


def main():
    import torch

    import classpp_public_torch as cpt
    from .configs import CONFIGS, GOLDEN_ONLY, NEWT_TWIN

    names = sys.argv[1:] or sorted(GOLDEN_ONLY)
    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 1
    print(f"[card] {torch.cuda.get_device_name(0)}", flush=True)
    ok = True

    def run(name):
        c = cpt.Class(device="cuda")
        c.set(dict({**CONFIGS, **GOLDEN_ONLY}[name]))
        c.compute(["lensing"])
        torch.cuda.synchronize()
        return c

    for name in names:
        t0 = time.time()
        c = run(name)
        if name in NEWT_TWIN:
            newt = gauge_summary(c)
            rel = gauge_check(name, newt, gauge_summary(run(NEWT_TWIN[name])))
            if name in ("g8_newt", "g18_newt"):
                # the curved twins against the synchronous golden: printed
                ref = golden_check(NEWT_TWIN[name], newt["raw"], newt["lensed"], c.pk_lin,
                                   c.cosmo.params.h)
                print(f"[golden, not held] {name} against {NEWT_TWIN[name]}'s golden "
                      + json.dumps({k: {"rel": v, "tol": tol, "at": at}
                                    for k, (v, tol, at) in ref.items()}), flush=True)
        else:
            out = c.cosmo.out
            raw = c.raw_cl(2500 if out.has_cls else out.l_lss_max) \
                if out.has_cls or out.has_nc else None
            lensed = c.lensed_cl(2500) if out.lensing else None
            rel = golden_check(name, raw, lensed, c.pk_lin, c.cosmo.params.h,
                               c.cosmo.thermodynamics, c)
        bad = sorted(k for k, (v, tol, _) in rel.items() if tol is not None and not v <= tol)
        ok = ok and not bad
        print(f"[golden] {name} ({time.time() - t0:.3f} s) "
              + json.dumps({k: {"rel": v, "tol": tol, "at": at} for k, (v, tol, at) in rel.items()})
              + (f" OUT OF CONTRACT: {bad}" if bad else ""), flush=True)
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())

"""The parameter sets the port is driven with at full size.

`planck_row2`: flat LambdaCDM with massless neutrinos, lensed TT/TE/EE/phiphi
to l = 2500 and P(k) to k = 10/Mpc. `row2_exact`: the
base_2018_plikHM_TTTEEE_lowl_lowE_lensing parameter set, with one 0.06 eV
massive-neutrino species and halofit (P(k) to 20/Mpc). `g3_tensor`: the
tensor-mode golden configuration tests/golden/gen/g3_tensor.ini, uncut:
flat LambdaCDM with primordial gravitational waves (r = 0.1, n_t from the
slow-roll consistency relation), scalar and tensor C_l, lensed TT/EE/BB.
`g8_curved` and `g18_closed`: the curvature golden configurations
tests/golden/gen/g8_curved.ini (open, Omega_k = 0.01, n_t = scc) and
g18_closed.ini (closed, Omega_k = -0.01, n_t = 0), uncut: scalars and tensors
(r = 0.1, l_max_tensors 500), lensed C_l to l = 2500, P(k) to 1/Mpc.
`g29_open01` and `g30_closed01` (GOLDEN_ONLY): the same at Omega_k = +-0.1
(g29_open01.ini, g30_closed01.ini).

The thermodynamics variants, each a golden configuration uncut:
`g5_hyrec` (tests/golden/gen/g5_hyrec.ini: `recombination = HyRec`, lensed
TT/TE/EE/phiphi to l = 2500, P(k) to 10/Mpc); `g16_injection` and
`g22_injection_bos` (DM annihilation 1e-6 m^3/s/kg on the spot and beyond it,
l_max 1200); `g11a_reio_bins` and `g11b_reio_manytanh` (reio_bins_tanh with
three bins, reio_many_tanh with two jumps, l_max 1200). `hyrec_full`
(THERMO_ONLY): g5_hyrec's cosmology through the two-photon HyRec model, the
thermodynamics stage alone (no golden holds it).

The number counts and galaxy lensing: `g7_ncl` (GOLDEN_ONLY) and
`g19_ncl_full`, tests/golden/gen/g7_ncl.ini and g19_ncl_full.ini as
tests/test_numbercounts.py sets them (output = nCl,sCl, two Gaussian bins at
z = 0.5 and 1.0 of width 0.1, l_max_lss 300, non_diagonal 1; g19 with every
contribution, galaxy bias 1.2, 1.5 and magnification bias 0.1, 0.15);
`g27_pd` (g27_pd.ini: tCl,pCl,lCl,nCl, lensed, l_max 600, every
contribution: phi-dens and the T-dens extension); `nc_des_y1`: the g1
cosmology with the five DES Y1 redMaGiC lens bins (tophat, z = 0.225 ... 0.825,
half-width 0.075; arXiv:1708.01530) at their fiducial galaxy biases (1.45,
1.55, 1.65, 1.8, 2.0; arXiv:1706.09359), every contribution, every bin pair
(non_diagonal 4), l_max_lss 1000. And two variants of earlier paths:
`planck_row2_ss005`, planck_row2 at perturb_sampling_stepsize 0.05 (1179 tau
samples, a common precision boost), and `ncdm_row3` (bench.py:62-69), three
massive-neutrino species of 0.021934, 0.023582 and 0.054485 eV.

Tensor method `exact` with massive neutrinos: `g32_texact`
(tests/golden/gen/g32_texact.ini: one 0.06 eV ncdm species, N_ur = 2.0328,
r = 0.1, n_t = scc, lensed TT/EE/BB, l_max_scalars 1200, l_max_tensors 500),
and `texact_ncdm3` (TENSOR_ONLY): its tensor stage with ncdm_row3's three
species, whose Psi_l(q) block (state 896) needs 65 KB of lane scratch.

Held only by `golden_check` (GOLDEN_ONLY), each as its golden's JAX test
sets it: `g33_tphotons` (g32 with tensor method photons,
tests/test_tensor_method.py), `g1_lcdm` (g1_lcdm.ini: the g1 cosmology,
lensed C_l to 2500, P(k) to 10/Mpc at z = 0, 1, 3), `g1_lcdm_halofit` (the
same with halofit on, as tests/test_endtoend.py runs it against the g1_lcdm
golden, which was made without), `g1h_halofit` (g1h_halofit.ini: mPk only,
halofit at z = 0, 1, 3), `g2_ncdm`
(tests/test_ncdm.py: three species), `g8s_curved` (g8s_curved_scalar.ini:
scalars, Omega_k = 0.01) and `lcdm_row1` (bench.py:142-152: the default
cosmology, tCl and mPk, l_max 2500, P(k) to 1/Mpc; its probe row).

The Newtonian gauge: `g9_newt` (tests/golden/gen/g9_newt.ini uncut: flat
LambdaCDM with massless neutrinos, `gauge = newtonian`, lensed TT/TE/EE/phiphi
to l = 2500, P(k) to 10/Mpc; held to its golden under
tests/test_newt_golden.py's contract), and three cross-gauge twins, each an
earlier configuration with `gauge = newtonian` held to its synchronous run
under tests/test_gauge.py's contract (`NEWT_TWIN`): `row2_newt` (row2_exact:
one ncdm species, halofit), `g8_newt` (g8_curved: open, scalars and tensors)
and `g18_newt` (g18_closed: closed, scalars and tensors).

The isocurvature initial conditions: `g21_isocorr` (tests/golden/gen/
g21_isocorr.ini uncut: ad, cdi and nid with f_cdi 0.3, n_cdi 0.95, f_nid 0.2,
n_nid 1.05, c_ad_cdi -0.6 with n_ad_cdi 0.02, c_ad_nid 0.4, c_cdi_nid 0.25,
lensed C_l to l = 2500; Planck 2018 X, arXiv:1807.06211 section 10, fits such
correlated models), `g21_newt` (the same in the Newtonian gauge, held to
g21_isocorr's run under tests/test_gauge.py's contract; NEWT_TWIN),
`g31_peric` (g31_peric.ini: ad and cdi with c_ad_cdi -0.5, tCl, pCl and P(k)
to 1/Mpc, l_max 1200) and `row2_iso` (row2_exact with ic = ad, bi, niv,
f_bi 0.3, f_niv 0.2, c_ad_niv 0.3: the other two isocurvature modes with a
massive neutrino and halofit; no golden holds it).

HMcode-2016: `g6_hmcode` (tests/golden/gen/g6_hmcode.ini uncut: mPk only,
`non linear = hmcode` with the default feedback emu_dmonly, P(k) to 20/Mpc at
z = 0, 1, 3; held to its golden under tests/test_hmcode.py's contract) and
`row2_hmcode` (row2_exact with `non linear = hmcode` and c_min = 2.6, so
eta_0 = 0.98 - 0.12 c_min = 0.668: a baryon feedback inside the KiDS-1000
cosmic-shear prior A_bary in [2, 3.13], arXiv:2007.15633; lensed C_l whose
phi+psi source carries the HMcode ratio; no golden holds it). Both sample k
to 20/Mpc, as row2_exact does, so row2_hmcode's perturbations are
row2_exact's.

Scalar-field dark energy: `g13_scf` (tests/golden/gen/g13_scf.ini uncut:
Omega_Lambda = Omega_fld = 0 and Omega_scf = -1, so that the quintessence
field closes the budget, an exponential potential with attractor initial
conditions, scf_parameters 10, 0, 0, 0, 100, 0 with lambda (index 0) shot
for; lensed TT/TE/EE/phiphi to l = 1200, P(k) to 1/Mpc; held to its golden
under tests/test_scf.py's contract).

Interacting dark matter with interacting dark radiation (ETHOS idm_dr):
`g34_idmdr_l` (tests/golden/gen/g34_idmdr_l.ini uncut: N_idr 0.5, f_idm_dr 1
so that all the dark matter interacts, a_idm_dr 1e3 with nindex_idm_dr 4,
m_idm 1e9 eV, the per-l angular coefficients alpha_idm_dr 1.0, 1.2, 1.4 and
beta_idr 0.5, 1.0; lensed TT/TE/EE/phiphi to l = 1200, P(k) to 1/Mpc with its
dark acoustic oscillations, sampled 4 times as densely in k; held to its
golden under tests/test_idm_dr.py's contract), and `g17_idm_dr` (GOLDEN_ONLY:
g17_idm_dr.ini, the same model with the reference's default coefficients).

The output-file keys of the .ini files (headers, format, root, write
thermodynamics, *_verbose) are left out.
"""

PLANCK_ROW2 = {
    "h": 0.6736, "omega_b": 0.02237, "omega_cdm": 0.1200,
    "A_s": 2.0989e-9, "n_s": 0.9649, "tau_reio": 0.0544,
    "output": "tCl,pCl,lCl,mPk", "lensing": "yes",
    "l_max_scalars": 2500, "P_k_max_1/Mpc": 10.0, "z_pk": "0.",
}
ROW2_EXACT = {
    "H0": 67.32117, "omega_b": 0.02238280, "N_ur": 2.03066666667,
    "omega_cdm": 0.1201075, "N_ncdm": 1, "omega_ncdm": 0.0006451439,
    "YHe": 0.2454006, "tau_reio": 0.05430842,
    "n_s": 0.9660499, "A_s": 2.100549e-09,
    "non linear": "halofit",
    "output": "tCl,pCl,lCl,mPk", "lensing": "yes",
}
G3_TENSOR = {
    "h": 0.67810, "T_cmb": 2.7255, "omega_b": 0.02238280, "omega_cdm": 0.1201075,
    "N_ur": 3.046, "Omega_k": 0.0, "A_s": 2.100549e-09, "n_s": 0.9660499, "r": 0.1,
    "n_t": "scc", "tau_reio": 0.05430842, "YHe": "BBN", "recombination": "RECFAST",
    "output": "tCl,pCl,lCl", "lensing": "yes", "modes": "s,t", "gauge": "synchronous",
    "l_max_scalars": 2500, "l_max_tensors": 500,
}
_CURVED = {
    "h": 0.67810, "T_cmb": 2.7255, "omega_b": 0.02238280, "omega_cdm": 0.1201075,
    "N_ur": 3.046, "A_s": 2.100549e-09, "n_s": 0.9660499, "tau_reio": 0.05430842,
    "YHe": "BBN", "recombination": "RECFAST", "modes": "s,t", "r": 0.1,
    "output": "tCl,pCl,lCl,mPk", "lensing": "yes", "l_max_scalars": 2500,
    "l_max_tensors": 500, "P_k_max_1/Mpc": 1.0, "z_pk": "0",
}
G8_CURVED = dict(_CURVED, Omega_k=0.01, n_t="scc")
G18_CLOSED = dict(_CURVED, Omega_k=-0.01)
G29_OPEN01 = dict(_CURVED, Omega_k=0.1, n_t="scc")
G30_CLOSED01 = dict(_CURVED, Omega_k=-0.1, n_t="scc")
_GOLDEN_COSMO = {
    "h": 0.67810, "T_cmb": 2.7255, "omega_b": 0.02238280, "omega_cdm": 0.1201075,
    "N_ur": 3.046, "A_s": 2.100549e-09, "n_s": 0.9660499,
}
G5_HYREC = dict(_GOLDEN_COSMO, tau_reio=0.05430842, YHe="BBN",
                reio_parametrization="reio_camb", recombination="HyRec",
                output="tCl,pCl,lCl,mPk", lensing="yes", modes="s", l_max_scalars=2500,
                **{"P_k_max_1/Mpc": 10.0, "z_pk": "0"})
G16_INJECTION = dict(_GOLDEN_COSMO, tau_reio=0.05430842, YHe=0.2454006, recombination="RECFAST",
                     annihilation=1.0e-6, output="tCl,pCl,lCl", lensing="yes",
                     l_max_scalars=1200)
G22_INJECTION_BOS = dict(G16_INJECTION, **{"on the spot": "no"})
_G11 = dict(_GOLDEN_COSMO, YHe="BBN", recombination="RECFAST", output="tCl,pCl,lCl",
            lensing="yes", l_max_scalars=1200)
G11A_REIO_BINS = dict(_G11, reio_parametrization="reio_bins_tanh", binned_reio_num=3,
                      binned_reio_z="8,12,16", binned_reio_xe="0.8,0.2,0.1",
                      binned_reio_step_sharpness=0.3)
G11B_REIO_MANYTANH = dict(_G11, reio_parametrization="reio_many_tanh", many_tanh_num=2,
                          many_tanh_z="3.5,8", many_tanh_xe="-2,-1", many_tanh_width=0.5)
HYREC_FULL = dict(_GOLDEN_COSMO, tau_reio=0.05430842, YHe="BBN", recombination="hyrec_full")
PLANCK_ROW2_SS005 = dict(PLANCK_ROW2, perturb_sampling_stepsize=0.05)
NCDM_ROW3 = {
    "h": 0.6736, "omega_b": 0.02237, "omega_cdm": 0.1200,
    "A_s": 2.0989e-9, "n_s": 0.9649, "tau_reio": 0.0544,
    "N_ur": 0.00641, "N_ncdm": 3, "m_ncdm": "0.021934, 0.023582, 0.054485",
    "output": "tCl,pCl,lCl,mPk", "lensing": "yes",
    "l_max_scalars": 2500, "P_k_max_1/Mpc": 10.0, "z_pk": "0.",
}
_NC = dict(_GOLDEN_COSMO, tau_reio=0.05430842, selection="gaussian",
           selection_mean="0.5, 1.0", selection_width="0.1", l_max_lss=300, non_diagonal=1)
G7_NCL = dict(_NC, output="nCl,sCl")
G19_NCL_FULL = dict(G7_NCL, **{"number count contributions": "density, rsd, lensing, gr",
                               "selection_bias": "1.2, 1.5",
                               "selection_magnification_bias": "0.1, 0.15"})
G27_PD = dict(_NC, output="tCl,pCl,lCl,nCl", lensing="yes", l_max_scalars=600,
              **{"number count contributions": "density, rsd, lensing, gr"})
NC_DES_Y1 = dict(_GOLDEN_COSMO, tau_reio=0.05430842, output="nCl,sCl", selection="tophat",
                 selection_mean="0.225, 0.375, 0.525, 0.675, 0.825", selection_width="0.075",
                 selection_bias="1.45, 1.55, 1.65, 1.8, 2.0", non_diagonal=4, l_max_lss=1000,
                 **{"number count contributions": "density, rsd, lensing, gr"})
G32_TEXACT = dict(_GOLDEN_COSMO, N_ur=2.0328, N_ncdm=1, m_ncdm=0.06, tau_reio=0.05430842,
                  YHe="BBN", recombination="RECFAST", modes="s,t", r=0.1, n_t="scc",
                  l_max_tensors=500, output="tCl,pCl,lCl", lensing="yes", l_max_scalars=1200,
                  **{"tensor method": "exact"})
G33_TPHOTONS = dict(G32_TEXACT, **{"tensor method": "photons"})
TEXACT_NCDM3 = dict(G32_TEXACT, N_ur=0.00641, N_ncdm=3, m_ncdm="0.021934, 0.023582, 0.054485")
G1_LCDM = dict(_GOLDEN_COSMO, Omega_k=0.0, tau_reio=0.05430842, YHe="BBN",
               recombination="RECFAST", reio_parametrization="reio_camb",
               output="tCl,pCl,lCl,mPk", lensing="yes", gauge="synchronous",
               l_max_scalars=2500, z_pk="0, 1, 3", **{"P_k_max_1/Mpc": 10.0})
G1_LCDM_HALOFIT = dict(G1_LCDM, **{"non linear": "halofit"})
G1H_HALOFIT = dict(_GOLDEN_COSMO, tau_reio=0.05430842, YHe="BBN", recombination="RECFAST",
                   output="mPk", gauge="synchronous", z_pk="0, 1, 3",
                   **{"P_k_max_1/Mpc": 10.0, "non linear": "halofit"})
G2_NCDM = dict(_GOLDEN_COSMO, N_ur=0.00641, N_ncdm=3, m_ncdm="0.021934, 0.023582, 0.054485",
               tau_reio=0.05430842, YHe="BBN", output="tCl,pCl,lCl,mPk", lensing="yes",
               l_max_scalars=2500, z_pk="0.", **{"P_k_max_1/Mpc": 10.0})
G8S_CURVED = dict(_GOLDEN_COSMO, tau_reio=0.05430842, Omega_k=0.01, output="tCl,pCl,lCl,mPk",
                  lensing="yes", l_max_scalars=2500, z_pk="0.", **{"P_k_max_1/Mpc": 1.0})
LCDM_ROW1 = {"output": "tCl,mPk", "l_max_scalars": 2500, "P_k_max_1/Mpc": 1.0, "z_pk": "0."}
G9_NEWT = dict(_GOLDEN_COSMO, tau_reio=0.05430842, YHe="BBN", reio_parametrization="reio_camb",
               recombination="RECFAST", gauge="newtonian", output="tCl,pCl,lCl,mPk",
               lensing="yes", modes="s", l_max_scalars=2500, z_pk="0",
               **{"P_k_max_1/Mpc": 10.0})
ROW2_NEWT = dict(ROW2_EXACT, gauge="newtonian")
G8_NEWT = dict(G8_CURVED, gauge="newtonian")
G18_NEWT = dict(G18_CLOSED, gauge="newtonian")
G21_ISOCORR = dict(_GOLDEN_COSMO, tau_reio=0.05430842, YHe="BBN",
                   reio_parametrization="reio_camb", recombination="RECFAST", ic="ad, cdi, nid",
                   f_cdi=0.3, n_cdi=0.95, f_nid=0.2, n_nid=1.05, c_ad_cdi=-0.6, n_ad_cdi=0.02,
                   c_ad_nid=0.4, c_cdi_nid=0.25, output="tCl,pCl,lCl", lensing="yes",
                   modes="s", l_max_scalars=2500)
G21_NEWT = dict(G21_ISOCORR, gauge="newtonian")
G31_PERIC = dict(_GOLDEN_COSMO, tau_reio=0.05430842, YHe="BBN",
                 reio_parametrization="reio_camb", recombination="RECFAST", ic="ad,cdi",
                 c_ad_cdi=-0.5, output="tCl,pCl,mPk", l_max_scalars=1200, z_pk="0",
                 **{"P_k_max_1/Mpc": 1.0})
ROW2_ISO = dict(ROW2_EXACT, ic="ad,bi,niv", f_bi=0.3, f_niv=0.2, c_ad_niv=0.3)
G6_HMCODE = dict(_GOLDEN_COSMO, tau_reio=0.05430842, YHe="BBN", reio_parametrization="reio_camb",
                 recombination="RECFAST", output="mPk", z_pk="0., 1., 3.",
                 **{"non linear": "hmcode", "P_k_max_1/Mpc": 20.0})
ROW2_HMCODE = dict(ROW2_EXACT, c_min=2.6, **{"non linear": "hmcode"})
G13_SCF = dict(_GOLDEN_COSMO, tau_reio=0.05430842, YHe=0.2454006, recombination="RECFAST",
               Omega_Lambda=0, Omega_fld=0, Omega_scf=-1, attractor_ic_scf="yes",
               scf_parameters="10.0, 0.0, 0.0, 0.0, 100.0, 0.0", scf_tuning_index=0,
               output="tCl,pCl,lCl,mPk", lensing="yes", l_max_scalars=1200, z_pk="0",
               **{"P_k_max_1/Mpc": 1.0})
G17_IDM_DR = dict(_GOLDEN_COSMO, tau_reio=0.05430842, YHe=0.2454006, recombination="RECFAST",
                  N_idr=0.5, f_idm_dr=1.0, a_idm_dr=1.0e3, nindex_idm_dr=4, m_idm=1.0e9,
                  output="tCl,pCl,lCl,mPk", lensing="yes", l_max_scalars=1200, z_pk="0",
                  **{"P_k_max_1/Mpc": 1.0})
G34_IDMDR_L = dict(G17_IDM_DR, reio_parametrization="reio_camb", alpha_idm_dr="1.0, 1.2, 1.4",
                   beta_idr="0.5, 1.0")
CONFIGS = {"planck_row2": PLANCK_ROW2, "row2_exact": ROW2_EXACT, "g3_tensor": G3_TENSOR,
           "g8_curved": G8_CURVED, "g18_closed": G18_CLOSED, "g5_hyrec": G5_HYREC,
           "g16_injection": G16_INJECTION, "g22_injection_bos": G22_INJECTION_BOS,
           "g11a_reio_bins": G11A_REIO_BINS, "g11b_reio_manytanh": G11B_REIO_MANYTANH,
           "planck_row2_ss005": PLANCK_ROW2_SS005, "ncdm_row3": NCDM_ROW3,
           "g19_ncl_full": G19_NCL_FULL, "g27_pd": G27_PD, "nc_des_y1": NC_DES_Y1,
           "g32_texact": G32_TEXACT, "g9_newt": G9_NEWT, "row2_newt": ROW2_NEWT,
           "g8_newt": G8_NEWT, "g18_newt": G18_NEWT, "g21_isocorr": G21_ISOCORR,
           "g21_newt": G21_NEWT, "g31_peric": G31_PERIC, "row2_iso": ROW2_ISO,
           "g6_hmcode": G6_HMCODE, "row2_hmcode": ROW2_HMCODE, "g13_scf": G13_SCF,
           "g34_idmdr_l": G34_IDMDR_L}
# each Newtonian twin and the synchronous configuration it is held to
NEWT_TWIN = {"row2_newt": "row2_exact", "g8_newt": "g8_curved", "g18_newt": "g18_closed",
             "g21_newt": "g21_isocorr"}
THERMO_ONLY = {"hyrec_full": HYREC_FULL}
TENSOR_ONLY = {"texact_ncdm3": TEXACT_NCDM3}
GOLDEN_ONLY = {"g29_open01": G29_OPEN01, "g30_closed01": G30_CLOSED01, "g7_ncl": G7_NCL,
               "g33_tphotons": G33_TPHOTONS, "g1_lcdm": G1_LCDM, "g1_lcdm_halofit": G1_LCDM_HALOFIT,
               "g1h_halofit": G1H_HALOFIT,
               "g2_ncdm": G2_NCDM, "g8s_curved": G8S_CURVED, "lcdm_row1": LCDM_ROW1,
               "g17_idm_dr": G17_IDM_DR}
# the row of tests/golden/bench_probe.json that holds each probe-checked path
PROBE_ROW = {"planck_row2": "planck_row2", "row2_exact": "row2_exact",
             "planck_row2_ss005": "planck_row2", "ncdm_row3": "ncdm_row3",
             "lcdm_row1": "lcdm_row1"}

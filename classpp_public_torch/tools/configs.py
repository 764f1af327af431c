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
CONFIGS = {"planck_row2": PLANCK_ROW2, "row2_exact": ROW2_EXACT, "g3_tensor": G3_TENSOR,
           "g8_curved": G8_CURVED, "g18_closed": G18_CLOSED, "g5_hyrec": G5_HYREC,
           "g16_injection": G16_INJECTION, "g22_injection_bos": G22_INJECTION_BOS,
           "g11a_reio_bins": G11A_REIO_BINS, "g11b_reio_manytanh": G11B_REIO_MANYTANH}
THERMO_ONLY = {"hyrec_full": HYREC_FULL}
GOLDEN_ONLY = {"g29_open01": G29_OPEN01, "g30_closed01": G30_CLOSED01}

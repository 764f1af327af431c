"""Precision-parameter registry.

Counterpart of classpp_public_tpu/config/precision.py: the same fields and
reference defaults (include/precisions.h), minus the knobs that shaped the
TPU launches (`k_chunk_size`, `tau_windows`) and the float32 working-state
rule (`perturb_dtype`, `tol_perturb_f32_floor`). The port integrates in
float64 everywhere: the H100 has native f64, where the TPU emulates it.
"""

from __future__ import annotations

from dataclasses import dataclass, replace


@dataclass(frozen=True)
class PrecisionParams:
    # --- background (precisions.h:12-67)
    a_ini_over_a_today_default: float = 1.0e-14
    tol_initial_Omega_r: float = 1.0e-4
    tol_ncdm_bg: float = 1.0e-5
    tol_ncdm: float = 1.0e-3
    tol_M_ncdm: float = 1.0e-7
    tol_ncdm_initial_w: float = 1.0e-3
    tol_tau_eq: float = 1.0e-6
    Omega0_cdm_min_synchronous: float = 1.0e-10
    background_Nloga: int = 4096

    # --- thermodynamics / recfast (precisions.h:86-156)
    recfast_z_initial: float = 1.0e4
    recfast_Nz0: int = 20000
    tol_thermo_integration: float = 1.0e-2
    recfast_Heswitch: int = 6
    recfast_fudge_He: float = 0.86
    recfast_Hswitch: bool = True
    recfast_fudge_H: float = 1.14
    recfast_delta_fudge_H: float = -0.015
    recfast_AGauss1: float = -0.14
    recfast_AGauss2: float = 0.079
    recfast_zGauss1: float = 7.28
    recfast_zGauss2: float = 6.73
    recfast_wGauss1: float = 0.18
    recfast_wGauss2: float = 0.33
    recfast_z_He_1: float = 8000.0
    recfast_delta_z_He_1: float = 50.0
    recfast_z_He_2: float = 5000.0
    recfast_delta_z_He_2: float = 100.0
    recfast_z_He_3: float = 3500.0
    recfast_delta_z_He_3: float = 50.0
    recfast_x_He0_trigger: float = 0.995
    recfast_x_He0_trigger2: float = 0.995
    recfast_x_He0_trigger_delta: float = 0.05
    recfast_x_H0_trigger: float = 0.995
    recfast_x_H0_trigger2: float = 0.995
    recfast_x_H0_trigger_delta: float = 0.05
    recfast_H_frac: float = 1.0e-3
    reionization_z_start_max: float = 50.0
    reionization_sampling: float = 5.0e-2
    reionization_optical_depth_tol: float = 1.0e-4
    reionization_start_factor: float = 8.0
    thermo_rate_smoothing_radius: int = 50
    hyrec_Alpha_inf_file: str = ""
    hyrec_R_inf_file: str = ""
    hyrec_two_photon_tables_file: str = ""

    # --- perturbations: k sampling (precisions.h:162-182)
    k_min_tau0: float = 0.1
    k_max_tau0_over_l_max: float = 2.4
    k_step_sub: float = 0.05
    k_step_super: float = 0.002
    k_step_transition: float = 0.2
    k_step_super_reduction: float = 0.1
    k_per_decade_for_pk: float = 10.0
    idmdr_boost_k_per_decade_for_pk: float = 1.0
    k_per_decade_for_bao: float = 70.0
    k_bao_center: float = 3.0
    k_bao_width: float = 4.0
    start_small_k_at_tau_c_over_tau_h: float = 0.0015
    start_large_k_at_tau_h_over_tau_k: float = 0.07
    tight_coupling_trigger_tau_c_over_tau_h: float = 0.015
    tight_coupling_trigger_tau_c_over_tau_k: float = 0.01
    tight_coupling_trigger_tau_c_over_tau_k_pkonly: float = 0.01
    start_sources_at_tau_c_over_tau_h: float = 0.008
    tight_coupling_approximation: str = "compromise_CLASS"

    # --- Boltzmann hierarchy truncation (precisions.h:209-217)
    l_max_g: int = 12
    l_max_pol_g: int = 10
    l_max_ur: int = 17
    l_max_ncdm: int = 17
    l_max_dr: int = 17
    l_max_dr_col: int = 17
    l_max_idr: int = 17
    l_max_g_ten: int = 5
    l_max_pol_g_ten: int = 5

    # --- perturbation integration (precisions.h:219-299)
    curvature_ini: float = 1.0
    entropy_ini: float = 1.0
    gw_ini: float = 1.0
    c_gamma_k_H_square_max: float = 1.0e3
    perturb_sampling_stepsize: float = 0.1
    tol_perturb_integration: float = 1.0e-5
    # P(k)-tail lanes: radiation-hierarchy rtol loosening factor and the
    # absolute floor on those rows (classpp_public_tpu/config/precision.py:185)
    tol_perturb_tail_factor: float = 30.0
    atol_perturb_tail_radiation: float = 1.0e-4
    tol_tau_approx: float = 1.0e-10
    radiation_streaming_approximation: str = "rsa_MD_with_reio"
    radiation_streaming_trigger_tau_over_tau_k: float = 45.0
    radiation_streaming_trigger_tau_c_over_tau: float = 5.0
    ur_fluid_approximation: str = "ufa_CLASS"
    ur_fluid_trigger_tau_over_tau_k: float = 30.0
    ncdm_fluid_approximation: str = "ncdmfa_CLASS"
    ncdm_fluid_trigger_tau_over_tau_k: float = 31.0
    neglect_CMB_sources_below_visibility: float = 1.0e-3
    evolver: str = "imex"

    # --- primordial (precisions.h:311)
    k_per_decade_primordial: float = 10.0

    # --- transfer / bessel (precisions.h:335-406)
    l_linstep: int = 40
    l_logstep: float = 1.12
    hyper_flat_approximation_nu: float = 4000.0
    q_logstep_trapzd: float = 20.0
    q_numstep_transition: float = 250.0
    q_linstep: float = 0.45
    q_logstep_spline: float = 170.0
    q_logstep_open: float = 6.0
    phi_q_per_decade: float = 0.0
    transfer_neglect_delta_k_S_t0: float = 0.15
    transfer_neglect_delta_k_S_t1: float = 0.04
    transfer_neglect_delta_k_S_t2: float = 0.15
    transfer_neglect_delta_k_S_e: float = 0.11
    transfer_neglect_delta_k_T_t2: float = 0.2
    transfer_neglect_delta_k_T_e: float = 0.25
    transfer_neglect_delta_k_T_b: float = 0.1
    transfer_neglect_late_source: float = 400.0
    l_switch_limber: float = 10.0
    # number counts / selection windows (precisions.h:400-411)
    selection_tophat_edge: float = 0.1
    l_switch_limber_for_nc_local_over_z: float = 100.0
    l_switch_limber_for_nc_los_over_z: float = 30.0
    selection_cut_at_sigma: float = 5.0
    selection_sampling: float = 50.0
    selection_sampling_bessel: float = 20.0
    selection_sampling_bessel_los: float = 20.0

    # --- nonlinear (precisions.h:418-449)
    sigma_k_per_decade: float = 80.0
    nonlinear_min_k_max: float = 20.0
    # per-method floors of the P(k) k_max (input_module.cpp:2806-2811)
    halofit_min_k_max: float = 5.0
    hmcode_min_k_max: float = 5.0
    halofit_min_k_nonlinear: float = 1.0e-4
    halofit_k_per_decade: float = 80.0
    sBBN_file: str = "sBBN_2017.dat"

    # --- hmcode (precisions.h:459-485)
    hmcode_max_k_extra: float = 1.0e6
    n_hmcode_tables: int = 64
    ainit_for_growtab: float = 1.0e-3
    amax_for_growtab: float = 1.0
    nsteps_for_p1h_integral: int = 256
    mmin_for_p1h_integral: float = 1.0e3
    mmax_for_p1h_integral: float = 1.0e18

    # --- lensing (precisions.h:492-495)
    accurate_lensing: bool = False
    num_mu_minus_lmax: int = 70
    delta_l_max: int = 500
    tol_gauss_legendre: float = 1.0e-13

    def replace(self, **kw) -> "PrecisionParams":
        return replace(self, **kw)

"""Cosmological parameter set.

Counterpart of classpp_public_tpu/config/params.py. The fields, defaults and
derived properties are the same; the class is a plain frozen dataclass (no
pytree registration: PyTorch has no tracing that needs one).

Densities follow CLASS conventions: omega_x = Omega_x h^2; internal "class
units" densities are (8 pi G/3) rho / c^2 in Mpc^-2.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Optional, Tuple

from .. import constants as const


@dataclass(frozen=True)
class CosmoParams:
    """User-level cosmological parameters (reference explanatory.ini semantics).

    Defaults replicate the reference's built-in `input_default_params`
    (input_module.cpp:3150-3400). Fields of features outside the ported slice
    (see `check_lcdm`) are kept so that a parameter set carries over from the
    JAX package unchanged; the stages raise when one is switched on."""

    # background
    h: float = 0.67556
    T_cmb: float = 2.7255
    omega_b: float = 0.022032
    omega_cdm: float = 0.12038
    N_ur: float = 3.046
    Omega_k: float = 0.0
    w0_fld: float = -1.0
    wa_fld: float = 0.0
    use_fld: bool = False
    fluid_eos: str = "CLP"
    Omega_EDE: float = 0.0
    cs2_fld: float = 1.0
    pk_eq: bool = False
    use_ppf: bool = False
    c_gamma_over_c_fld: float = 0.4
    m_ncdm: Tuple[float, ...] = ()
    deg_ncdm: Tuple[float, ...] = ()
    T_ncdm: Tuple[float, ...] = ()
    ksi_ncdm: Tuple[float, ...] = ()
    ncdm_psd_files: Tuple[str, ...] = ()
    ncdm_quadrature_strategy: Tuple[int, ...] = ()
    ncdm_input_q_size: Tuple[int, ...] = ()
    ncdm_maximum_q: Tuple[float, ...] = ()
    N_ncdm_decay_dr: int = 0
    Gamma_dncdm: Tuple[float, ...] = ()
    Omega_dncdmdr: Tuple[float, ...] = ()
    Omega_ini_dcdm: float = 0.0
    Omega_dcdmdr: float = 0.0
    Omega_scf: float = 0.0
    scf_parameters: Tuple[float, ...] = ()
    scf_tuning_index: int = 0
    attractor_ic_scf: bool = True
    Gamma_dcdm: float = 0.0

    # primordial (analytic power law; defaults input_module.cpp:3328-3331)
    A_s: float = 2.215e-09
    n_s: float = 0.9619
    alpha_s: float = 0.0
    k_pivot: float = 0.05
    r: float = 1.0
    n_t: float = -0.1141375
    alpha_t: float = 0.0108625
    tensor_method: str = "massless"

    # thermodynamics: reio_z mode at z_reio = 11.357 by default
    # (input_module.cpp:3228-3230); classy.set() nulls z_reio when the user
    # pins tau_reio instead
    YHe: Optional[float] = None
    tau_reio: float = 0.0925
    z_reio: Optional[float] = 11.357
    reio_parametrization: str = "reio_camb"
    reionization_exponent: float = 1.5
    reionization_width: float = 0.5
    helium_fullreio_redshift: float = 3.5
    helium_fullreio_width: float = 0.5
    binned_reio_z: Tuple[float, ...] = ()
    binned_reio_xe: Tuple[float, ...] = ()
    binned_reio_step_sharpness: float = 0.3
    many_tanh_z: Tuple[float, ...] = ()
    many_tanh_xe: Tuple[float, ...] = ()
    many_tanh_width: float = 0.5
    reio_inter_z: Tuple[float, ...] = ()
    reio_inter_xe: Tuple[float, ...] = ()

    # interacting dark matter <-> dark radiation (ETHOS)
    Omega_idm_dr: float = 0.0
    xi_idr: float = 0.0
    stat_f_idr: float = 0.875
    a_idm_dr: float = 0.0
    b_idr: float = 0.0
    nindex_idm_dr: float = 4.0
    m_idm: float = 1.0e11
    idr_nature: str = "free_streaming"
    alpha_idm_dr: Tuple[float, ...] = ()
    beta_idr: Tuple[float, ...] = ()

    # DM energy injection
    annihilation: float = 0.0
    decay: float = 0.0
    annihilation_variation: float = 0.0
    annihilation_z: float = 1000.0
    annihilation_zmax: float = 2500.0
    annihilation_zmin: float = 30.0
    annihilation_f_halo: float = 0.0
    annihilation_z_halo: float = 30.0
    on_the_spot: bool = True

    # temperature contributions (tsw, eisw, lisw, dop, pol) and the
    # early/late ISW split redshift (perturb_sources :6826-6895)
    temp_contributions: Tuple[float, ...] = (1.0, 1.0, 1.0, 1.0, 1.0)
    eisw_lisw_split_z: float = 120.0

    gauge: str = "synchronous"
    recombination: str = "recfast"

    @property
    def H0(self) -> float:
        """H0 in 1/Mpc."""
        return self.h * const.H0_h_to_inv_Mpc

    @property
    def Omega0_g(self) -> float:
        return const.rho_gamma_class_units(self.T_cmb) / (self.H0 * self.H0)

    @property
    def Omega0_b(self) -> float:
        return self.omega_b / (self.h * self.h)

    @property
    def Omega0_cdm(self) -> float:
        return self.omega_cdm / (self.h * self.h)

    @property
    def Omega0_ur(self) -> float:
        return self.N_ur * const.ur_over_g_factor * self.Omega0_g

    @property
    def N_ncdm(self) -> int:
        return len(self.m_ncdm)

    def T_ncdm_of(self, i: int) -> float:
        # 0.71611 is the CLASS default accounting for non-instantaneous decoupling
        return self.T_ncdm[i] if i < len(self.T_ncdm) else 0.71611

    def deg_ncdm_of(self, i: int) -> float:
        return self.deg_ncdm[i] if i < len(self.deg_ncdm) else 1.0

    @property
    def N_eff(self) -> float:
        """Relativistic species count in the early universe, for the BBN YHe
        lookup: N_ur plus each (then-relativistic) Fermi-Dirac ncdm species
        weighted by deg (T_ncdm / (4/11)^(1/3))^4
        (NonColdDarkMatter::GetNeff, tools/non_cold_dark_matter.cpp:1010)."""
        t_std = (4.0 / 11.0) ** (1.0 / 3.0)
        return self.N_ur + sum(
            self.deg_ncdm_of(i) * (self.T_ncdm_of(i) / t_std) ** 4
            for i in range(self.N_ncdm))

    def replace(self, **kw) -> "CosmoParams":
        return dataclasses.replace(self, **kw)


def check_lcdm(params: CosmoParams) -> None:
    """Raise for every parameter that switches on physics outside what the
    benchmark's cells run (LambdaCDM + massive neutrinos, synchronous gauge,
    RECFAST with or without energy injection, every reionization scheme)."""
    bad = []
    if any(params.ksi_ncdm) or any(params.ncdm_psd_files):
        bad.append("ncdm chemical potentials and tabulated phase-space distributions")
    if params.ncdm_quadrature_strategy:
        bad.append("ncdm 'Quadrature strategy'")
    if params.N_ncdm_decay_dr:
        bad.append("decaying ncdm")
    if params.use_fld:
        bad.append("dark-energy fluid")
    if params.Omega_ini_dcdm > 0.0 or params.Omega_dcdmdr > 0.0:
        bad.append("decaying dark matter")
    if params.Omega_scf != 0.0:
        bad.append("scalar-field dark energy")
    if params.Omega_idm_dr > 0.0:
        bad.append("interacting dark matter and dark radiation")
    if params.gauge != "synchronous":
        bad.append(f"the {params.gauge} gauge")
    if params.recombination != "recfast":
        bad.append(f"recombination = {params.recombination}")
    if tuple(params.temp_contributions) != (1.0,) * 5 or params.eisw_lisw_split_z != 120.0:
        bad.append("temperature-contribution switches")
    if bad:
        raise NotImplementedError("outside the benchmark reference: " + "; ".join(bad))

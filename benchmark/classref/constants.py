"""Physical constants and unit conversions.

Values match the reference CLASS++ definitions (include/common.h:115-128) so that
golden-data comparisons are free of constant-mismatch noise. All are public
CODATA/IAU values.

Unit system: the framework works in "CLASS units":
  - lengths/times in Mpc (c = 1),
  - energy densities stored as (8 pi G / 3) * rho in units of Mpc^-2,
  - H in 1/Mpc.
"""

import math

# conversions
Mpc_over_m = 3.085677581282e22   # meters per megaparsec
Gyr_over_Mpc = 3.06601394e2      # Gyr per Mpc (c = 1, Julian years)
c_SI = 2.99792458e8              # speed of light [m/s]
G_SI = 6.67428e-11               # Newton constant [m^3/kg/s^2]
eV_SI = 1.602176487e-19          # 1 eV in J
k_B = 1.3806504e-23              # Boltzmann [J/K]
h_P = 6.62606896e-34             # Planck [J s]
sigma_B = 2.0 * math.pi**5 * k_B**4 / (15.0 * h_P**3 * c_SI**2)  # Stefan-Boltzmann [W/m^2/K^4]

# Thomson scattering / hydrogen (thermodynamics; reference source/thermodynamics_module.cpp)
sigma_T = 6.6524616e-29          # Thomson cross section [m^2]
m_e = 9.10938215e-31             # electron mass [kg]
m_H = 1.673575e-27               # hydrogen mass [kg]
not4 = 3.9715                    # He/H mass ratio (RECFAST convention)
m_p = 1.672621637e-27            # proton mass [kg]

# neutrino temperature ratio (instantaneous decoupling value)
T_nu_over_T_gamma = (4.0 / 11.0) ** (1.0 / 3.0)

# 7/8 (4/11)^{4/3}: energy density of one massless 2-dof fermion relative to photons
ur_over_g_factor = 7.0 / 8.0 * (4.0 / 11.0) ** (4.0 / 3.0)

PI = math.pi

# H0 = 100 h km/s/Mpc expressed in 1/Mpc: 1e5 / c_SI
H0_h_to_inv_Mpc = 1.0e5 / c_SI   # multiply by h to get H0 in 1/Mpc

# CMB temperature -> photon density:
# (8 pi G / 3 c^2) * (4 sigma_B / c) T^4, converted to Mpc^-2  (input_module.cpp)
def rho_gamma_class_units(T_cmb: float) -> float:
    """(8 pi G/3) rho_gamma / c^2 in Mpc^-2 for photon temperature T_cmb [K]."""
    rho_SI = 4.0 * sigma_B / c_SI * T_cmb**4  # energy density [J/m^3]
    return 8.0 * math.pi * G_SI / (3.0 * c_SI**2) * rho_SI / c_SI**2 * Mpc_over_m**2

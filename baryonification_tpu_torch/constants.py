"""Physical constants in the unit system used throughout the package.

Lengths are Mpc (comoving unless stated otherwise), masses are Msun. The
values are those of ``baryonification_tpu.constants``, so both packages
compute with the same numbers.
"""

import numpy as np

# --- SI base constants (CODATA 2018 / IAU nominal values) ---
C_LIGHT_KMS   = 299792.458            # speed of light [km/s]
G_SI          = 6.67430e-11           # Newton's constant [m^3 kg^-1 s^-2]
MSUN_KG       = 1.988409870698051e30  # IAU nominal solar mass [kg]
MPC_M         = 3.0856775814913673e22 # 1 Mpc [m]
KM_M          = 1.0e3

# --- derived cosmology constants ---
# H0 = 100 h km/s/Mpc in 1/s
H0_100_S = 100.0 * KM_M / MPC_M
# rho_crit(z=0) / h^2 = 3 H0^2 / (8 pi G) in Msun / Mpc^3
RHO_CRIT_0 = 3.0 * H0_100_S**2 / (8.0 * np.pi * G_SI) * MPC_M**3 / MSUN_KG
# Newton's constant in Mpc^3 / (Msun s^2)
G_MPC_MSUN = G_SI / MPC_M**3 * MSUN_KG
# Hubble distance c/H0 / h in Mpc
DH_100 = C_LIGHT_KMS / 100.0

# --- CGS constants for the thermodynamic layer ---
M_ELECTRON_G  = 9.1093837015e-28      # electron mass [g]
M_PROTON_G    = 1.67262192369e-24     # proton mass [g]
K_BOLTZMANN   = 1.380649e-16          # Boltzmann constant [erg/K]
SIGMA_THOMSON = 6.6524587321e-25      # Thomson cross-section [cm^2]
C_LIGHT_CGS   = 2.99792458e10         # speed of light [cm/s]
G_CGS         = 6.67430e-8            # Newton's constant [cm^3 g^-1 s^-2]
MPC_CM        = MPC_M * 1.0e2         # 1 Mpc in cm
MSUN_G        = MSUN_KG * 1.0e3       # 1 Msun in g

# G in units of (Mpc / Msun) * (cm/s)^2 (hydrostatic pressure integrals)
G_MSUN_MPC_CGS = G_CGS * MSUN_G / MPC_CM

# Primordial helium mass fraction and the thermal-to-electron pressure
# conversion.
Y_HELIUM    = 0.24
PTH_TO_PE   = (4.0 - 2.0 * Y_HELIUM) / (8.0 - 5.0 * Y_HELIUM)

# Soft floor for log-space interpolation of pressure-like tables.
PRESSURE_AT_INFINITY = 1e-200

DELTA_COLLAPSE = 1.686  # critical overdensity for spherical collapse

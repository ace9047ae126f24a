"""Physical constants, MetPy-1.4.1-compatible.

The reference library (xarray_parcel) delegates all point thermodynamics to
``metpy.constants`` / ``metpy.calc`` (reference: modules/parcel_functions.py:15).
Its golden unit tests (modules/unit_tests.py) encode truths that depend on the
exact constant values of MetPy 1.4.1, so we pin the same values here.

Derivations (CODATA 2018 / MetPy 1.4.1):
  * R      = 8.314462618 J mol-1 K-1            (universal gas constant)
  * Md     = 28.96546e-3 kg mol-1               (dry air molecular weight)
  * Mw     = 18.015268e-3 kg mol-1              (water molecular weight)
  * Rd     = R / Md
  * Rv     = R / Mw
  * Cp_d   = 3.5 * Rd   (gamma = 1.4)  =>  kappa = Rd / Cp_d = 2/7 exactly
  * Lv     = 2.50084e6 J kg-1                   (latent heat of vap. at 0 C)
  * eps    = Mw / Md = Rd / Rv

``kappa = 2/7`` is confirmed by the reference golden test
``test_dry_lapse_2_levels`` (modules/unit_tests.py:160): 293 * 0.5**(2/7)
= 240.3583 K to 4 decimals (a 1005 J/kg/K Cp would give 240.3728).
"""

R = 8.314462618                 # J mol-1 K-1
Md = 28.96546e-3                # kg mol-1
Mw = 18.015268e-3               # kg mol-1

Rd = R / Md                     # 287.04749097718457 J kg-1 K-1
Rv = R / Mw                     # 461.52265188217 J kg-1 K-1
Cp_d = 3.5 * Rd                 # 1004.668718420146 J kg-1 K-1
kappa = Rd / Cp_d               # 2/7
epsilon = Mw / Md               # 0.6219569100577033
Lv = 2.50084e6                  # J kg-1

sat_pressure_0c = 6.112         # hPa (Bolton 1980 reference saturation pressure)
zero_degc = 273.15              # K
P0 = 1000.0                     # hPa (reference pressure for theta / Exner)

# Doswell & Rasmussen (1994) virtual-temperature epsilon used by the reference
# library itself (reference: modules/parcel_functions.py:782-804).
virtual_temperature_epsilon = 0.608

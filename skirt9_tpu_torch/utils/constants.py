"""Physical and astronomical constants (SI), f64 host-side values.

Equivalent of the reference's SKIRT/utils/Constants.hpp (CODATA-style values);
all internal quantities in the framework are SI, like the reference
(ref: SMILE/schema/UnitDef.hpp, SKIRT/core/SkirtUnitDef.cpp:27).
"""

# fundamental
C_LIGHT = 2.99792458e8          # speed of light [m/s]
H_PLANCK = 6.62607015e-34       # Planck constant [J s]
K_BOLTZMANN = 1.380649e-23      # Boltzmann constant [J/K]
ELECTRON_MASS = 9.1093837015e-31  # [kg]
PROTON_MASS = 1.67262192369e-27   # [kg]
AMU = 1.66053906660e-27         # atomic mass unit [kg]
SIGMA_THOMSON = 6.6524587321e-29  # Thomson cross section [m2]
FINE_STRUCTURE = 7.2973525693e-3
ELECTRON_CHARGE = 1.602176634e-19  # [C]

# astronomical
AU = 1.49597871e11              # astronomical unit [m]
PARSEC = 3.08567758149e16       # parsec [m]
LIGHT_YEAR = 9.4607304726e15    # [m]
SOLAR_MASS = 1.98892e30         # [kg]
SOLAR_LUMINOSITY = 3.839e26     # bolometric solar luminosity [W]
YEAR = 3.15569252e7             # Julian-ish year [s]

# derived / spectral
T_CMB = 2.72548                 # CMB temperature today [K]
LYA_LAMBDA = 1215.67e-10        # Lyman-alpha wavelength [m]
H_ALPHA_LAMBDA = 656.28e-9      # H-alpha [m]

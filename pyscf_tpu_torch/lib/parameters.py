"""Physical constants and unit conversions.

TPU-native analog of the reference's pyscf/lib/parameters.py (values are CODATA
public constants, independently specified).
"""

# CODATA 2018
BOHR = 0.52917721092          # Angstrom per Bohr (matches reference param.BOHR)
HARTREE2EV = 27.211386245988
HARTREE2WAVENUMBER = 219474.63136320
HARTREE2J = 4.3597447222071e-18
AMU2AU = 1822.888486209
BOLTZMANN_AU = 3.166811563e-6          # Hartree / K
LIGHT_SPEED = 137.03599967994          # atomic units
DEBYE = 2.541746473            # a.u. (e*Bohr) -> Debye
MP_ME = 1836.15267343          # proton/electron mass ratio
NUC_MAGNETON = 1 / (2 * MP_ME)

MAX_MEMORY = 4000              # MB, default working-memory budget
ANGULAR = 'spdfghik'
ANGULARMAP = {c: l for l, c in enumerate(ANGULAR)}

VERBOSE_QUIET = 0
VERBOSE_CRIT = 1
VERBOSE_ERR = 2
VERBOSE_WARN = 3
VERBOSE_NOTE = 4
VERBOSE_INFO = 5
VERBOSE_DEBUG = 6

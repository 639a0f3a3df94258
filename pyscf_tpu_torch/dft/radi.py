"""Radial quadrature and atomic-size adjustment for Becke integration.

Counterpart of pyscf_tpu/dft/radi.py: the Bragg-Slater radii, the
Treutler xi table, treutler_ahlrichs (alias treutler) and
treutler_atomic_radii_adjust, the pieces the default grids use. Host
numpy, once per geometry.
"""
import numpy as np

from ..lib.parameters import BOHR

# Bragg-Slater atomic radii (Angstrom -> Bohr), Slater JCP 41, 3199 (1964).
BRAGG_RADII = 1.0 / BOHR * np.array((
    0.35,  # ghost
    0.35, 1.40,
    1.45, 1.05, 0.85, 0.70, 0.65, 0.60, 0.50, 1.50,
    1.80, 1.50, 1.25, 1.10, 1.00, 1.00, 1.00, 1.80,
    2.20, 1.80,
    1.60, 1.40, 1.35, 1.40, 1.40, 1.40, 1.35, 1.35, 1.35, 1.35,
    1.30, 1.25, 1.15, 1.15, 1.15, 1.90,
    2.35, 2.00,
    1.80, 1.55, 1.45, 1.45, 1.35, 1.30, 1.35, 1.40, 1.60, 1.55,
    1.55, 1.45, 1.45, 1.40, 1.40, 2.10,
    2.60, 2.15,
    1.95, 1.85, 1.85, 1.85, 1.85, 1.85, 1.85,
    1.80, 1.75, 1.75, 1.75, 1.75, 1.75, 1.75, 1.75,
    1.55, 1.45, 1.35, 1.35, 1.30, 1.35, 1.35, 1.35, 1.50,
    1.90, 1.80, 1.60, 1.90, 1.45, 2.10,
    1.80, 2.15,
    1.95, 1.80, 1.80, 1.75, 1.75, 1.75, 1.75,
    1.75, 1.75, 1.75, 1.75, 1.75, 1.75, 1.75,
    1.75, 1.75, 1.75, 1.75, 1.75, 1.75, 1.75, 1.75, 1.75, 1.75,
    1.75, 1.75, 1.75, 1.75, 1.75, 1.75,
    1.75, 1.75,
))

# Atom-specific Treutler-Ahlrichs xi (effective radius), JCP 102, 346 (1995).
TREUTLER_XI = np.array([
    1.0,
    0.8, 0.9,
    1.8, 1.4, 1.3, 1.1, 0.9, 0.9, 0.9, 0.9,
    1.4, 1.3, 1.3, 1.2, 1.1, 1.0, 1.0, 1.0,
    1.5, 1.4,
    1.3, 1.2, 1.2, 1.2, 1.2, 1.2, 1.2, 1.1, 1.1, 1.1,
    1.1, 1.0, 0.9, 0.9, 0.9, 0.9,
    2.000, 1.700,
    1.500, 1.500, 1.350, 1.350, 1.250, 1.200, 1.250, 1.300, 1.500, 1.500,
    1.300, 1.200, 1.200, 1.150, 1.150, 1.150,
    2.500, 2.200,
    2.500, 1.500, 1.500, 1.500, 1.500, 1.500, 1.500,
    1.500, 1.500, 1.500, 1.500, 1.500, 1.500, 1.500, 1.500,
    1.500, 1.500, 1.500, 1.500, 1.500, 1.500, 1.500, 1.500, 1.500,
    1.500, 1.500, 1.500, 1.500, 1.500, 1.500,
    2.500, 2.100,
    3.685, 1.500, 1.500, 1.500, 1.500, 1.500, 1.500,
    1.500, 1.500, 1.500, 1.500, 1.500, 1.500, 1.500, 1.500,
])

ATOM_SPECIFIC_TREUTLER_GRIDS = True


def treutler_ahlrichs(n, chg=0, *args, **kwargs):
    """Treutler-Ahlrichs M4 mapping of Chebyshev points, JCP 102, 346 (1995)."""
    if ATOM_SPECIFIC_TREUTLER_GRIDS and chg < len(TREUTLER_XI):
        xi = TREUTLER_XI[chg]
    else:
        xi = 1.0
    i = np.arange(1, n + 1)
    step = np.pi / (n + 1)
    x = np.cos(i * step)
    ln2 = xi / np.log(2.0)
    r = -ln2 * (1 + x) ** 0.6 * np.log((1 - x) / 2)
    dr = step * np.sin(i * step) * ln2 * (1 + x) ** 0.6 \
        * (-0.6 / (1 + x) * np.log((1 - x) / 2) + 1 / (1 - x))
    return r[::-1], dr[::-1]


treutler = treutler_ahlrichs


def treutler_atomic_radii_adjust(mol, atomic_radii=BRAGG_RADII):
    """Treutler atomic-size adjustment factor a_ij (JCP 102, 346)."""
    chgs = np.asarray(mol.charges)
    rad = np.sqrt(atomic_radii[chgs]) + 1e-200
    rr = rad.reshape(-1, 1) * (1.0 / rad)
    a = 0.25 * (rr.T - rr)
    return np.clip(a, -0.5, 0.5)

"""Cartesian-monomial -> real-solid-harmonic transformation coefficients.

S[m, cart] such that  r^l Y_lm(theta, phi) = sum_cart S[m, cart] x^a y^b z^c,
with Y_lm real spherical harmonics normalized on the unit sphere and ordered
m = -l..+l (matching the reference's spherical AO convention,
pyscf/gto/mole.py cart2sph).

Coefficients are obtained by exact polynomial interpolation: r^l Y_lm *is*
a homogeneous polynomial of degree l, so solving a least-squares system on
enough unit vectors reproduces the coefficients to machine precision —
no error-prone closed-form recursions.
"""
from functools import lru_cache

import numpy as np

from .hermite import cart_components


def _real_sph_harm(l, unit_vecs):
    """Real spherical harmonics Y_lm, m=-l..l, on unit vectors (n,3)."""
    x, y, z = unit_vecs.T
    theta = np.arccos(np.clip(z, -1, 1))
    phi = np.arctan2(y, x)
    try:
        from scipy.special import sph_harm_y
        def _Y(m, l_, th, ph):
            return sph_harm_y(l_, m, th, ph)
    except ImportError:
        from scipy.special import sph_harm
        def _Y(m, l_, th, ph):
            return sph_harm(m, l_, ph, th)
    out = np.zeros((2 * l + 1, len(x)))
    for m in range(-l, l + 1):
        ylm = _Y(abs(m), l, theta, phi)
        if m > 0:
            val = np.sqrt(2.0) * (-1) ** m * ylm.real
        elif m < 0:
            val = np.sqrt(2.0) * (-1) ** m * ylm.imag
        else:
            val = ylm.real
        out[m + l] = val
    return out


@lru_cache(maxsize=None)
def cart2sph(l):
    """(2l+1, ncart) numpy array of solid-harmonic expansion coefficients."""
    if l == 0:
        return np.array([[0.28209479177387814]])   # 1/sqrt(4 pi)
    carts = cart_components(l)
    ncart = len(carts)
    rng = np.random.RandomState(7)
    n = max(4 * ncart, 64)
    v = rng.randn(n, 3)
    v /= np.linalg.norm(v, axis=1, keepdims=True)
    M = np.stack([v[:, 0] ** a * v[:, 1] ** b * v[:, 2] ** c
                  for (a, b, c) in carts], axis=1)       # (n, ncart)
    Y = _real_sph_harm(l, v)                              # (2l+1, n)
    S, *_ = np.linalg.lstsq(M, Y.T, rcond=None)
    S = S.T                                               # (2l+1, ncart)
    S[np.abs(S) < 1e-14] = 0.0
    return S

"""Lebedev angular quadrature on the unit sphere.

Counterpart of pyscf_tpu/dft/lebedev.py. The orbit parameters (Lebedev &
Laikov, Dokl. Math. 59, 477 (1999)) are data, read by path from
pyscf_tpu/dft/lebedev_orbits.npz beside this package, not copied and not
imported (importing pyscf_tpu would import jax).
"""
import os
from functools import lru_cache
from itertools import permutations

import numpy as np

_ORBITS_PATH = os.path.join(os.path.dirname(os.path.dirname(
    os.path.dirname(os.path.abspath(__file__)))),
    'pyscf_tpu', 'dft', 'lebedev_orbits.npz')

LEBEDEV_NGRID = np.array([
    1, 6, 14, 26, 38, 50, 74, 86, 110, 146, 170, 194, 230, 266, 302, 350,
    434, 590, 770, 974, 1202, 1454, 1730, 2030, 2354, 2702, 3074, 3470,
    3890, 4334, 4802, 5294, 5810])

# quadrature order (degree l of exactness) -> number of points
LEBEDEV_ORDER = {
    0: 1, 3: 6, 5: 14, 7: 26, 9: 38, 11: 50, 13: 74, 15: 86, 17: 110,
    19: 146, 21: 170, 23: 194, 25: 230, 27: 266, 29: 302, 31: 350, 35: 434,
    41: 590, 47: 770, 53: 974, 59: 1202, 65: 1454, 71: 1730, 77: 2030,
    83: 2354, 89: 2702, 95: 3074, 101: 3470, 107: 3890, 113: 4334,
    119: 4802, 125: 5294, 131: 5810,
}


@lru_cache(maxsize=None)
def _load_orbits(path=_ORBITS_PATH):
    if not os.path.exists(path):
        raise FileNotFoundError(
            f'Lebedev orbit table {path} is missing: pyscf_tpu_torch reads '
            'the lebedev_orbits.npz of the pyscf_tpu package beside it')
    with np.load(path) as data:
        return {int(k): data[k] for k in data.files}


def _orbit_points(code, a, b):
    """Points of one octahedral orbit. Order within the orbit is irrelevant."""
    if code == 0:
        base = (1.0, 0.0, 0.0)
    elif code == 1:
        s = np.sqrt(0.5)
        base = (0.0, s, s)
    elif code == 2:
        s = np.sqrt(1.0 / 3)
        base = (s, s, s)
    elif code == 3:
        base = (a, a, np.sqrt(max(0.0, 1 - 2 * a * a)))
    elif code == 4:
        base = (a, np.sqrt(max(0.0, 1 - a * a)), 0.0)
    elif code == 5:
        base = (a, b, np.sqrt(max(0.0, 1 - a * a - b * b)))
    else:
        raise ValueError(code)
    pts = set()
    for perm in permutations(range(3)):
        p = tuple(base[i] for i in perm)
        for sx in (1, -1):
            for sy in (1, -1):
                for sz in (1, -1):
                    q = (round(sx * p[0], 15), round(sy * p[1], 15),
                         round(sz * p[2], 15))
                    # normalize -0.0
                    q = tuple(0.0 if x == 0 else x for x in q)
                    pts.add(q)
    return np.array(sorted(pts))


@lru_cache(maxsize=None)
def lebedev_grid(n_points):
    """Return (points (n,3), weights (n,)) with sum(weights) = 1."""
    if n_points == 1:
        return np.zeros((1, 3)), np.ones(1)
    orbits = _load_orbits()
    if n_points not in orbits:
        raise ValueError(f'No Lebedev grid with {n_points} points')
    pts_all, w_all = [], []
    for code, a, b, v in orbits[n_points]:
        pts = _orbit_points(int(code), a, b)
        pts_all.append(pts)
        w_all.append(np.full(len(pts), v))
    pts = np.concatenate(pts_all)
    w = np.concatenate(w_all)
    if len(pts) != n_points:
        raise RuntimeError(
            f'Lebedev orbit generation mismatch: {len(pts)} != {n_points}')
    return pts, w

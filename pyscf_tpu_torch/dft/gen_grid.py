"""Becke molecular integration grids.

Counterpart of pyscf_tpu/dft/gen_grid.py with its defaults: Treutler
radial grids with atom-specific xi, NWChem pruning, Bragg radii with the
Treutler size adjustment and the original Becke partition, level 3. The
atomic grids are host numpy, once per geometry. The partition weights
(get_partition_fast there) are the CUDA kernel `becke`
(csrc/becke.cu), with its plain PyTorch twin `becke_weights_plain`
here; the points are not padded to blocks.
"""
import numpy as np
import torch

from . import radi
from .lebedev import lebedev_grid, LEBEDEV_NGRID, LEBEDEV_ORDER

#                Period   1    2    3    4    5    6    7       level
RAD_GRIDS = np.array(((10, 15, 20, 30, 35, 40, 50),
                      (30, 40, 50, 60, 65, 70, 75),
                      (40, 60, 65, 75, 80, 85, 90),
                      (50, 75, 80, 90, 95, 100, 105),
                      (60, 90, 95, 105, 110, 115, 120),
                      (70, 105, 110, 120, 125, 130, 135),
                      (80, 120, 125, 135, 140, 145, 150),
                      (90, 135, 140, 150, 155, 160, 165),
                      (100, 150, 155, 165, 170, 175, 180),
                      (200, 200, 200, 200, 200, 200, 200)))

ANG_ORDER = np.array(((11, 15, 17, 17, 17, 17, 17),
                      (17, 23, 23, 23, 23, 23, 23),
                      (23, 29, 29, 29, 29, 29, 29),
                      (29, 29, 35, 35, 35, 35, 35),
                      (35, 41, 41, 41, 41, 41, 41),
                      (41, 47, 47, 47, 47, 47, 47),
                      (47, 53, 53, 53, 53, 53, 53),
                      (53, 59, 59, 59, 59, 59, 59),
                      (59, 59, 59, 59, 59, 59, 59),
                      (65, 65, 65, 65, 65, 65, 65)))

_PERIOD_EDGES = np.array((2, 10, 18, 36, 54, 86, 118))

# elements of the (points, natm, natm) temporaries per chunk of the plain twin
_PLAIN_BUDGET = 1 << 22


def _default_rad(nuc, level=3):
    return RAD_GRIDS[level, int((nuc > _PERIOD_EDGES).sum())]


def _default_ang(nuc, level=3):
    return LEBEDEV_ORDER[int(ANG_ORDER[level, int((nuc > _PERIOD_EDGES).sum())])]


def nwchem_prune(nuc, rads, n_ang, radii=radi.BRAGG_RADII):
    """NWChem pruning: smaller angular grids near the nucleus."""
    alphas = np.array(((0.25, 0.5, 1.0, 4.5),
                       (0.1667, 0.5, 0.9, 3.5),
                       (0.1, 0.4, 0.8, 2.5)))
    leb_ngrid = LEBEDEV_NGRID[4:]
    if n_ang < 50:
        return np.repeat(n_ang, len(rads))
    if n_ang == 50:
        leb_l = np.array([1, 2, 2, 2, 1])
    else:
        idx = int(np.where(leb_ngrid == n_ang)[0][0])
        leb_l = np.array([1, 3, idx - 1, idx, idx - 1])
    r_atom = radii[nuc] + 1e-200
    if nuc <= 2:
        place = ((rads / r_atom).reshape(-1, 1) > alphas[0]).sum(axis=1)
    elif nuc <= 10:
        place = ((rads / r_atom).reshape(-1, 1) > alphas[1]).sum(axis=1)
    else:
        place = ((rads / r_atom).reshape(-1, 1) > alphas[2]).sum(axis=1)
    return leb_ngrid[leb_l[place]]


def gen_atomic_grids(mol, atom_grid=None, level=3, prune=nwchem_prune):
    """Per-element (coords, weights) of the single-atom grid (Treutler
    radial grid; `prune` None keeps the full angular grid on every shell)."""
    atom_grid = atom_grid or {}
    tabs = {}
    for ia, symb in enumerate(mol.elements_):
        if symb in tabs:
            continue
        chg = int(mol.charges[ia])
        if symb in atom_grid:
            n_rad, n_ang = atom_grid[symb]
        else:
            n_rad = _default_rad(chg, level)
            n_ang = _default_ang(chg, level)
        rad, dr = radi.treutler(n_rad, chg, ia)
        rad_weight = 4.0 * np.pi * rad ** 2 * dr
        if callable(prune):
            angs = prune(chg, rad, n_ang)
        else:
            angs = np.repeat(n_ang, n_rad)
        coords, weights = [], []
        for n in sorted(set(angs.tolist())):
            idx = np.where(angs == n)[0]
            pts, w = lebedev_grid(int(n))
            coords.append((rad[idx, None, None] * pts[None]).reshape(-1, 3))
            weights.append((rad_weight[idx, None] * w[None]).ravel())
        tabs[symb] = (np.concatenate(coords), np.concatenate(weights))
    return tabs


def becke_weights_plain(coords, w0, owner, atm_coords, inv_dist, a_adj):
    """Plain PyTorch twin of the `becke` kernel: the Becke partition weight
    of every point, w0 * P_owner / sum_i P_i, with Treutler's adjustment.

    coords (n, 3), w0 (n,), owner (n,) int32, atm_coords (natm, 3),
    inv_dist and a_adj (natm, natm); float64 on one device."""
    natm = atm_coords.shape[0]
    eye = torch.eye(natm, dtype=coords.dtype, device=coords.device)
    step = max(1, _PLAIN_BUDGET // (natm * natm))
    out = []
    for i in range(0, coords.shape[0], step):
        c = coords[i:i + step]
        d = c[:, None, :] - atm_coords[None, :, :]
        dist = torch.sqrt(torch.sum(d * d, dim=-1) + 1e-200)
        mu = (dist[:, :, None] - dist[:, None, :]) * inv_dist
        mu = mu + a_adj[None] * (1.0 - mu * mu)
        f = mu
        for _ in range(3):
            f = (1.5 - 0.5 * f * f) * f
        s = 0.5 * (1.0 - f)
        s = s * (1.0 - eye)[None] + eye[None]          # diagonal -> 1
        pbecke = torch.prod(s, dim=2)
        own = torch.gather(pbecke, 1, owner[i:i + step, None].long())[:, 0]
        out.append(w0[i:i + step] * own
                   / torch.clamp(pbecke.sum(dim=1), min=1e-300))
    return torch.cat(out)


def partition_inputs(mol, atom_grids_tab):
    """The inputs of the `becke` kernel on mol.device: the atomic grids
    placed on their atoms, coords (n, 3) and weights w0 (n,), the owning
    atom of each point (n,) int32, the atom coordinates (natm, 3), 1/R_ij
    and the Treutler a_ij (natm, natm)."""
    atm_coords = np.asarray(mol.coords)
    coords, w0, owner = [], [], []
    for ia in range(mol.natm):
        c, w = atom_grids_tab[mol.elements_[ia]]
        coords.append(c + atm_coords[ia])
        w0.append(w)
        owner.append(np.full(w.shape[0], ia, dtype=np.int32))
    atm_dist = np.linalg.norm(
        atm_coords[:, None, :] - atm_coords[None, :, :], axis=2)
    np.fill_diagonal(atm_dist, 1.0)
    a_adj = radi.treutler_atomic_radii_adjust(mol, radi.BRAGG_RADII)
    return tuple(torch.as_tensor(np.ascontiguousarray(a), device=mol.device)
                 for a in (np.concatenate(coords), np.concatenate(w0),
                           np.concatenate(owner), atm_coords,
                           1.0 / atm_dist, a_adj))


def get_partition(mol, atom_grids_tab):
    """(coords (n, 3), weights (n,)) of the molecular grid on mol.device,
    weighted by the Becke partition (kernel `becke`); one atom keeps its
    atomic weights."""
    from ..ops import kernels
    coords, w0, *rest = partition_inputs(mol, atom_grids_tab)
    if mol.natm == 1:
        return coords, w0
    return coords, kernels.becke(coords, w0, *rest)


class Grids:
    """Molecular integration grid (pyscf_tpu/dft/gen_grid.py Grids):
    `level`, `prune` (nwchem_prune or None) and `atom_grid`
    ({symbol: (n_rad, n_ang)}) select it; build() fills `coords` and
    `weights` as float64 tensors on mol.device."""

    level = 3
    prune = staticmethod(nwchem_prune)
    atom_grid = None

    def __init__(self, mol):
        self.mol = mol
        self.coords = None
        self.weights = None

    def build(self):
        tab = gen_atomic_grids(self.mol, self.atom_grid, self.level,
                               self.prune)
        self.coords, self.weights = get_partition(self.mol, tab)
        return self

    @property
    def size(self):
        return 0 if self.weights is None else self.weights.shape[0]

"""Periodic cell.

Counterpart of pyscf_tpu/pbc/gto/cell.py: load_pseudo, Cell (a Mole with
lattice vectors, reciprocal vectors, volume, GTH tables, effective
charges, the real-space cutoff rcut and the default FFT mesh),
get_lattice_Ls, get_Gv, get_uniform_grids, make_kpts, ewald and M. The
geometry stays numpy on the host, as the Mole's shell tables do; the FFTDF
moves what it needs to `Cell.device`. The GTH tables are read by path from
pyscf_tpu/pbc/gto/pseudo_data/, as gto/basis.py reads the basis sets.
"""
import gzip
import json
import os
from functools import lru_cache

import numpy as np
import torch

from ...gto.mole import Mole
from ...lib.parameters import BOHR

_PP_DIR = os.path.join(os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.dirname(os.path.abspath(__file__))))), 'pyscf_tpu', 'pbc', 'gto',
    'pseudo_data')


@lru_cache(maxsize=None)
def _pp_file(stem):
    path = os.path.join(_PP_DIR, stem + '.json.gz')
    if not os.path.exists(path):
        raise KeyError(f'unknown pseudopotential family {stem!r} (no file '
                       f'{path})')
    with gzip.open(path, 'rt') as f:
        return json.load(f)


def load_pseudo(family, symb):
    """GTH parameters of one element: {'nelec', 'rloc', 'cloc', 'nl'}."""
    data = _pp_file(family.lower().replace('-', '').replace('_', ''))
    if symb in data['default']:
        return data['default'][symb]
    key = f'{symb}:{family.upper()}'
    if key in data['variants']:
        return data['variants'][key]
    raise KeyError(f'no {family} pseudopotential for {symb}')


class Cell(Mole):
    """A Mole in a lattice: a (3, 3) rows are the lattice vectors (in
    `unit`), pseudo a GTH family or None, mesh the FFT mesh (default from
    the basis's largest exponent and `precision`). `_pbc_cache` keeps what
    the FFTDF builds per mesh (pbc/df/fft.py)."""
    _CACHE_ATTRS = Mole._CACHE_ATTRS + ('_pbc_cache',)

    def __init__(self, atom=None, a=None, basis='gth-szv', pseudo=None,
                 unit='angstrom', mesh=None, ke_cutoff=None, precision=1e-8,
                 dimension=3, **kwargs):
        super().__init__(atom=atom, basis=basis, unit=unit, **kwargs)
        self.a = a
        self.pseudo = pseudo
        self.mesh = mesh
        self.ke_cutoff = ke_cutoff
        self.precision = precision
        self.dimension = dimension

    def build(self, **kwargs):
        super().build(**kwargs)
        self._pbc_cache = {}
        a = np.asarray(self.a, dtype=np.float64)
        if isinstance(self.unit, str) and self.unit.lower().startswith('a'):
            a = a / BOHR
        self.lattice_vectors_ = a                  # rows = lattice vectors
        self.reciprocal_vectors_ = 2 * np.pi * np.linalg.inv(a).T
        self.vol = abs(np.linalg.det(a))
        self._pseudo = {}
        if self.pseudo is not None:
            for symb in set(self.elements_):
                self._pseudo[symb] = load_pseudo(self.pseudo, symb)
        self.atom_charges_eff = np.array([
            float(sum(self._pseudo[s]['nelec'])) if s in self._pseudo
            else float(z) for s, z in zip(self.elements_, self.charges)])
        exps = [g.exps[g.coeffs != 0] for g in self.shell_groups.values()]
        # pair decay exp(-(min_exp/2) R^2), padded as the JAX package pads it
        self.min_exp = min(float(e.min()) for e in exps)
        self.rcut = 1.4 * np.sqrt(
            2.0 * max(-np.log(self.precision * 1e-4), 5.0) / self.min_exp)
        if self.mesh is None:
            if self.ke_cutoff is None:
                max_exp = max(float(e.max()) for e in exps)
                self.ke_cutoff = 2.0 * max_exp * (-np.log(self.precision))
            gmax = np.sqrt(2.0 * self.ke_cutoff)
            bnorm = np.linalg.norm(self.reciprocal_vectors_, axis=1)
            self.mesh = [int(2 * np.ceil(gmax / b) + 1) for b in bnorm]
        return self

    def lattice_vectors(self):
        return self.lattice_vectors_

    def reciprocal_vectors(self):
        return self.reciprocal_vectors_

    @property
    def nelectron(self):
        return int(self.atom_charges_eff.sum()) - self.charge

    def get_lattice_Ls(self, rcut=None):
        """Lattice translations (n, 3) with |T| <= rcut (default rcut)."""
        rcut = rcut if rcut is not None else self.rcut
        a = self.lattice_vectors_
        nimg = np.ceil(rcut / np.linalg.norm(a, axis=1)).astype(int) + 1
        mg = np.meshgrid(*[np.arange(-n, n + 1) for n in nimg], indexing='ij')
        Ls = np.stack([m.ravel() for m in mg], axis=1) @ a
        return Ls[np.linalg.norm(Ls, axis=1) <= rcut + 1e-9]

    def get_Gv(self, mesh=None):
        """Reciprocal lattice vectors of the FFT mesh (ngrid, 3), in the
        order of np.fft.fftfreq along each axis, C order over the axes."""
        mesh = mesh or self.mesh
        gx = [np.fft.fftfreq(n, 1.0 / n) for n in mesh]
        mg = np.meshgrid(*gx, indexing='ij')
        return np.stack([m.ravel() for m in mg], axis=1) \
            @ self.reciprocal_vectors_

    def get_uniform_grids(self, mesh=None):
        """Real-space uniform grid points (ngrid, 3), C order over the
        mesh."""
        mesh = self.mesh if mesh is None else mesh
        frac = [np.arange(n) / n for n in mesh]
        mg = np.meshgrid(*frac, indexing='ij')
        f = np.stack([m.ravel() for m in mg], axis=1)
        return f @ self.lattice_vectors_

    def make_kpts(self, nks, with_gamma_point=True):
        """Monkhorst-Pack k-points (prod(nks), 3) in Cartesian units (1 /
        Bohr): fractions m / n along each reciprocal vector, Γ-centred, or
        shifted by half a step ((m + 1/2) / n - 1/2) without the Γ point;
        fractions above 1/2 folded by -1, C order over the axes."""
        ks = [np.arange(n) / n if with_gamma_point
              else (np.arange(n) + 0.5) / n - 0.5 for n in nks]
        mg = np.meshgrid(*ks, indexing='ij')
        scaled = np.stack([m.ravel() for m in mg], axis=1)
        scaled = np.where(scaled > 0.5 - 1e-9, scaled - 1.0, scaled)
        return scaled @ self.reciprocal_vectors_

    def energy_nuc(self):
        return self.ewald()

    def ewald(self, ew_eta=None, ew_cut=None):
        """Ewald sum of the effective point charges in the lattice."""
        chg = self.atom_charges_eff
        coords = self.coords
        vol = self.vol
        if ew_eta is None:
            ew_eta = np.sqrt(np.pi) * (len(chg) / vol ** 2) ** (1.0 / 6) \
                + 1e-30
            ew_eta = max(ew_eta, 0.5)
        log_prec = -np.log(self.precision * 1e-2)
        rcut = np.sqrt(log_prec) / ew_eta
        gcut = 2.0 * ew_eta * np.sqrt(log_prec)
        Ls = self.get_lattice_Ls(rcut + np.linalg.norm(
            self.lattice_vectors_, axis=1).max())
        qq = np.outer(chg, chg)
        e_real = 0.0
        for L in Ls:
            r = np.linalg.norm(coords[:, None, :] - coords[None, :, :] + L,
                               axis=2)
            if np.allclose(L, 0):
                np.fill_diagonal(r, np.inf)
            erfc = torch.special.erfc(torch.from_numpy(ew_eta * r)).numpy()
            e_real += 0.5 * np.sum(qq * erfc / r)
        e_self = -ew_eta / np.sqrt(np.pi) * np.sum(chg ** 2)
        e_bg = -np.pi / (2 * ew_eta ** 2 * vol) * np.sum(chg) ** 2
        b = self.reciprocal_vectors_
        nmax = np.ceil(gcut / np.linalg.norm(b, axis=1)).astype(int) + 1
        mg = np.meshgrid(*[np.arange(-n, n + 1) for n in nmax], indexing='ij')
        Gs = np.stack([m.ravel() for m in mg], axis=1) @ b
        G2 = np.einsum('ix,ix->i', Gs, Gs)
        keep = G2 > 1e-12
        Gs, G2 = Gs[keep], G2[keep]
        SI = chg @ np.exp(-1j * coords @ Gs.T)
        e_recip = (2 * np.pi / vol) * np.sum(
            np.abs(SI) ** 2 * np.exp(-G2 / (4 * ew_eta ** 2)) / G2)
        return float(e_real + e_self + e_bg + e_recip)

    def RHF(self, **kwargs):
        from ..scf import RHF
        return RHF(self, **kwargs)

    def RKS(self, xc='lda,vwn', **kwargs):
        from ..dft import RKS
        return RKS(self, xc=xc, **kwargs)

    def UHF(self, **kwargs):
        raise NotImplementedError('unrestricted Γ-point SCF is not ported '
                                  '(pbc.scf.KUHF with one Γ k-point is)')

    UKS = UHF


def M(**kwargs):
    """Shortcut constructor: Cell(**kwargs).build(); on the card unless
    device='cpu' is given."""
    return Cell(**kwargs).build()

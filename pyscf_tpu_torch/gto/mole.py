"""Molecule description and AO-basis layout.

Counterpart of pyscf_tpu/gto/mole.py: Shell, ShellGroup, Mole.build,
nelec, multiplicity, energy_nuc, intor, copy, set_geom_ and M. Shells are
grouped per angular momentum into padded tables (exponents padded with
1.0, coefficients with 0.0) exactly as in the JAX package, so the
screening and the integral kernels see the same inputs. The tables stay
numpy on the host; the integral routines move the pieces they need to
`Mole.device`.

A Mole runs on the card unless the caller asks for the CPU with
`device='cpu'`. Without a CUDA device and without an explicit device,
build() raises: a run meant for the card never lands on the CPU by
accident.
"""
import copy
import math

import numpy as np
import torch

from ..data import elements
from ..lib import parameters as param
from . import basis as basis_mod


def gto_norm(l, expnt):
    """Radial normalization of a primitive r^l exp(-a r^2) Gaussian."""
    return math.sqrt(2.0 * (2.0 * expnt) ** (l + 1.5) / math.gamma(l + 1.5))


class Shell:
    """One segmented contracted shell."""
    __slots__ = ('atom_id', 'l', 'exps', 'coeffs')

    def __init__(self, atom_id, l, exps, coeffs):
        self.atom_id = atom_id
        self.l = l
        self.exps = np.asarray(exps, dtype=np.float64)
        self.coeffs = np.asarray(coeffs, dtype=np.float64)


class ShellGroup:
    """All shells of one angular momentum, padded to a common nprim.

    Fields (numpy, host):
      l          : angular momentum
      coords     : (ns, 3) shell centers (Bohr)
      exps       : (ns, K) exponents (padded with 1.0)
      coeffs     : (ns, K) normalized contraction coefficients (padded 0.0)
      ao_off     : (ns,) offset of first (spherical) AO of each shell
      atom_ids   : (ns,)
    device: where the integral drivers put tensors built from this group.
    """

    def __init__(self, l, coords, exps, coeffs, ao_off, atom_ids, device):
        self.l = int(l)
        self.coords = np.asarray(coords, dtype=np.float64).reshape(-1, 3)
        self.exps = np.asarray(exps, dtype=np.float64)
        self.coeffs = np.asarray(coeffs, dtype=np.float64)
        self.ao_off = np.asarray(ao_off, dtype=np.int32)
        self.atom_ids = np.asarray(atom_ids, dtype=np.int32)
        self.nshl, self.nprim = self.exps.shape
        self.device = torch.device(device)

    @classmethod
    def from_shells(cls, l, shells, coords_of_atom, ao_offsets, device):
        ns = len(shells)
        K = max(len(sh.exps) for sh in shells)
        exps = np.ones((ns, K))
        coeffs = np.zeros((ns, K))
        for i, sh in enumerate(shells):
            k = len(sh.exps)
            exps[i, :k] = sh.exps
            coeffs[i, :k] = sh.coeffs
        atom_ids = [sh.atom_id for sh in shells]
        return cls(l, coords_of_atom[atom_ids], exps, coeffs, ao_offsets,
                   atom_ids, device)

    def tensors(self):
        """(exps, coeffs, coords) as float64 tensors on the group's device."""
        return tuple(torch.as_tensor(a, dtype=torch.float64,
                                     device=self.device).contiguous()
                     for a in (self.exps, self.coeffs, self.coords))


def format_atom(atom, unit='angstrom'):
    """Parse 'O 0 0 0; H 0 1 0' or [('O', (x, y, z)), ...].

    Returns (symbols, raw_symbols, coords[natm, 3] in Bohr)."""
    if isinstance(atom, str):
        entries = []
        for seg in atom.replace('\n', ';').split(';'):
            seg = seg.strip()
            if seg and not seg.startswith('#'):
                toks = seg.replace(',', ' ').split()
                entries.append((toks[0], [float(x) for x in toks[1:4]]))
    else:
        entries = [(item[0], [float(x) for x in item[1]]) for item in atom]
    symbols = [elements.std_symbol(s) for s, _ in entries]
    raw_symbols = [str(s) for s, _ in entries]
    coords = np.array([c for _, c in entries], dtype=np.float64)
    if isinstance(unit, str):
        if unit.lower().startswith(('a', 'ang')):
            coords = coords / param.BOHR
    else:
        coords = coords * unit
    return symbols, raw_symbols, coords


class Mole:
    """Molecular system: geometry, basis, electron counts, AO layout.

        mol = Mole(atom='O 0 0 0; H 0 1 0; H 0 0 1', basis='sto-3g').build()
    """
    _CACHE_ATTRS = ('_j3c_cache', '_df_cache')

    def __init__(self, atom=None, basis='sto-3g', unit='angstrom',
                 charge=0, spin=0, verbose=3, device=None):
        self.atom = atom
        self.basis = basis
        self.unit = unit
        self.charge = charge
        self.spin = spin            # 2S = nalpha - nbeta
        self.verbose = verbose
        self.device = device

    def build(self, **kwargs):
        for k, v in kwargs.items():
            setattr(self, k, v)
        if self.device is None:
            if not torch.cuda.is_available():
                raise RuntimeError(
                    'no CUDA device: pyscf_tpu_torch runs on the card by '
                    "default; pass device='cpu' to run on the CPU")
            self.device = 'cuda'
        self.device = torch.device(self.device)
        self._j3c_cache = {}        # integral tables baked for this geometry
        self._df_cache = {}
        self.elements_, self.raw_symbols, self.coords = format_atom(
            self.atom, self.unit)
        self.charges = np.array([elements.charge(s) for s in self.raw_symbols],
                                dtype=np.int32)
        self.natm = len(self.elements_)

        if isinstance(self.basis, dict):
            def elem_basis(sym, rawsym):
                b = self.basis.get(rawsym, self.basis.get(
                    sym, self.basis.get('default')))
                return basis_mod.load(b, sym) if isinstance(b, str) else b
        else:
            def elem_basis(sym, rawsym):
                if isinstance(self.basis, str):
                    return basis_mod.load(self.basis, sym)
                return self.basis

        # expand into segmented normalized shells
        shells = []
        for ia, sym in enumerate(self.elements_):
            for raw in elem_basis(sym, self.raw_symbols[ia]):
                l = raw[0]
                prims = np.array(raw[1:], dtype=np.float64)
                exps = prims[:, 0]
                for col in range(1, prims.shape[1]):
                    cs = prims[:, col]
                    mask = cs != 0.0
                    if not mask.any():
                        continue
                    e, c = exps[mask], cs[mask]
                    # c are coefficients of normalized primitives; rescale
                    # so the contracted radial function is normalized, then
                    # fold in the primitive norms for the raw-monomial engine
                    ee = e[:, None] + e[None, :]
                    ss = (2.0 * np.sqrt(np.outer(e, e)) / ee) ** (l + 1.5)
                    norm = (c @ ss @ c) ** -0.5
                    cfold = c * norm * np.array([gto_norm(l, ei) for ei in e])
                    shells.append(Shell(ia, l, e, cfold))

        ao_loc = [0]
        for sh in shells:
            ao_loc.append(ao_loc[-1] + (2 * sh.l + 1))
        self.ao_loc = np.asarray(ao_loc, dtype=np.int32)
        self.nao = int(ao_loc[-1])

        self.shell_groups = {}
        for l in range(max((sh.l for sh in shells), default=0) + 1):
            idx = [i for i, sh in enumerate(shells) if sh.l == l]
            if idx:
                self.shell_groups[l] = ShellGroup.from_shells(
                    l, [shells[i] for i in idx], self.coords,
                    [self.ao_loc[i] for i in idx], self.device)
        return self

    @property
    def nelectron(self):
        return int(self.charges.sum()) - self.charge

    @property
    def nelec(self):
        """(n_alpha, n_beta); raises when charge and spin disagree."""
        ne = self.nelectron
        nb = (ne - self.spin) // 2
        na = ne - nb
        if na - nb != self.spin:
            raise RuntimeError(
                f'electron number {ne} and spin {self.spin} inconsistent')
        return na, nb

    @property
    def multiplicity(self):
        return self.spin + 1

    def intor(self, name):
        """Integrals by libcint name (a '_sph' suffix accepted), on
        self.device, in AO order: 'int1e_ovlp', 'int1e_kin' and 'int1e_nuc'
        (nao, nao), S, T and V (kernel `int1e_stv`); 'int2c2e' (nao, nao),
        the Coulomb metric (P|Q) over this Mole's own shells (kernel
        `int2c2e`); 'int2e' (the dense (nao,)^4 ERI tensor, kernel `int2e`);
        'int2e_ip1' (3, nao, nao, nao, nao), 'int1e_ipovlp', 'int1e_ipkin',
        'int1e_ipnuc' (3, nao, nao), the bra-centre derivatives of the
        gradient; and 'int1e_r' (3, nao, nao), the dipole integrals (kernel
        `int1e_r`)."""
        from ..ops.integrals import int1e, int1e_deriv, int2e, j1e, j2e, j3c
        stv = {'int1e_ovlp': 0, 'int1e_kin': 1, 'int1e_nuc': 2}
        fns = {'int2e': j2e.int2e_dense, 'int2e_ip1': int2e.int2e_ip1,
               'int1e_r': int1e.int1e_r, 'int2c2e': j3c.int2c2e_ao,
               'int1e_ipovlp': int1e_deriv.int1e_ipovlp,
               'int1e_ipkin': int1e_deriv.int1e_ipkin,
               'int1e_ipnuc': int1e_deriv.int1e_ipnuc}
        key = name.replace('_sph', '')
        if key in stv:        # a copy: hcore_parts is the Mole's cache
            return j1e.hcore_parts(self)[stv[key]].clone()
        if key.startswith('ECPscalar'):
            raise NotImplementedError(f'intor({name!r}): ECP integrals are '
                                      'not ported yet')
        if key not in fns:
            raise NotImplementedError(f'intor({name!r}) is not ported')
        return fns[key](self)

    def copy(self):
        """A deep copy that shares none of the per-geometry caches
        (screened pairs, S/T/V, derivative integrals, DF factor)."""
        caches = {a: self.__dict__.pop(a) for a in self._CACHE_ATTRS
                  if a in self.__dict__}
        try:
            new = copy.deepcopy(self)
        finally:
            self.__dict__.update(caches)
        for a in caches:
            setattr(new, a, {})
        return new

    def set_geom_(self, coords_bohr):
        """Move the atoms (same order) to coords_bohr (natm, 3) in Bohr and
        rebuild the shell tables; build() starts empty caches."""
        coords = np.asarray(coords_bohr, dtype=np.float64).reshape(-1, 3)
        self.atom = list(zip(self.raw_symbols, coords))
        unit_save, self.unit = self.unit, 'bohr'
        try:
            self.build()
        finally:
            self.unit = unit_save
        return self

    def energy_nuc(self):
        z = self.charges.astype(np.float64)
        r = self.coords
        d = np.linalg.norm(r[:, None, :] - r[None, :, :], axis=-1)
        np.fill_diagonal(d, np.inf)
        return 0.5 * float((z[:, None] * z[None, :] / d).sum())

    def RHF(self, **kwargs):
        from ..scf.hf import RHF
        return RHF(self, **kwargs)

    def UHF(self, **kwargs):
        from ..scf.uhf import UHF
        return UHF(self, **kwargs)

    def RKS(self, xc='lda,vwn', **kwargs):
        from ..dft import RKS
        return RKS(self, xc=xc, **kwargs)

    def UKS(self, xc='lda,vwn', **kwargs):
        from ..dft import UKS
        return UKS(self, xc=xc, **kwargs)


def M(**kwargs):
    """Shortcut constructor: Mole(**kwargs).build()."""
    return Mole(**kwargs).build()

"""The minao initial guess.

Counterpart of pyscf_tpu/scf/init_guess.py (_minao_occupancy,
init_guess_by_minao): a superposition of spherically averaged atomic
densities in the MINAO basis, projected onto mol's basis by
P = S^-1 S_cross.
"""
import numpy as np
import torch

from ..data import elements
from ..gto import basis as basis_mod
from ..gto.mole import Mole


def _minao_occupancy(symb, z):
    """Spherically averaged occupancies per minao AO for one element."""
    raw = basis_mod.load('minao', symb)
    shells = []       # l of each segmented shell, in order
    for entry in raw:
        shells.extend([entry[0]] * (len(entry[1]) - 1))
    conf = list(elements.CONFIGURATION[z])
    occs = []
    remaining = {l: float(conf[l]) if l < 4 else 0.0 for l in range(8)}
    for l in shells:
        cap = 2.0 * (2 * l + 1)
        take = min(cap, remaining.get(l, 0.0))
        remaining[l] = remaining.get(l, 0.0) - take
        occs.extend([take / (2 * l + 1)] * (2 * l + 1))
    return np.array(occs)


def init_guess_by_minao(mol):
    """SAD density matrix in mol's AO basis, on mol.device."""
    from ..ops.integrals.int1e import int1e_ovlp_cross
    from ..ops.integrals.j1e import hcore_parts
    minao_mol = Mole(atom=list(zip(mol.raw_symbols, mol.coords)),
                     basis='minao', unit='bohr', verbose=0,
                     device=mol.device).build()
    occ = np.concatenate([_minao_occupancy(symb, int(mol.charges[ia]))
                          for ia, symb in enumerate(mol.elements_)])
    occ = torch.as_tensor(occ, dtype=torch.float64, device=mol.device)
    s = hcore_parts(mol)[0]
    s_cross = int1e_ovlp_cross(mol, minao_mol)
    p = torch.linalg.solve(s, s_cross)            # (nao, nao_minao)
    return (p * occ[None, :]) @ p.T

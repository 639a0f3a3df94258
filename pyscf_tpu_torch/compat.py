"""Hand-over of state from the JAX package's numpy views into the port.

The tests use these to give both packages identical inputs: shell tables
taken from a pyscf_tpu Mole, and densities or MO coefficients taken from a
pyscf_tpu run (for instance a converged density to seed the port's SCF, a
stacked spin density, or the in-core ERI tensor).
Only numpy arrays cross; this module imports neither jax nor pyscf_tpu.
"""
import numpy as np
import torch

from .gto.mole import ShellGroup


def shell_groups_from_numpy(tables, device):
    """{l: ShellGroup} from {l: {'l', 'coords', 'exps', 'coeffs', 'ao_off',
    'atom_ids'}} numpy tables (the fields of pyscf_tpu's ShellGroup)."""
    return {int(l): ShellGroup(t['l'], t['coords'], t['exps'], t['coeffs'],
                               t['ao_off'], t['atom_ids'], device)
            for l, t in tables.items()}


def tensor_from_numpy(a, device):
    """float64 tensor on `device` from an array-like (density, MO coeffs)."""
    return torch.as_tensor(np.array(a, dtype=np.float64), device=device)


def spin_density_from_numpy(dm, device):
    """float64 (2, nao, nao) tensor [dm_alpha, dm_beta] on `device` from a
    stacked spin density (pyscf_tpu's UHF/UKS make_rdm1)."""
    t = tensor_from_numpy(dm, device)
    if t.dim() != 3 or t.shape[0] != 2 or t.shape[1] != t.shape[2]:
        raise ValueError(f'expected a (2, nao, nao) spin density, got '
                         f'{tuple(t.shape)}')
    return t


def eri_from_numpy(eri, device):
    """float64 (nao, nao, nao, nao) tensor on `device` from a dense ERI
    array (pyscf_tpu's mol.intor('int2e')), to assign to an SCF's _eri."""
    t = tensor_from_numpy(eri, device)
    if t.dim() != 4 or len(set(t.shape)) != 1:
        raise ValueError(f'expected an (nao,)^4 ERI tensor, got '
                         f'{tuple(t.shape)}')
    return t

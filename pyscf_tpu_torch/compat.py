"""Hand-over of state from the JAX package's numpy views into the port.

The tests use these to give both packages identical inputs: shell tables
taken from a pyscf_tpu Mole, and densities or MO coefficients taken from a
pyscf_tpu run (for instance a converged density to seed the port's SCF).
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

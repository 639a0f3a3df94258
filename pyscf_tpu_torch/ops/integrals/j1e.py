"""Screened S/T/V on the device.

Counterpart of pyscf_tpu/ops/integrals/j1e.py:hcore_parts. The screened
shell pairs of the DF engine (j3c._bra_classes) are reused: one launch of
the int1e_stv kernel per bra class computes overlap, kinetic and nuclear
rows together, and one gather assembles (S, T, V). Pairs the screening
drops stay zero, as in the JAX package.
"""
import torch

from .j3c import _assemble, _row_maps, screened_pairs


def hcore_parts(mol):
    """(S, T, V) as one (3, nao, nao) tensor on mol.device, cached."""
    from .. import kernels
    cache = mol._j3c_cache
    if 'stv' in cache:
        return cache['stv']
    dev = mol.device
    zr = torch.as_tensor(mol.coords, dtype=torch.float64, device=dev)
    zq = torch.as_tensor(mol.charges, dtype=torch.float64, device=dev)
    pieces, row_ids = [], []
    for (la, lb), (bc, pairs) in screened_pairs(mol).items():
        pieces.append(kernels.int1e_stv(la, lb, *pairs, zr, zq).reshape(-1, 3))
        row_ids.append(_row_maps(mol, bc))
    nao = mol.nao
    stv = _assemble(pieces, row_ids, nao).T.reshape(3, nao, nao)
    cache['stv'] = stv
    return stv

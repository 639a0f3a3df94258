"""Periodic tools.

Counterpart of pyscf_tpu/pbc/tools/__init__.py (fft, ifft, get_coulG,
madelung, super_cell) and k2gamma.py (k2gamma_mo), on torch tensors.
Unlike the JAX package's madelung, which drops its kpts, this one passes
them on: the probe charge then lives in the Born-von Karman supercell, as
the k-point SCF's exchange uses it (pbc/scf/hf.py madelung).
"""
import numpy as np
import torch

from .k2gamma import k2gamma_mo  # noqa: F401


def fft(f, mesh):
    """FFT of a (batched) real-space periodic function (..., ngrid) on the
    mesh."""
    lead = f.shape[:-1]
    return torch.fft.fftn(f.reshape(*lead, *mesh),
                          dim=(-3, -2, -1)).reshape(*lead, -1)


def ifft(g, mesh):
    lead = g.shape[:-1]
    return torch.fft.ifftn(g.reshape(*lead, *mesh),
                           dim=(-3, -2, -1)).reshape(*lead, -1)


def get_coulG(cell, k=None, mesh=None):
    """4 pi / |G + k|^2 on the FFT mesh (ngrid,) on cell.device, 0 where G
    + k = 0 (the exchange's probe-charge term is added apart)."""
    from ..df.fft import coulG
    return coulG(cell, mesh or cell.mesh, k)


def madelung(cell, kpts=None):
    from ..scf.hf import madelung as _madelung
    return _madelung(cell, kpts)


def super_cell(cell, ncopy):
    """The cell repeated ncopy = [n1, n2, n3] times, atoms (and so AOs)
    image-major, as k2gamma_mo orders them; the mesh scaled alike."""
    from ..gto.cell import Cell
    a = np.asarray(cell.lattice_vectors_)
    atoms = []
    for i in range(ncopy[0]):
        for j in range(ncopy[1]):
            for k in range(ncopy[2]):
                shift = i * a[0] + j * a[1] + k * a[2]
                for symb, r in zip(cell.elements_, np.asarray(cell.coords)):
                    atoms.append((symb, tuple(r + shift)))
    return Cell(atom=atoms, a=np.asarray(ncopy, float)[:, None] * a,
                unit='bohr', basis=cell.basis, pseudo=cell.pseudo,
                mesh=[n * c for n, c in zip(cell.mesh, ncopy)],
                precision=cell.precision, verbose=0,
                device=cell.device).build()

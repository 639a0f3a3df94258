"""k-point orbitals unfolded onto the Born-von Karman supercell at Γ.

Counterpart of pyscf_tpu/pbc/tools/k2gamma.py (k2gamma_mo).
"""
import numpy as np
import torch


def k2gamma_mo(cell, kpts, mo_coeff_kpts, ncopy):
    """Supercell Γ orbitals (nk nao, nk nmo) of k-point orbitals
    mo_coeff_kpts (nk, nao, nmo): C^sc[(T, mu), (k, n)] = e^{ik.T} C^k[mu,
    n] / sqrt(nk) over the translations T of the supercell (image-major,
    as tools.super_cell orders its atoms), each column then divided by
    the phase of its largest element (real for a Γ-inclusive mesh)."""
    a = np.asarray(cell.lattice_vectors_)
    Ts = np.array([i * a[0] + j * a[1] + k * a[2]
                   for i in range(ncopy[0]) for j in range(ncopy[1])
                   for k in range(ncopy[2])])
    kpts = np.asarray(kpts).reshape(-1, 3)
    nk = len(kpts)
    if nk != len(Ts):
        raise ValueError(f'{nk} k-points for a supercell of {len(Ts)} cells')
    c = torch.as_tensor(mo_coeff_kpts)
    nao, nmo = c.shape[1:]
    phase = torch.as_tensor(np.exp(1j * (Ts @ kpts.T)) / np.sqrt(nk),
                            dtype=torch.complex128, device=c.device)
    csc = torch.einsum('tk,kmn->tmkn', phase, c.to(torch.complex128))
    csc = csc.reshape(nk * nao, nk * nmo)
    big = csc.abs().argmax(0)
    top = csc[big, torch.arange(nk * nmo, device=c.device)]
    return csc / (top / top.abs())

"""Γ-point periodic systems (counterpart of pyscf_tpu/pbc, its Γ half).

    from pyscf_tpu_torch.pbc import gto, dft, scf
    cell = gto.M(atom='C 0 0 0; C 0.8917 0.8917 0.8917',
                 a=[[0, 1.7834, 1.7834], [1.7834, 0, 1.7834],
                    [1.7834, 1.7834, 0]],
                 basis='gth-szv', pseudo='gth-pade', mesh=[15] * 3)
    e = dft.RKS(cell, xc='pbe').kernel()                  # FFTDF
    e = dft.RKS(cell, xc='pbe').density_fit().kernel()    # GDF
    e = scf.RHF(cell).kernel()                            # exxdiv 'ewald'

k-points, the multigrid and the analytic Fourier transforms are not
ported yet.
"""
from . import df, dft, gto, scf  # noqa: F401
from .gto import Cell, M  # noqa: F401

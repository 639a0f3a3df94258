"""Periodic systems at the Γ point and over k-point meshes (counterpart
of pyscf_tpu/pbc: its Γ half and its k-point FFTDF SCF).

    from pyscf_tpu_torch.pbc import gto, dft, scf
    cell = gto.M(atom='C 0 0 0; C 0.8917 0.8917 0.8917',
                 a=[[0, 1.7834, 1.7834], [1.7834, 0, 1.7834],
                    [1.7834, 1.7834, 0]],
                 basis='gth-szv', pseudo='gth-pade', mesh=[15] * 3)
    e = dft.RKS(cell, xc='pbe').kernel()                  # FFTDF
    e = dft.RKS(cell, xc='pbe').density_fit().kernel()    # GDF
    e = scf.RHF(cell).kernel()                            # exxdiv 'ewald'
    kpts = cell.make_kpts([2, 2, 2])
    e = dft.KRKS(cell, kpts=kpts, xc='pbe').kernel()      # KFFTDF
    e = scf.KRHF(cell, kpts=kpts).kernel()                # also KUHF, KUKS

k-point Gaussian density fitting (KGDF), the analytic Fourier transforms
(AFTDF), the multigrid and k-point post-HF are not ported yet.
"""
from . import df, dft, gto, scf, tools  # noqa: F401
from .gto import Cell, M  # noqa: F401

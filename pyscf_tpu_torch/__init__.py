"""pyscf_tpu_torch: the PyTorch/CUDA port of pyscf_tpu for one NVIDIA H100.

Mirrors pyscf_tpu's module paths. The integral kernels are hand-written
CUDA (csrc/), each with a plain PyTorch twin that runs on the CPU. Every
Mole names its device explicitly:

    import pyscf_tpu_torch as pt
    mol = pt.M(atom='O 0 0 0; H 0 -0.757 0.587; H 0 0.757 0.587',
               basis='cc-pvdz', device='cuda')
    e = mol.RHF().density_fit().kernel()
"""
from .gto.mole import M, Mole  # noqa: F401

"""Nuclear gradients: analytic for conventional RHF (grad/rhf.py), central
differences for conventional UHF and RKS (grad/uhf.py, grad/rks.py), as in
pyscf_tpu/grad. Density-fitted mean fields raise until the DF derivative
kernels are ported."""
from . import rhf
from .rhf import finite_difference_gradient

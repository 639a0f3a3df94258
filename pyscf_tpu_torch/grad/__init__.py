"""Nuclear gradients, as in pyscf_tpu/grad: analytic for conventional RHF
(grad/rhf.py) and for density-fitted RHF, RKS and UHF (grad/df.py);
central differences for conventional UHF and RKS (grad/uhf.py,
grad/rks.py). UKS gradients raise until the spin-polarized XC gradient
kernel is ported."""
from . import rhf
from .rhf import finite_difference_gradient

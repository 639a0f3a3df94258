"""Nuclear gradients, as in pyscf_tpu/grad: analytic for conventional RHF
(grad/rhf.py) and for density-fitted RHF, RKS, UHF and UKS (grad/df.py);
central differences for conventional UHF and RKS (grad/uhf.py,
grad/rks.py). A conventional UKS gradient raises (grad/uks.py)."""
from . import rhf
from .rhf import finite_difference_gradient

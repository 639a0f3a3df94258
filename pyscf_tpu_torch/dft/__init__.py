"""Kohn-Sham DFT: RKS and UKS with LDA and GGA functionals."""
from .rks import RKS  # noqa: F401
from .uks import UKS  # noqa: F401
from .numint import NumInt  # noqa: F401
from .gen_grid import Grids  # noqa: F401

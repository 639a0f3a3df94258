"""Kohn-Sham DFT: closed-shell RKS with LDA and GGA functionals."""
from .rks import RKS  # noqa: F401
from .numint import NumInt  # noqa: F401
from .gen_grid import Grids  # noqa: F401

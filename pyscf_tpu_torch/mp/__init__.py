"""Moller-Plesset perturbation theory: MP2 and UMP2."""
from .mp2 import MP2, RMP2  # noqa: F401
from .ump2 import UMP2  # noqa: F401

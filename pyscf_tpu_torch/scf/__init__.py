"""Mean-field methods: RHF and UHF, density-fitted or in-core."""
from .hf import RHF, SCF  # noqa: F401
from .uhf import UHF  # noqa: F401

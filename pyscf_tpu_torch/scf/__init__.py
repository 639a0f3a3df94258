"""Mean-field methods: density-fitted RHF."""
from .hf import RHF, SCF  # noqa: F401

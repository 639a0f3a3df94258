"""Coupled cluster: closed-shell CCSD and CCSD(T)."""
from .ccsd import CCSD, RCCSD  # noqa: F401

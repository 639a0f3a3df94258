"""Time-dependent SCF (counterpart of pyscf_tpu/tdscf)."""
from .rhf import TDA, TDDFT, TDHF, get_ab  # noqa: F401
from .uhf import TDAUHF, TDAUKS  # noqa: F401

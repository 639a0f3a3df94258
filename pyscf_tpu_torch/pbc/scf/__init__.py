from .hf import RHF, madelung  # noqa: F401

from .rks import RKS  # noqa: F401

"""Density fitting."""
from .df import DF  # noqa: F401
from .addons import make_auxbasis, make_auxmol  # noqa: F401
from .df_jk import density_fit  # noqa: F401

from .fft import FFTDF, eval_ao_periodic  # noqa: F401
from .gdf import GDF  # noqa: F401

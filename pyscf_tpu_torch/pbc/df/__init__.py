from .fft import FFTDF, KFFTDF, eval_ao_kpts, eval_ao_periodic  # noqa: F401
from .gdf import GDF  # noqa: F401

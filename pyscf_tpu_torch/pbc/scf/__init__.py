from .hf import RHF, madelung  # noqa: F401
from .khf import KRHF  # noqa: F401
from .kuhf import KUHF  # noqa: F401

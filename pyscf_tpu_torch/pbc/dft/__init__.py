from .krks import KRKS  # noqa: F401
from .kuks import KUKS  # noqa: F401
from .rks import RKS  # noqa: F401

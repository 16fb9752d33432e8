from .kernel import rglru_scan_fwd  # noqa: F401
from .ops import rglru_scan  # noqa: F401
from .ref import rglru_reference  # noqa: F401

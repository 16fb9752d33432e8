from .kernel import rglru_scan_bwd, rglru_scan_fwd  # noqa: F401
from .ops import RGLRUScan, rglru_scan  # noqa: F401
from .ref import rglru_reference, rglru_scan_bwd_reference  # noqa: F401

from .kernel import rglru_scan_bwd, rglru_scan_fwd  # noqa: F401
from .ops import rglru_scan, rglru_scan_bwd_op, rglru_scan_op  # noqa: F401
from .ref import rglru_reference, rglru_scan_bwd_reference  # noqa: F401

from .kernel import rwkv6_wkv_bwd, rwkv6_wkv_fwd  # noqa: F401
from .ops import rwkv6_wkv, rwkv6_wkv_bwd_op, rwkv6_wkv_op  # noqa: F401
from .ref import rwkv6_reference, rwkv6_wkv_bwd_reference  # noqa: F401

from .kernel import rwkv6_wkv_fwd  # noqa: F401
from .ops import rwkv6_wkv  # noqa: F401
from .ref import rwkv6_reference  # noqa: F401

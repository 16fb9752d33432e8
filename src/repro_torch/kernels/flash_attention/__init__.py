from .kernel import flash_attention_fwd  # noqa: F401
from .ops import chunked_attention, decode_attention, flash_attention  # noqa: F401
from .ref import attention_reference  # noqa: F401

from .kernel import flash_attention_bwd, flash_attention_fwd  # noqa: F401
from .ops import (FlashAttention, chunked_attention, decode_attention,  # noqa: F401
                  flash_attention)
from .ref import (attention_reference, flash_attention_bwd_reference,  # noqa: F401
                  lse_reference)

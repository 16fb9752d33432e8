from .kernel import flash_attention_bwd, flash_attention_fwd  # noqa: F401
from .ops import (chunked_attention, decode_attention, flash_attention,  # noqa: F401
                  flash_attention_bwd_op, flash_attention_op)
from .ref import (attention_reference, flash_attention_bwd_reference,  # noqa: F401
                  lse_reference)

from .steps import (batch_specs, ideal_bytes, input_specs,  # noqa: F401
                    make_decode_step, make_prefill_step, make_train_step, useful_flops)

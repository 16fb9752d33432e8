from .adamw import (  # noqa: F401
    adamw_init,
    adamw_update,
    cosine_schedule,
    global_norm,
    init_train_state,
    train_state_specs,
)

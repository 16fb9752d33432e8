from .steps import make_train_step, useful_flops  # noqa: F401

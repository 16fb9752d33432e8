"""Registry of the architectures the port runs.

An architecture joins the registry with the modules that run it; ids use
the same names as the JAX package's registry.
"""
from repro_torch.types import ArchConfig

from . import qwen3_1_7b, recurrentgemma_2b, rwkv6_7b

ARCHS = {cfg.name: cfg for cfg in (qwen3_1_7b.CONFIG, rwkv6_7b.CONFIG,
                                   recurrentgemma_2b.CONFIG)}


def get_config(name: str) -> ArchConfig:
    if name not in ARCHS:
        raise KeyError(f"unknown arch {name!r}; available: {sorted(ARCHS)}")
    return ARCHS[name]

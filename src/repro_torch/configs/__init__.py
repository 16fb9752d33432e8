"""Registry of the architectures the port runs.

An architecture joins the registry with the modules that run it; ids use
the same names as the JAX package's registry, in its order: the scheduler's
trace makers and its service draw ``rng.choice`` over ``ARCHS.values()``, so
the order is part of every trace.
"""
from repro_torch.types import SHAPES, ArchConfig, ShapeConfig, applicable  # noqa: F401

from . import (hubert_xlarge, minicpm3_4b, minitron_4b, pixtral_12b, qwen2_moe_a2_7b,
               qwen3_1_7b, qwen3_moe_30b_a3b, recurrentgemma_2b, rwkv6_7b, yi_9b)

ARCHS = {cfg.name: cfg for cfg in (recurrentgemma_2b.CONFIG, qwen2_moe_a2_7b.CONFIG,
                                   qwen3_moe_30b_a3b.CONFIG, yi_9b.CONFIG,
                                   qwen3_1_7b.CONFIG, minicpm3_4b.CONFIG,
                                   minitron_4b.CONFIG, pixtral_12b.CONFIG,
                                   hubert_xlarge.CONFIG, rwkv6_7b.CONFIG)}


def get_config(name: str) -> ArchConfig:
    if name not in ARCHS:
        raise KeyError(f"unknown arch {name!r}; available: {sorted(ARCHS)}")
    return ARCHS[name]


def get_shape(name: str) -> ShapeConfig:
    if name not in SHAPES:
        raise KeyError(f"unknown shape {name!r}; available: {sorted(SHAPES)}")
    return SHAPES[name]

"""Parameter schema: shapes, logical axes and initializers of every parameter.

The same tree as the JAX package's ``model_schema`` (same keys, same shapes,
stacked ``blocks`` with a leading layer dim), so that a parameter tree made
by either package feeds the other.  Initialization follows the same
distributions (``fan_in``, ``normal``, ``zeros``), drawn from a
``torch.Generator``; it does not give the JAX package's bits.

The port covers the dense GQA decoder and the RWKV6 block; other block
kinds raise.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Optional, Tuple

import torch

from repro_torch import resolve_device
from repro_torch.types import ArchConfig


@dataclass(frozen=True)
class Param:
    shape: Tuple[int, ...]
    axes: Tuple[Optional[str], ...]
    init: str = "fan_in"       # fan_in | normal | zeros
    scale: float = 1.0
    dtype: Optional[str] = None  # a fixed dtype (e.g. the f32 RWKV decay and bonus)

    def __post_init__(self):
        if len(self.shape) != len(self.axes):
            raise ValueError(f"shape {self.shape} and axes {self.axes} differ in rank")


def _attn_schema(cfg: ArchConfig):
    d, h, kh, hd = cfg.d_model, cfg.padded_heads, cfg.n_kv_heads, cfg.head_dim
    s = {
        "ln1": Param((d,), ("embed",), "zeros"),
        "wq": Param((d, h, hd), ("embed", "heads", "head_dim")),
        "wk": Param((d, kh, hd), ("embed", "kv_heads", "head_dim")),
        "wv": Param((d, kh, hd), ("embed", "kv_heads", "head_dim")),
        "wo": Param((h, hd, d), ("heads", "head_dim", "embed")),
    }
    if cfg.qk_norm:
        s["q_norm"] = Param((hd,), ("head_dim",), "zeros")
        s["k_norm"] = Param((hd,), ("head_dim",), "zeros")
    return s


def _mlp_schema(cfg: ArchConfig):
    d, f = cfg.d_model, cfg.d_ff
    s = {}
    if cfg._gated:
        s["mlp_wg"] = Param((d, f), ("embed", "ffn"))
    s["mlp_wu"] = Param((d, f), ("embed", "ffn"))
    s["mlp_wo"] = Param((f, d), ("ffn", "embed"))
    return s


def _rwkv_schema(cfg: ArchConfig):
    d = cfg.d_model
    hd = cfg.rwkv_head_dim
    h = d // hd
    return {
        "ln1": Param((d,), ("embed",), "zeros"),
        "tm_mu_x": Param((d,), ("embed",), "zeros"),
        "tm_mus": Param((5, d), (None, "embed"), "zeros"),
        "tm_w1": Param((d, 5 * 32), ("embed", "lora")),
        "tm_w2": Param((5, 32, d), (None, "lora", "embed"), scale=0.1),
        "decay_base": Param((d,), ("embed",), "normal", dtype="float32"),
        "decay_w1": Param((d, 64), ("embed", "lora")),
        "decay_w2": Param((64, d), ("lora", "embed"), scale=0.1),
        "u": Param((h, hd), ("heads", "head_dim"), "normal", dtype="float32"),
        "wr": Param((d, h, hd), ("embed", "heads", "head_dim")),
        "wk": Param((d, h, hd), ("embed", "heads", "head_dim")),
        "wv": Param((d, h, hd), ("embed", "heads", "head_dim")),
        "wg": Param((d, h, hd), ("embed", "heads", "head_dim")),
        "wo": Param((h, hd, d), ("heads", "head_dim", "embed")),
        "ln_x": Param((h, hd), ("heads", "head_dim"), "zeros"),
        "ln2": Param((d,), ("embed",), "zeros"),
        "cm_mu_k": Param((d,), ("embed",), "zeros"),
        "cm_mu_r": Param((d,), ("embed",), "zeros"),
        "cm_k": Param((d, cfg.d_ff), ("embed", "ffn")),
        "cm_v": Param((cfg.d_ff, d), ("ffn", "embed")),
        "cm_r": Param((d, d), ("embed", None)),
    }


def block_schema(cfg: ArchConfig, kind: str):
    if kind == "rwkv":
        return _rwkv_schema(cfg)
    if kind not in ("attn", "attn_local") or cfg.attn_kind != "gqa":
        raise NotImplementedError(
            f"{cfg.name}: block kind {kind!r} with attn_kind {cfg.attn_kind!r} "
            "is not ported yet")
    if cfg.moe is not None:
        raise NotImplementedError(f"{cfg.name}: MoE blocks are not ported yet")
    s = _attn_schema(cfg)
    s["ln2"] = Param((cfg.d_model,), ("embed",), "zeros")
    s.update(_mlp_schema(cfg))
    return s


def _stack(schema, n):
    return {k: Param((n,) + p.shape, ("layers",) + p.axes, p.init, p.scale, p.dtype)
            for k, p in schema.items()}


def model_schema(cfg: ArchConfig):
    """Full parameter schema for one architecture."""
    if not cfg.has_decoder:
        raise NotImplementedError(f"{cfg.name}: encoder-only models are not ported yet")
    if not cfg.uniform_blocks:
        raise NotImplementedError(f"{cfg.name}: mixed block kinds are not ported yet")
    d, v = cfg.d_model, cfg.padded_vocab
    tree = {"embed": Param((v, d), ("vocab", "embed"), "normal"),
            "final_norm": Param((d,), ("embed",), "zeros")}
    if not cfg.tie_embeddings:
        tree["lm_head"] = Param((d, v), ("embed", "vocab"))
    tree["blocks"] = _stack(block_schema(cfg, cfg.layer_kinds()[0]), cfg.n_layers)
    return tree


def _leaves(tree, prefix=()):
    """(path, Param) pairs in sorted-key order, the order jax flattens a dict."""
    for k in sorted(tree):
        v = tree[k]
        if isinstance(v, Param):
            yield prefix + (k,), v
        else:
            yield from _leaves(v, prefix + (k,))


def _build(schema, make):
    out = {}
    for path, p in _leaves(schema):
        node = out
        for k in path[:-1]:
            node = node.setdefault(k, {})
        node[path[-1]] = make(p)
    return out


def _fan_in(p: Param) -> int:
    # contraction dims: (a, b) -> a; (D, h, d) in-projection -> D;
    # (h, d, D) out-projection -> h*d; (f, k, D) stacked LoRA-up -> k
    sh, ax = p.shape, p.axes
    if ax and ax[0] == "layers":  # stacked: strip the leading layer dim
        sh, ax = sh[1:], ax[1:]
    if len(sh) == 3 and ax[-1] == "embed":
        return sh[0] * sh[1] if ax[0] == "heads" else sh[1]
    return sh[0]


def leaf_dtype(p: Param, default):
    return getattr(torch, p.dtype) if p.dtype else default


def init_params(cfg: ArchConfig, generator: torch.Generator,
                dtype=torch.float32, device="cuda"):
    """Random parameters with the schema's distributions, made on ``device``.

    ``generator`` must live on the same device (``torch.Generator(device)``).
    """
    dev = resolve_device(device)

    def make(p: Param):
        dt = leaf_dtype(p, dtype)
        if p.init == "zeros":
            return torch.zeros(p.shape, dtype=dt, device=dev)
        z = torch.randn(p.shape, generator=generator, dtype=torch.float32, device=dev)
        std = p.scale if p.init == "normal" else p.scale / (_fan_in(p) ** 0.5)
        return (z * std).to(dt)

    return _build(model_schema(cfg), make)


def abstract_params(cfg: ArchConfig, dtype=torch.bfloat16):
    """The parameter tree as tensors on the ``meta`` device: shapes, no data."""
    return _build(model_schema(cfg),
                  lambda p: torch.empty(p.shape, dtype=leaf_dtype(p, dtype), device="meta"))

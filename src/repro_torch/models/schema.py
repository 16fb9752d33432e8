"""Parameter schema: shapes, logical axes and initializers of every parameter.

The same tree as the JAX package's ``model_schema`` (same keys, same shapes,
stacked ``blocks`` with a leading layer dim when every layer has the same
kind, a list of per-layer dicts when kinds mix), so that a parameter tree
made by either package feeds the other.  Initialization follows the same
distributions (``fan_in``, ``normal``, ``zeros``, ``lru_lambda``), drawn from
a ``torch.Generator``; it does not give the JAX package's bits.

The port covers the dense decoder with GQA or MLA attention (gated or
ungated MLP, or MoE), the RWKV6 block, the RG-LRU hybrid and the
encoder-only model, whose head is ``cls_head``.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Optional, Tuple

import torch

from repro_torch import resolve_device
from repro_torch.types import ArchConfig

RGLRU_BLOCKS = 16  # block-diagonal gate projections: 16 blocks, as the reference


@dataclass(frozen=True)
class Param:
    shape: Tuple[int, ...]
    axes: Tuple[Optional[str], ...]
    init: str = "fan_in"       # fan_in | normal | zeros | lru_lambda
    scale: float = 1.0
    dtype: Optional[str] = None  # a fixed dtype (e.g. the f32 RWKV decay, the LRU's lam)

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


def _mla_schema(cfg: ArchConfig):
    """Multi-head latent attention: the query's low-rank path (wq_a, its
    norm, wq_b to nope + rope dims a head), the joint kv compression (wkv_a
    to the latent and the shared rotary key, the latent's norm, wkv_b to
    nope + v dims a head) and wo from the v dims."""
    d, h, m = cfg.d_model, cfg.padded_heads, cfg.mla
    qk = m.qk_nope_dim + m.qk_rope_dim
    return {
        "ln1": Param((d,), ("embed",), "zeros"),
        "wq_a": Param((d, m.q_lora_rank), ("embed", "lora")),
        "q_a_norm": Param((m.q_lora_rank,), ("lora",), "zeros"),
        "wq_b": Param((m.q_lora_rank, h, qk), ("lora", "heads", "qk_dim")),
        "wkv_a": Param((d, m.kv_lora_rank + m.qk_rope_dim), ("embed", "lora")),
        "kv_a_norm": Param((m.kv_lora_rank,), ("lora",), "zeros"),
        "wkv_b": Param((m.kv_lora_rank, h, m.qk_nope_dim + m.v_head_dim),
                       ("lora", "heads", "qk_dim")),
        "wo": Param((h, m.v_head_dim, d), ("heads", "v_dim", "embed")),
    }


def _mlp_schema(cfg: ArchConfig, d_ff=None, prefix="mlp_", ffn_axis="ffn"):
    d = cfg.d_model
    f = d_ff or cfg.d_ff
    s = {}
    if cfg._gated:
        s[prefix + "wg"] = Param((d, f), ("embed", ffn_axis))
    s[prefix + "wu"] = Param((d, f), ("embed", ffn_axis))
    s[prefix + "wo"] = Param((f, d), (ffn_axis, "embed"))
    return s


def _moe_schema(cfg: ArchConfig):
    """The MoE branch: its norm, an f32 router over the padded experts, the
    stacked experts (E, D, f) and (E, f, D), and the shared experts with
    their gate where the config has them."""
    d, m = cfg.d_model, cfg.moe
    ep = cfg.padded_experts
    s = {
        "ln2": Param((d,), ("embed",), "zeros"),
        "router": Param((d, ep), ("embed", "experts"), dtype="float32"),
    }
    if cfg._gated:
        s["we_g"] = Param((ep, d, m.d_expert), ("experts", "embed", "expert_ffn"))
    s["we_u"] = Param((ep, d, m.d_expert), ("experts", "embed", "expert_ffn"))
    s["we_o"] = Param((ep, m.d_expert, d), ("experts", "expert_ffn", "embed"))
    if m.n_shared:
        s.update(_mlp_schema(cfg, d_ff=m.d_shared, prefix="sh_", ffn_axis="shared_ffn"))
        s["sh_gate"] = Param((d,), ("embed",))
    return s


def _rglru_schema(cfg: ArchConfig):
    d = cfg.d_model
    w = cfg.lru_width or d
    g = RGLRU_BLOCKS
    wb = w // g
    return {
        "ln1": Param((d,), ("embed",), "zeros"),
        "w_in": Param((d, 2, w), ("embed", None, "lru_blocks")),
        "conv_w": Param((4, w), (None, "lru_blocks"), scale=0.5),
        "conv_b": Param((w,), ("lru_blocks",), "zeros"),
        "gate_r": Param((g, wb, wb), ("lru_blocks", "lru_width", "lru_width")),
        "gate_i": Param((g, wb, wb), ("lru_blocks", "lru_width", "lru_width")),
        "bias_r": Param((w,), ("lru_blocks",), "zeros"),
        "bias_i": Param((w,), ("lru_blocks",), "zeros"),
        "lam": Param((w,), ("lru_blocks",), "lru_lambda", dtype="float32"),
        "w_out": Param((w, d), ("lru_blocks", "embed")),
    }


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
    if kind == "rglru":
        s = _rglru_schema(cfg)
    elif kind in ("attn", "attn_local") and cfg.attn_kind in ("gqa", "mla"):
        s = _attn_schema(cfg) if cfg.attn_kind == "gqa" else _mla_schema(cfg)
    else:
        raise NotImplementedError(
            f"{cfg.name}: block kind {kind!r} with attn_kind {cfg.attn_kind!r} "
            "is not ported yet")
    if cfg.moe is not None:
        s.update(_moe_schema(cfg))
    else:
        s["ln2"] = Param((cfg.d_model,), ("embed",), "zeros")
        s.update(_mlp_schema(cfg))
    return s


def _stack(schema, n):
    return {k: Param((n,) + p.shape, ("layers",) + p.axes, p.init, p.scale, p.dtype)
            for k, p in schema.items()}


def model_schema(cfg: ArchConfig):
    """Full parameter schema for one architecture."""
    d, v = cfg.d_model, cfg.padded_vocab
    tree = {"embed": Param((v, d), ("vocab", "embed"), "normal"),
            "final_norm": Param((d,), ("embed",), "zeros")}
    if cfg.has_decoder and not cfg.tie_embeddings:
        tree["lm_head"] = Param((d, v), ("embed", "vocab"))
    if not cfg.has_decoder:
        tree["cls_head"] = Param((d, v), ("embed", "vocab"))
    kinds = cfg.layer_kinds()
    if cfg.uniform_blocks:
        tree["blocks"] = _stack(block_schema(cfg, kinds[0]), cfg.n_layers)
    else:
        tree["blocks"] = [block_schema(cfg, k) for k in kinds]
    return tree


def map_schema(tree, make):
    """``tree`` with ``make`` applied to each Param, walked in the order jax
    flattens it (dict keys sorted, lists in order)."""
    if isinstance(tree, Param):
        return make(tree)
    if isinstance(tree, list):
        return [map_schema(v, make) for v in tree]
    return {k: map_schema(tree[k], make) for k in sorted(tree)}


def _fan_in(p: Param) -> int:
    # contraction dims: (a, b) -> a; (D, h, d) in-projection -> D;
    # (h, d, D) out-projection -> h*d; (E, f, D) and (f, k, D) -> the middle
    # dim; (E, D, f) experts -> D; (g, w, v) block-diagonal -> w
    sh, ax = p.shape, p.axes
    if ax and ax[0] == "layers":  # stacked: strip the leading layer dim
        sh, ax = sh[1:], ax[1:]
    if len(sh) == 3:
        if ax[-1] == "embed":
            return sh[0] * sh[1] if ax[0] == "heads" else sh[1]
        if ax[0] in ("experts", "lru_blocks"):
            return sh[1]
    return sh[0]


def leaf_dtype(p: Param, default):
    return getattr(torch, p.dtype) if p.dtype else default


def init_params(cfg: ArchConfig, generator: torch.Generator,
                dtype=torch.float32, device="cuda"):
    """Random parameters with the schema's distributions, made on ``device``.

    ``generator`` must live on the same device (``torch.Generator(device)``).
    A normal or fan-in leaf is drawn straight into its dtype: ``normal_``
    forms each value in f32 and rounds it once, as ``(randn * std).to(dtype)``
    does, with no f32 temporary (qwen3-moe-30b-a3b's stacked ``we_u`` in f32
    would be 38.7 GB).
    """
    dev = resolve_device(device)

    def make(p: Param):
        dt = leaf_dtype(p, dtype)
        if p.init == "zeros":
            return torch.zeros(p.shape, dtype=dt, device=dev)
        if p.init == "lru_lambda":
            # a = sigmoid(lam) ** 8 in (0.9, 0.999): the standard LRU init
            u = torch.rand(p.shape, generator=generator, dtype=torch.float32, device=dev)
            a8 = (0.9 + (0.999 - 0.9) * u) ** (1.0 / 8.0)
            return torch.log(a8 / (1 - a8)).to(dt)
        std = p.scale if p.init == "normal" else p.scale / (_fan_in(p) ** 0.5)
        return torch.empty(p.shape, dtype=dt, device=dev).normal_(0.0, std, generator=generator)

    return map_schema(model_schema(cfg), make)


def abstract_params(cfg: ArchConfig, dtype=torch.bfloat16):
    """The parameter tree as tensors on the ``meta`` device: shapes, no data."""
    return map_schema(model_schema(cfg),
                  lambda p: torch.empty(p.shape, dtype=leaf_dtype(p, dtype), device="meta"))

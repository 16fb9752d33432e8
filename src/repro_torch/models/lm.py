"""LM assembly (``repro.models.lm`` twin) for the dense GQA decoder.

Modes:
  train   — full-sequence forward, no cache
  prefill — full-sequence forward that fills the decode cache
  decode  — one token against the cache

The stacked ``blocks`` (leading layer dim) are walked by a Python loop.  The
cache's tensors are written in place; its ``pos`` is a Python int.
"""
from __future__ import annotations

import torch

from repro_torch import resolve_device
from repro_torch.types import ArchConfig

from .attention import gqa_block
from .layers import mlp_apply, rms_norm
from .schema import abstract_params, init_params, model_schema  # noqa: F401  (re-exported)


def cache_schema(cfg: ArchConfig, batch: int, max_len: int):
    """Shapes of the stacked per-layer KV cache: {"k", "v"} of (L, B, S, KH, hd)."""
    kinds = cfg.layer_kinds()
    if not cfg.uniform_blocks or kinds[0] not in ("attn", "attn_local") \
            or cfg.attn_kind != "gqa":
        raise NotImplementedError(f"{cfg.name}: only the GQA cache is ported yet")
    S = min(cfg.local_window, max_len) if kinds[0] == "attn_local" else max_len
    shape = (cfg.n_layers, batch, S, cfg.n_kv_heads, cfg.head_dim)
    return {"k": shape, "v": shape}


def init_cache(cfg: ArchConfig, batch: int, max_len: int, dtype=torch.bfloat16,
               device="cuda"):
    dev = resolve_device(device)
    layers = {name: torch.zeros(shape, dtype=dtype, device=dev)
              for name, shape in cache_schema(cfg, batch, max_len).items()}
    return {"pos": 0, "layers": layers}


def _block_apply(kind, p, x, *, cfg, positions, mode, cache, pos):
    if kind not in ("attn", "attn_local") or cfg.attn_kind != "gqa" or cfg.moe is not None:
        raise NotImplementedError(f"{cfg.name}: block kind {kind!r} is not ported yet")
    window = cfg.local_window if kind == "attn_local" else None
    x, new_cache = gqa_block(p, x, cfg=cfg, positions=positions, mode=mode,
                             cache=cache, pos=pos, window=window)
    mlp_p = {k[4:]: p[k] for k in ("mlp_wg", "mlp_wu", "mlp_wo") if k in p}
    x = x + mlp_apply(mlp_p, rms_norm(x, p["ln2"]), cfg.mlp_kind)
    return x, new_cache


def _run_stack(params, cfg, x, positions, mode, cache):
    pos = None if cache is None else cache["pos"]
    blocks = params["blocks"]
    for i, kind in enumerate(cfg.layer_kinds()):
        lp = {k: w[i] for k, w in blocks.items()}
        lc = None if cache is None else {k: c[i] for k, c in cache["layers"].items()}
        x, _ = _block_apply(kind, lp, x, cfg=cfg, positions=positions, mode=mode,
                            cache=lc, pos=pos)
    return x


def _embed_tokens(params, cfg, tokens):
    return params["embed"][tokens]


def _head_weight(params, cfg):
    if cfg.tie_embeddings:
        return params["embed"].T
    return params["lm_head"]


def _head_logits(x, head_w):
    """Logits in f32, as the JAX version's preferred_element_type=f32."""
    return torch.matmul(x.float(), head_w.float())


def forward(params, cfg: ArchConfig, *, tokens=None, embeds=None, mode="train",
            cache=None):
    """Returns (final_hidden, new_cache)."""
    x = embeds if embeds is not None else _embed_tokens(params, cfg, tokens)
    B, S = x.shape[0], x.shape[1]
    if mode == "decode":
        positions = torch.full((B, 1), cache["pos"], dtype=torch.long, device=x.device)
    else:
        positions = torch.arange(S, device=x.device)[None, :].expand(B, S)
    x = _run_stack(params, cfg, x, positions, mode, cache)
    x = rms_norm(x, params["final_norm"])
    new_cache = None
    if mode in ("prefill", "decode"):
        base = S if mode == "prefill" else 1
        new_cache = {"pos": cache["pos"] + base, "layers": cache["layers"]}
    return x, new_cache


def prefill(params, cfg: ArchConfig, cache, *, tokens=None, embeds=None):
    """Fill the cache from a prompt; returns (last_logits (B, V) f32, cache)."""
    x, new_cache = forward(params, cfg, tokens=tokens, embeds=embeds,
                           mode="prefill", cache=cache)
    return _head_logits(x[:, -1], _head_weight(params, cfg)), new_cache


def decode_step(params, cfg: ArchConfig, cache, tokens):
    """One decode step.  tokens: (B, 1) int.  Returns (logits (B, V) f32, cache)."""
    x, new_cache = forward(params, cfg, tokens=tokens, mode="decode", cache=cache)
    return _head_logits(x[:, 0], _head_weight(params, cfg)), new_cache

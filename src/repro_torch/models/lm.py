"""LM assembly (``repro.models.lm`` twin) for the dense decoder with GQA or MLA
attention (with an MLP or a MoE branch), RWKV6, the RG-LRU hybrid and the
encoder-only model.

Modes:
  train   — full-sequence forward + chunked CE loss (no cache)
  prefill — full-sequence forward that fills the decode cache; an
            encoder-only model has no cache, and its prefill is a train-mode
            forward that returns the frame logits
  decode  — one token against the cache

The layers are walked by a Python loop: the stacked ``blocks`` (leading
layer dim) of a uniform model, unbound once into per-layer views, or the
list of per-layer blocks of a hybrid, whose cache is a list of per-layer
caches too.  The cache's tensors are written in place; its ``pos`` is a
Python int.  In train mode the layers are checkpointed as the JAX package's
``jax.checkpoint`` does (``_maybe_remat``, ``_run_stack``).
"""
from __future__ import annotations

import functools

import torch
from torch.utils.checkpoint import (CheckpointPolicy, checkpoint,
                                    create_selective_checkpoint_contexts)

from repro_torch import resolve_device, sharding
from repro_torch.sharding import constant, constrain, is_sharded, spec_for
from repro_torch.types import ArchConfig

from .attention import gqa_block, mla_block
from .layers import chunked_ce_loss, mlp_apply, rms_norm
from .moe import moe_block
from .rglru import rglru_block
from .rwkv6 import rwkv_block
from .schema import Param, leaf_dtype, map_schema
from .schema import (abstract_params, init_params, model_schema,  # noqa: F401  (re-exported)
                     param_specs)


# Matrix products with no batch dims: what jax's
# dots_with_no_batch_dims_saveable lets a checkpoint keep.  A product of
# (..., d) activations by a (d, ...) weight reaches aten as mm (or addmm);
# products with batch dims (attention's per-head scores) reach it as bmm.
_SAVEABLE_DOTS = (torch.ops.aten.mm.default, torch.ops.aten.addmm.default)


def _save_dots(ctx, op, *args, **kwargs):
    return (CheckpointPolicy.MUST_SAVE if op in _SAVEABLE_DOTS
            else CheckpointPolicy.PREFER_RECOMPUTE)


def _maybe_remat(fn, remat):
    """remat: 'none' | 'full' (save nothing) | 'dots' (save the outputs of the
    matrix products with no batch dims, recompute the rest).  Checkpoints are
    non-reentrant; the models draw no random numbers, so no RNG state is
    kept."""
    if remat == "none":
        return fn
    if remat == "full":
        return functools.partial(checkpoint, fn, use_reentrant=False,
                                 preserve_rng_state=False)
    if remat == "dots":
        return functools.partial(
            checkpoint, fn, use_reentrant=False, preserve_rng_state=False,
            context_fn=functools.partial(create_selective_checkpoint_contexts, _save_dots))
    raise ValueError(remat)


def _layer_cache(cfg: ArchConfig, kind: str, batch: int, max_len: int):
    """One layer's cache as Params: the GQA KV cache {"k", "v"} of (B, S, KH,
    hd), an ``attn_local`` layer holding min(local_window, max_len) slots; the
    MLA cache {"ckv", "krope"}, the normed latent (B, S, kv_lora_rank) and the
    rotated shared key (B, S, qk_rope_dim); the RWKV6 state {"s", "x_tm",
    "x_cm"} or the RG-LRU state {"h", "conv"}, f32."""
    if kind == "rwkv":
        hd = cfg.rwkv_head_dim
        emb = Param((batch, cfg.d_model), ("batch", "embed"), "zeros", dtype="float32")
        return {"s": Param((batch, cfg.d_model // hd, hd, hd),
                           ("batch", "heads", "head_dim", None), "zeros", dtype="float32"),
                "x_tm": emb, "x_cm": emb}
    if kind == "rglru":
        W = cfg.lru_width or cfg.d_model
        return {"h": Param((batch, W), ("batch", "lru_blocks"), "zeros", dtype="float32"),
                "conv": Param((batch, 3, W), ("batch", None, "lru_blocks"), "zeros",
                              dtype="float32")}
    if kind not in ("attn", "attn_local") or cfg.attn_kind not in ("gqa", "mla"):
        raise NotImplementedError(f"{cfg.name}: block kind {kind!r} with attn_kind "
                                  f"{cfg.attn_kind!r} has no ported cache yet")
    S = min(cfg.local_window, max_len) if kind == "attn_local" else max_len
    if cfg.attn_kind == "mla":
        m = cfg.mla
        return {"ckv": Param((batch, S, m.kv_lora_rank), ("batch", "kv_seq", "lora"), "zeros"),
                "krope": Param((batch, S, m.qk_rope_dim), ("batch", "kv_seq", "qk_dim"),
                               "zeros")}
    kv = Param((batch, S, cfg.n_kv_heads, cfg.head_dim),
               ("batch", "kv_seq", "kv_heads", "head_dim"), "zeros")
    return {"k": kv, "v": kv}


def cache_schema(cfg: ArchConfig, batch: int, max_len: int):
    """The per-layer caches as Params: stacked with a leading layer dim when
    every layer has the same kind, else a list with one dict a layer."""
    kinds = cfg.layer_kinds()
    if not cfg.uniform_blocks:
        return [_layer_cache(cfg, k, batch, max_len) for k in kinds]
    return {name: Param((cfg.n_layers,) + p.shape, ("layers",) + p.axes, p.init,
                        p.scale, p.dtype)
            for name, p in _layer_cache(cfg, kinds[0], batch, max_len).items()}


def init_cache(cfg: ArchConfig, batch: int, max_len: int, dtype=torch.bfloat16,
               device="cuda"):
    """A zero cache; ``dtype`` applies to the leaves the schema does not fix.
    An encoder-only model decodes nothing and gets None."""
    dev = resolve_device(device)
    if not cfg.has_decoder:
        return None
    layers = map_schema(cache_schema(cfg, batch, max_len),
                    lambda p: torch.zeros(p.shape, dtype=leaf_dtype(p, dtype), device=dev))
    return {"pos": 0, "layers": layers}


def abstract_cache(cfg: ArchConfig, batch: int, max_len: int, dtype=torch.bfloat16):
    """The cache's layers as tensors on the ``meta`` device: shapes, no data."""
    return map_schema(cache_schema(cfg, batch, max_len),
                      lambda p: torch.empty(p.shape, dtype=leaf_dtype(p, dtype), device="meta"))


def cache_specs(cfg: ArchConfig, batch: int, max_len: int, rules):
    """The cache's specs under ``rules``: {"pos": (), "layers": ...}, the
    reference's tree (its ``pos`` is a scalar, here a Python int)."""
    return {"pos": (), "layers": map_schema(cache_schema(cfg, batch, max_len),
                                            lambda p: spec_for(p.axes, rules))}


def _store(cache, new_cache):
    """Write a recurrent layer's new state into its cache slice, in place."""
    if new_cache is not None:
        for name, t in new_cache.items():
            cache[name].copy_(t)


def _block_apply(kind, p, x, *, cfg, positions, mode, cache, pos):
    if kind == "rwkv":
        x, new_cache = rwkv_block(p, x, cfg=cfg, mode=mode, cache=cache)
        _store(cache, new_cache)
        return x, new_cache
    if kind == "rglru":
        x, new_cache = rglru_block(p, x, cfg=cfg, mode=mode, cache=cache)
        _store(cache, new_cache)
    elif kind in ("attn", "attn_local") and cfg.attn_kind in ("gqa", "mla"):
        window = cfg.local_window if kind == "attn_local" else None
        fn = mla_block if cfg.attn_kind == "mla" else gqa_block
        x, new_cache = fn(p, x, cfg=cfg, positions=positions, mode=mode, cache=cache, pos=pos,
                          window=window)
    else:
        raise NotImplementedError(f"{cfg.name}: block kind {kind!r} is not ported yet")
    if cfg.moe is not None:
        x = moe_block(p, x, cfg=cfg)  # the residual sum included
    else:
        mlp_p = {k[4:]: p[k] for k in ("mlp_wg", "mlp_wu", "mlp_wo") if k in p}
        x = x + mlp_apply(mlp_p, rms_norm(x, p["ln2"]), cfg.mlp_kind)
    return constrain(x, "batch", "seq", "embed"), new_cache


def _per_layer(blocks):
    """The stacked blocks as one dict of views a layer.  ``unbind`` makes one
    autograd node whose backward stacks the layers' gradients, where indexing
    each layer would add a zero-filled full-size gradient a layer."""
    names = list(blocks)
    return [dict(zip(names, ws)) for ws in zip(*(torch.unbind(blocks[n]) for n in names))]


def _run_stack(params, cfg, x, positions, mode, cache, remat="full", remat_group=8):
    pos = None if cache is None else cache["pos"]
    kinds = cfg.layer_kinds()
    blocks = params["blocks"]
    layers = None if cache is None else cache["layers"]
    per_layer = blocks if isinstance(blocks, list) else _per_layer(blocks)

    def body(h, lp, kind=kinds[0]):
        return _block_apply(kind, lp, h, cfg=cfg, positions=positions, mode=mode,
                            cache=None, pos=pos)[0]

    if mode == "train" and cfg.uniform_blocks and remat != "none":
        # Checkpoint groups of k layers, and each layer inside a group: the
        # saved residual stream is L/k layer inputs, and a group's backward
        # recompute keeps only its layers' inputs live.  k is the first of
        # (remat_group, 4, 2, 1) that divides L, as in the JAX package.
        L = cfg.n_layers
        k = next(g for g in (remat_group, 4, 2, 1) if L % g == 0)
        layer = _maybe_remat(body, remat)

        def group(h, *lps):
            for lp in lps:
                h = layer(h, lp)
            return h

        for g0 in range(0, L, k):
            x = _maybe_remat(group, remat)(x, *per_layer[g0:g0 + k])
        return x
    for i, kind in enumerate(kinds):
        if isinstance(blocks, list):  # a hybrid: per-layer blocks and caches
            lc = None if layers is None else layers[i]
        else:
            lc = None if layers is None else {k: c[i] for k, c in layers.items()}
        if mode == "train":  # a hybrid, or remat "none": each layer on its own
            x = _maybe_remat(functools.partial(body, kind=kind), remat)(x, per_layer[i])
        else:
            x, _ = _block_apply(kind, per_layer[i], x, cfg=cfg, positions=positions,
                                mode=mode, cache=lc, pos=pos)
    return x


def _embed_tokens(params, cfg, tokens):
    if not is_sharded(params["embed"]):
        return params["embed"][tokens]
    # under a mesh each rank looks its tokens up in its rows of the table
    # (sharded over the vocab), zeros for the rest: a partial sum over the
    # vocab's mesh axes, which the caller's constrain completes
    v0 = sharding.local_offset(params["embed"], 0)

    def lookup(tokens, embed):
        row = tokens - v0
        here = (row >= 0) & (row < embed.shape[0])
        return torch.where(here[..., None], embed[torch.where(here, row, 0)], 0)
    return sharding.local_call(lookup, (tokens, params["embed"]),
                               (("batch", "seq"), ("vocab", "embed")),
                               (("batch", "seq", "embed"),), grad_sum={1: ("batch",)},
                               out_sum={0: ("vocab",)})


def _head_weight(params, cfg):
    if not cfg.has_decoder:
        return params["cls_head"]
    if cfg.tie_embeddings:
        return params["embed"].T
    return params["lm_head"]


def _head_logits(x, head_w):
    """Logits in f32, as the JAX version's preferred_element_type=f32."""
    return torch.matmul(x.float(), head_w.float())


def forward(params, cfg: ArchConfig, *, tokens=None, embeds=None, mode="train",
            cache=None, remat="full", remat_group=8):
    """Returns (final_hidden, new_cache).  ``remat`` and ``remat_group`` apply
    in train mode only (``_run_stack``)."""
    x = embeds if embeds is not None else _embed_tokens(params, cfg, tokens)
    x = constrain(x, "batch", "seq", "embed")
    B, S = x.shape[0], x.shape[1]
    if mode == "decode":
        positions = torch.full((B, 1), cache["pos"], dtype=torch.long, device=x.device)
    else:
        positions = torch.arange(S, device=x.device)[None, :].expand(B, S)
    positions = constant(x, positions, "batch", "seq")
    x = _run_stack(params, cfg, x, positions, mode, cache, remat=remat,
                   remat_group=remat_group)
    x = rms_norm(x, params["final_norm"])
    new_cache = None
    if mode in ("prefill", "decode"):
        base = S if mode == "prefill" else 1
        new_cache = {"pos": cache["pos"] + base, "layers": cache["layers"]}
    return x, new_cache


def loss_fn(params, cfg: ArchConfig, batch, *, remat="full", ce_chunk=512, remat_group=8):
    """batch: {"tokens" | "embeds", "labels"}.  Returns (loss, {"tokens": count})."""
    x, _ = forward(params, cfg, tokens=batch.get("tokens"), embeds=batch.get("embeds"),
                   mode="train", remat=remat, remat_group=remat_group)
    loss, count = chunked_ce_loss(x, _head_weight(params, cfg), batch["labels"],
                                  chunk=ce_chunk)
    return loss, {"tokens": count}


def prefill(params, cfg: ArchConfig, cache, *, tokens=None, embeds=None):
    """Fill the cache from a prompt; returns (last_logits (B, V) f32, cache).

    An encoder-only model takes no cache (None): a train-mode forward with
    remat "none", and the frame logits (B, S, V) f32 and None."""
    if not cfg.has_decoder:
        x, _ = forward(params, cfg, tokens=tokens, embeds=embeds, mode="train", remat="none")
        return _head_logits(x, _head_weight(params, cfg)), None
    x, new_cache = forward(params, cfg, tokens=tokens, embeds=embeds,
                           mode="prefill", cache=cache)
    return _head_logits(x[:, -1], _head_weight(params, cfg)), new_cache


def decode_step(params, cfg: ArchConfig, cache, tokens):
    """One decode step.  tokens: (B, 1) int.  Returns (logits (B, V) f32, cache)."""
    x, new_cache = forward(params, cfg, tokens=tokens, mode="decode", cache=cache)
    return _head_logits(x[:, 0], _head_weight(params, cfg)), new_cache

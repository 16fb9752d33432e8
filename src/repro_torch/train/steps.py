"""The train step and its model-FLOP count (``repro.train.steps`` twin).

The JAX package's abstract input and sharding specs (``input_specs``,
``batch_specs``) and ``ideal_bytes`` belong to the sharding slice and are not
copied yet.
"""
from __future__ import annotations

import torch

from repro_torch.models import lm
from repro_torch.optim import adamw_update, cosine_schedule
from repro_torch.tree import leaves, map_tree
from repro_torch.types import ArchConfig, ShapeConfig


def make_train_step(cfg: ArchConfig, *, lr=3e-4, warmup=100, total=10_000, remat="full",
                    ce_chunk=512, clip=1.0, weight_decay=0.1, remat_group=8, microbatch=1):
    """train_step(state, batch) -> (state, metrics), the state updated in place.

    batch: {"tokens" | "embeds", "labels"} tensors on the params' device.
    microbatch > 1: split the global batch into that many sequential
    micro-batches with f32 gradient accumulation — activation memory scales
    1/microbatch at (nearly) constant FLOPs.
    metrics: {"loss", "tokens", "grad_norm"}, tensors on the device.
    """
    schedule = cosine_schedule(lr, warmup, total)

    def loss_and_grads(params, batch):
        weights = leaves(params)
        for w in weights:
            w.requires_grad_(True)
        loss, aux = lm.loss_fn(params, cfg, batch, remat=remat, ce_chunk=ce_chunk,
                               remat_group=remat_group)
        grads = torch.autograd.grad(loss, weights)
        return loss.detach(), aux["tokens"], grads

    def train_step(state, batch):
        params = state["params"]
        if microbatch == 1:
            loss, tokens, grads = loss_and_grads(params, batch)
        else:
            size = next(iter(batch.values())).shape[0] // microbatch
            grads = [torch.zeros(w.shape, dtype=torch.float32, device=w.device)
                     for w in leaves(params)]
            loss = torch.zeros((), dtype=torch.float32, device=grads[0].device)
            tokens = 0
            for i in range(microbatch):
                mb = map_tree(lambda a: a[i * size:(i + 1) * size], batch)
                l, t, g = loss_and_grads(params, mb)
                for acc, gg in zip(grads, g):
                    acc.add_(gg.float())
                loss, tokens = loss + l, tokens + t
            grads = [g / microbatch for g in grads]
            loss = loss / microbatch
        state, opt_aux = adamw_update(state, grads, lr=schedule, clip=clip,
                                      weight_decay=weight_decay)
        return state, {"loss": loss, "tokens": tokens, **opt_aux}

    return train_step


def useful_flops(cfg: ArchConfig, shape: ShapeConfig) -> float:
    """MODEL_FLOPS for one step of this cell, whole cluster (all devices).

    6*N*T for train / 2*N*T for inference (N = active non-embedding params +
    head), plus the attention score/value matmuls (not captured by 6ND):
    fwd 4*B*H*hd*Sq*Skv_eff, x3 for train (bwd = 2x fwd).
    """
    # parameter-matmul term
    n = cfg.n_active_params()
    n -= cfg.padded_vocab * cfg.d_model  # embedding lookup is not a matmul
    B, S = shape.global_batch, shape.seq_len
    if shape.kind == "train":
        tokens, mult = B * S, 6.0
    elif shape.kind == "prefill":
        tokens, mult = B * S, 2.0
    else:
        tokens, mult = B * 1, 2.0
    total = mult * n * tokens

    # attention term
    attn_mult = 3.0 if shape.kind == "train" else 1.0
    for kind in cfg.layer_kinds():
        if kind not in ("attn", "attn_local"):
            continue
        if cfg.attn_kind == "mla":
            h = cfg.n_heads
            hd_qk = cfg.mla.qk_nope_dim + cfg.mla.qk_rope_dim
            hd_v = cfg.mla.v_head_dim
        else:
            h, hd_qk = cfg.n_heads, cfg.head_dim
            hd_v = cfg.head_dim
        window = cfg.local_window if kind == "attn_local" else None
        if shape.kind == "decode":
            sq, skv = 1, (min(S, window) if window else S)
        else:
            sq = S
            if window and window < S:
                skv = window  # each query sees ~window keys
            else:
                skv = (S + 1) / 2 if cfg.causal else S
        total += attn_mult * 2.0 * B * h * sq * skv * (hd_qk + hd_v)
    return total

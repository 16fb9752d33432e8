"""The train, prefill and decode steps, their abstract inputs and specs, the
model-FLOP count and the analytic bytes a step must move
(``repro.train.steps`` twin).
"""
from __future__ import annotations

import torch

from repro_torch.models import lm
from repro_torch.optim import adamw_update, cosine_schedule
from repro_torch.sharding import entry
from repro_torch.tree import leaves, map_tree
from repro_torch.types import ArchConfig, ShapeConfig


def make_train_step(cfg: ArchConfig, *, lr=3e-4, warmup=100, total=10_000, remat="full",
                    ce_chunk=512, clip=1.0, weight_decay=0.1, remat_group=8, microbatch=1):
    """train_step(state, batch) -> (state, metrics), the state updated in place.

    batch: {"tokens" | "embeds", "labels"} tensors on the params' device.
    microbatch > 1: split the global batch into that many sequential
    micro-batches with f32 gradient accumulation — activation memory scales
    1/microbatch at (nearly) constant FLOPs.  A batch whose size is not a
    multiple of microbatch raises, as the reference's reshape does.
    metrics: {"loss", "tokens", "grad_norm"}, tensors on the device.
    """
    schedule = cosine_schedule(lr, warmup, total)

    def loss_and_grads(params, batch):
        weights = leaves(params)
        for w in weights:
            w.requires_grad_(True)
        loss, aux = lm.loss_fn(params, cfg, batch, remat=remat, ce_chunk=ce_chunk,
                               remat_group=remat_group)
        # a leaf the loss never reads (``embed`` under a batch of "embeds")
        # gets a zero gradient, as jax.grad gives it: AdamW still decays its
        # master, and it counts in the global norm
        grads = torch.autograd.grad(loss, weights, allow_unused=True, materialize_grads=True)
        return loss.detach(), aux["tokens"], grads

    def train_step(state, batch):
        params = state["params"]
        if microbatch == 1:
            loss, tokens, grads = loss_and_grads(params, batch)
        else:
            B = next(iter(batch.values())).shape[0]
            if B % microbatch:
                raise ValueError(f"make_train_step: a batch of {B} rows does not split into "
                                 f"microbatch={microbatch} equal micro-batches")
            size = B // microbatch
            grads = [torch.zeros_like(w, dtype=torch.float32) for w in leaves(params)]
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


def make_prefill_step(cfg: ArchConfig):
    """prefill_step(params, cache, batch) -> (last logits (B, V) f32, cache).

    batch: {"tokens" | "embeds"}; the cache is written in place.  An
    encoder-only model takes cache None and returns its frame logits (B, S,
    V) f32 and None."""
    def prefill_step(params, cache, batch):
        return lm.prefill(params, cfg, cache, tokens=batch.get("tokens"),
                          embeds=batch.get("embeds"))
    return prefill_step


def make_decode_step(cfg: ArchConfig):
    """decode_step(params, cache, batch) -> (logits (B, V) f32, cache).

    batch: {"tokens": (B, 1)}; the cache is written in place."""
    def decode_step(params, cache, batch):
        return lm.decode_step(params, cfg, cache, batch["tokens"])
    return decode_step


# ---------------------------------------------------------------------------
# Abstract inputs
# ---------------------------------------------------------------------------

def input_specs(cfg: ArchConfig, shape: ShapeConfig, *, act_dtype=torch.bfloat16,
                device="meta"):
    """Stand-ins, on ``device`` (meta, or a fake tensor mode's), for the batch
    of one (arch, shape) cell."""
    B, S = shape.global_batch, shape.seq_len

    def tok(shape_, dtype):
        return torch.empty(shape_, dtype=dtype, device=device)
    if shape.kind == "train":
        if cfg.frontend:
            return {"embeds": tok((B, S, cfg.d_model), act_dtype),
                    "labels": tok((B, S), torch.int32)}
        return {"tokens": tok((B, S), torch.int32), "labels": tok((B, S), torch.int32)}
    if shape.kind == "prefill":
        if cfg.frontend:
            return {"embeds": tok((B, S, cfg.d_model), act_dtype)}
        return {"tokens": tok((B, S), torch.int32)}
    # decode: one new token against a seq_len-deep cache
    return {"tokens": tok((B, 1), torch.int32)}


def batch_specs(cfg: ArchConfig, shape: ShapeConfig, rules):
    """Specs matching input_specs."""
    dp = entry(rules.get("batch"))
    if shape.kind == "train":
        if cfg.frontend:
            return {"embeds": (dp, None, None), "labels": (dp, None)}
        return {"tokens": (dp, None), "labels": (dp, None)}
    if shape.kind == "prefill":
        if cfg.frontend:
            return {"embeds": (dp, None, None)}
        return {"tokens": (dp, None)}
    return {"tokens": (dp, None)}


def ideal_bytes(cfg: ArchConfig, shape: ShapeConfig, *, n_chips: int, tp: int) -> float:
    """Analytic lower bound on per-device HBM traffic for one step.

    params: read once per pass; train = 3 forwards (primal + 2-level remat)
    + 1 backward + optimizer read/write.  Activations: ~8 residual-stream
    values per layer per pass.  Decode: the KV cache/state read dominates.
    """
    B, S = shape.global_batch, shape.seq_len
    dp = max(n_chips // tp, 1)
    p_bytes = cfg.n_params() * 2 / tp            # bf16, model-sharded
    d = cfg.d_model
    L = cfg.n_layers

    if shape.kind == "train":
        passes = 4.0
        opt = cfg.n_params() * 12.0 / n_chips * 2.0   # ZeRO-1 f32 m/v/master
        act = 8.0 * L * (B / dp) * S * d * 2.0 * 4.0
        grads = p_bytes * 2.0
        return passes * p_bytes + opt + act + grads
    if shape.kind == "prefill":
        act = 8.0 * L * (B / dp) * S * d * 2.0
        return p_bytes + act
    # decode: params once + full cache/state read (+ tiny activations)
    cache = 0.0
    for kind in cfg.layer_kinds():
        if kind in ("attn", "attn_local"):
            Sc = min(cfg.local_window, S) if kind == "attn_local" else S
            if cfg.attn_kind == "mla":
                per_tok = cfg.mla.kv_lora_rank + cfg.mla.qk_rope_dim
            else:
                per_tok = 2 * cfg.n_kv_heads * cfg.head_dim
            cache += (B / dp) * (Sc / max(tp, 1)) * per_tok * 2.0  # seq sharded over model
        elif kind == "rglru":
            cache += (B / dp) * 2 * (cfg.lru_width or d) * 4.0
        elif kind == "rwkv":
            cache += (B / dp) * d * cfg.rwkv_head_dim * 4.0
    return p_bytes + cache


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

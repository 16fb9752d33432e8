"""Attention blocks, GQA and MLA, with train / prefill / decode modes
(``repro.models.attention`` twin: ``gqa_block``, ``mla_block``).

The port writes the caches in place: prefill and decode store into the
cache tensors they are given and return them, where the JAX version returns
new arrays.  That keeps one cache in device memory.
"""
from __future__ import annotations

import torch
from torch.distributed.tensor import Replicate

from repro_torch import sharding
from repro_torch.kernels.flash_attention import decode_attention, flash_attention
from repro_torch.sharding import constrain, is_sharded

from .layers import rms_norm, rope


def _write_cache(cache_kv, new, pos: int, ring: int | None):
    """Store new (B, S_new, ...) at position ``pos`` of the cache's dim 1
    (slot ``pos % ring`` when the cache is a ring of ``ring`` entries).  A
    sharded cache is written on each rank's own shard: new, replicated along
    the cache's sequence dim, lands on the rank that holds the slot."""
    slot = pos if ring is None else pos % ring
    if not is_sharded(cache_kv):
        cache_kv[:, slot:slot + new.shape[1]] = new
        return cache_kv
    want = [Replicate() if p.is_shard(1) else p for p in cache_kv.placements]
    local_new = new.redistribute(cache_kv.device_mesh, want).to_local()
    local, i = cache_kv.to_local(), slot - sharding.local_offset(cache_kv, 1)
    lo, hi = max(i, 0), min(i + new.shape[1], local.shape[1])
    if lo < hi:
        local[:, lo:hi] = local_new[:, lo - i:hi - i]
    return cache_kv


def _ring(t, shift: int):
    """``torch.roll(t, shift, dims=1)``, as two slices (DTensor has no rule
    for roll)."""
    return torch.cat([t[:, t.shape[1] - shift:], t[:, :t.shape[1] - shift]], dim=1)


def _fill_cache(cache_kv, new):
    """Prefill's store of new (B, S, ...) into the cache's first S positions,
    zeros past them; a sharded cache is filled whole (S its length)."""
    S = new.shape[1]
    if S == cache_kv.shape[1]:
        cache_kv.copy_(new)
    elif is_sharded(cache_kv):
        raise NotImplementedError("a sharded cache is filled whole: prefill to its length")
    else:
        cache_kv[:, :S] = new
        cache_kv[:, S:] = 0
    return cache_kv


def _attend(q, k, v, *, causal, window, kv_axis):
    """``flash_attention`` on q (B, S, H, Dk), k and v (B, S, KH, D); under a
    mesh on each rank's shards (``sharding.local_call``): its batch rows and
    query heads, and the kv heads those read.  Where the kv heads
    (``kv_axis``) are replicated and the query heads split, a rank passes
    the kernel the kv heads its own query heads read, head h reading h // (H
    / KH) as the kernel's GQA does, and its gradient for them is a partial
    sum over the heads' mesh axes."""
    if not is_sharded(q):
        return flash_attention(q, k, v, causal=causal, window=window)
    _, rules = sharding.current()
    H, KH = q.shape[2], k.shape[2]
    q_ax, kv_ax = ("batch", "seq", "heads", "head_dim"), ("batch", "seq", kv_axis, "head_dim")
    q = constrain(q, *q_ax)
    h0 = sharding.local_offset(q, 2)
    split = rules.get(kv_axis) is None and rules.get("heads") is not None

    def local(q, k, v):
        if split:
            group, Hl = H // KH, q.shape[2]
            ids = [(h0 + i) // group for i in range(Hl)]
            uniq = sorted(set(ids))
            g = Hl // len(uniq)
            if any(ids[i] != uniq[i // g] for i in range(Hl)):
                uniq = ids  # no whole groups here: one kv head a query head
            k, v = k[:, :, uniq], v[:, :, uniq]
        return flash_attention(q, k, v, causal=causal, window=window)

    grad_sum = {1: ("heads",), 2: ("heads",)} if split else {}
    return sharding.local_call(local, (q, k, v), (q_ax, kv_ax, kv_ax), (q_ax,), grad_sum)


def _decode(q, kc, vc, length):
    """``decode_attention`` of q over the cache.  Under a mesh the query's
    heads split as the kv heads are (replicated where those are), so that
    they group into (KH, H / KH) as decode_attention reads them; with the kv
    heads split each rank attends its own heads' whole cache, with the
    cache's sequence split the ranks' partial softmax sums meet in
    all-reduces (flash-decoding in SPMD, the logits constrained as the
    reference's)."""
    ax = ("batch", "seq", "kv_heads", "head_dim")
    q = constrain(q, *ax)
    if is_sharded(q) and sharding.current()[1].get("kv_heads") is not None:
        kv = ("batch", "kv_seq", "kv_heads", "head_dim")
        return sharding.local_call(lambda q, k, v: decode_attention(q, k, v, length),
                                   (q, kc, vc), (ax, kv, kv), (ax,))
    return decode_attention(q, kc, vc, length, logits_constraint=lambda s: constrain(
        s, "batch", None, "kv_heads", None, "kv_seq"))


def gqa_block(p, x, *, cfg, positions, mode, cache, pos=None, window=None):
    """Pre-norm GQA attention residual branch.

    x: (B, S, D); positions: (B, S) absolute positions; ``pos``: absolute
    position of the current token (decode only, a Python int).
    Returns (residual_out, cache), the cache written in place (None in train).
    """
    # Heads padded past n_heads (padded_heads) read zero weights and are
    # zeroed before wo.  With one kv head every query head reads it, so the
    # padded ones are left out of attention altogether: the real heads'
    # rows of wq and wo alone, the same numbers, and the padded rows'
    # gradients exactly 0, as the reference's.  With more kv heads, slicing
    # query heads would change the GQA mapping h -> h / (H / KH), so those
    # attend at the padded count and mask.
    wq, wo = p["wq"], p["wo"]
    masked = cfg.padded_heads != cfg.n_heads
    if masked and cfg.n_kv_heads == 1 and not is_sharded(x):  # sharded, heads split: masked
        wq, wo, masked = wq[:, :cfg.n_heads], wo[:cfg.n_heads], False
    y = rms_norm(x, p["ln1"])
    q = torch.einsum("bsd,dhk->bshk", y, wq)
    k = torch.einsum("bsd,dhk->bshk", y, p["wk"])
    v = torch.einsum("bsd,dhk->bshk", y, p["wv"])
    if cfg.qk_norm:
        q = rms_norm(q, p["q_norm"])
        k = rms_norm(k, p["k_norm"])
    q = rope(q, positions, cfg.rope_theta)
    k = rope(k, positions, cfg.rope_theta)
    q = constrain(q, "batch", "seq", "heads", "head_dim")
    k = constrain(k, "batch", "seq", "kv_heads", "head_dim")

    new_cache = None
    if mode == "decode":
        kc = _write_cache(cache["k"], k, pos, window)
        vc = _write_cache(cache["v"], v, pos, window)
        kc = constrain(kc, "batch", "kv_seq", "kv_heads", "head_dim")
        vc = constrain(vc, "batch", "kv_seq", "kv_heads", "head_dim")
        length = min(pos + 1, window) if window else pos + 1
        out = _decode(q, kc, vc, length)
        new_cache = {"k": kc, "v": vc}
    else:
        out = _attend(q, k, v, causal=cfg.causal, window=window, kv_axis="kv_heads")
        if mode == "prefill":
            S = x.shape[1]
            kc, vc = cache["k"], cache["v"]
            if window is not None and window < S:
                # keep the trailing window in ring order: slot = pos % window
                kc.copy_(_ring(k[:, S - window:], S % window))
                vc.copy_(_ring(v[:, S - window:], S % window))
            else:
                _fill_cache(kc, k)
                _fill_cache(vc, v)
            new_cache = {"k": kc, "v": vc}
    out = constrain(out, "batch", "seq", "heads", "head_dim")
    if masked:
        # zero the padded heads before the output projection
        hmask = (torch.arange(cfg.padded_heads, device=out.device) < cfg.n_heads).to(out.dtype)
        out = out * sharding.constant(out, hmask[None, None, :, None])
    o = torch.einsum("bshk,hkd->bsd", out, wo)
    return x + o, new_cache


def _mla_two_pass(q_abs, q_rope, ckv, krope, length: int, scale, constraint=None):
    """Absorbed-MLA decode attention: logits from the compressed cache.

    q_abs: (B, 1, H, R); q_rope: (B, 1, H, P); ckv: (B, S, R); krope: (B,
    S, P).  The values are the compressed ckv themselves: returns (B, 1, H,
    R) in f32.  The products are taken in f32, as the JAX version's
    preferred_element_type; cache entries at and beyond ``length`` take no
    part (the JAX version masks them, here they are sliced away; a sharded
    cache is masked, as slicing would gather it).  ``constraint`` pins the
    logits' sharding.
    """
    sharded = is_sharded(ckv)
    if not sharded:
        ckv, krope = ckv[:, :length], krope[:, :length]
    ckv, krope = ckv.float(), krope.float()
    s = (torch.einsum("bqhr,bsr->bqhs", q_abs.float(), ckv)
         + torch.einsum("bqhp,bsp->bqhs", q_rope.float(), krope)) * scale
    if constraint is not None:
        s = constraint(s)
    if sharded:
        valid = sharding.constant(s, torch.arange(s.shape[-1], device=s.device) < length)
        s = torch.where(valid, s, -1e30)
    p = torch.exp(s - torch.amax(s, dim=-1, keepdim=True))
    num = torch.einsum("bqhs,bsr->bqhr", p, ckv)
    return num / torch.clamp_min(torch.sum(p, dim=-1, keepdim=True), 1e-30)


def mla_block(p, x, *, cfg, positions, mode, cache, pos=None, window=None):
    """Multi-head Latent Attention (DeepSeek-V2, MiniCPM3) residual branch.

    Train and prefill expand the latent to per-head keys [k_nope, k_rope]
    (the rotary part shared by every head) and values, and attend through
    ``flash_attention`` at (Dk, Dv) = (nope + rope, v); decode attends over
    the compressed cache with the query absorbed into wkv_b
    (``_mla_two_pass``, plain PyTorch, as the JAX package computes it outside
    any kernel).  Prefill writes the normed latent and the rotated shared key
    into the cache {"ckv", "krope"}, decode one position of each.  The heads
    padded past n_heads are attended and zeroed before wo, as in the
    reference, so their gradients are exactly 0.  Returns (residual_out,
    cache), the cache written in place (None in train).
    """
    m = cfg.mla
    y = rms_norm(x, p["ln1"])
    cq = rms_norm(torch.einsum("bsd,dr->bsr", y, p["wq_a"]), p["q_a_norm"])
    q = torch.einsum("bsr,rhk->bshk", cq, p["wq_b"])  # (B, S, H, nope + rope)
    q_nope, q_rope = torch.split(q, [m.qk_nope_dim, m.qk_rope_dim], dim=-1)
    q_rope = rope(q_rope, positions, cfg.rope_theta)

    ckv_full = torch.einsum("bsd,dr->bsr", y, p["wkv_a"])
    ckv, krope = torch.split(ckv_full, [m.kv_lora_rank, m.qk_rope_dim], dim=-1)
    ckv = rms_norm(ckv, p["kv_a_norm"])
    krope = rope(krope[:, :, None, :], positions, cfg.rope_theta)[:, :, 0, :]

    wkv_b_k = p["wkv_b"][:, :, :m.qk_nope_dim]     # (R, H, nope)
    wkv_b_v = p["wkv_b"][:, :, m.qk_nope_dim:]     # (R, H, v)
    scale = 1.0 / ((m.qk_nope_dim + m.qk_rope_dim) ** 0.5)

    new_cache = None
    if mode == "decode":
        ckv_c = _write_cache(cache["ckv"], ckv, pos, None)
        kr_c = _write_cache(cache["krope"], krope, pos, None)
        ckv_c = constrain(ckv_c, "batch", "kv_seq", "lora")
        kr_c = constrain(kr_c, "batch", "kv_seq", "qk_dim")
        q_abs = torch.einsum("bshn,rhn->bshr", q_nope, wkv_b_k)
        ctx = _mla_two_pass(q_abs, q_rope, ckv_c, kr_c, pos + 1, scale, constraint=lambda s: (
            constrain(s, "batch", None, "heads", "kv_seq")))
        out = torch.einsum("bshr,rhv->bshv", ctx.to(x.dtype), wkv_b_v)
        new_cache = {"ckv": ckv_c, "krope": kr_c}
    else:
        k_nope = torch.einsum("bsr,rhn->bshn", ckv, wkv_b_k)
        v = torch.einsum("bsr,rhv->bshv", ckv, wkv_b_v)
        k = torch.cat([k_nope, krope[:, :, None, :].expand(-1, -1, k_nope.shape[2], -1)],
                      dim=-1)
        out = _attend(torch.cat([q_nope, q_rope], dim=-1), k, v, causal=cfg.causal,
                      window=window, kv_axis="heads")
        if mode == "prefill":
            new_cache = {"ckv": _fill_cache(cache["ckv"], ckv),
                         "krope": _fill_cache(cache["krope"], krope)}
    if cfg.padded_heads != cfg.n_heads:
        hmask = (torch.arange(cfg.padded_heads, device=out.device) < cfg.n_heads).to(out.dtype)
        out = out * sharding.constant(out, hmask[None, None, :, None])
    o = torch.einsum("bshv,hvd->bsd", out, p["wo"])
    return x + o, new_cache

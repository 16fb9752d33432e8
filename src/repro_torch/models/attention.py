"""GQA attention block with train / prefill / decode modes
(``repro.models.attention.gqa_block`` twin).

The port writes the KV cache in place: prefill and decode store into the
cache tensors they are given and return them, where the JAX version returns
new arrays.  That keeps one cache in device memory.
"""
from __future__ import annotations

import torch

from repro_torch.kernels.flash_attention import decode_attention, flash_attention

from .layers import rms_norm, rope


def _write_cache(cache_kv, new, pos: int, ring: int | None):
    """Store new (B, S_new, KH, D) at position ``pos`` (slot ``pos % ring``
    when the cache is a ring of ``ring`` entries)."""
    slot = pos if ring is None else pos % ring
    cache_kv[:, slot:slot + new.shape[1]] = new
    return cache_kv


def gqa_block(p, x, *, cfg, positions, mode, cache, pos=None, window=None):
    """Pre-norm GQA attention residual branch.

    x: (B, S, D); positions: (B, S) absolute positions; ``pos``: absolute
    position of the current token (decode only, a Python int).
    Returns (residual_out, cache), the cache written in place (None in train).
    """
    y = rms_norm(x, p["ln1"])
    q = torch.einsum("bsd,dhk->bshk", y, p["wq"])
    k = torch.einsum("bsd,dhk->bshk", y, p["wk"])
    v = torch.einsum("bsd,dhk->bshk", y, p["wv"])
    if cfg.qk_norm:
        q = rms_norm(q, p["q_norm"])
        k = rms_norm(k, p["k_norm"])
    q = rope(q, positions, cfg.rope_theta)
    k = rope(k, positions, cfg.rope_theta)

    new_cache = None
    if mode == "decode":
        kc = _write_cache(cache["k"], k, pos, window)
        vc = _write_cache(cache["v"], v, pos, window)
        length = min(pos + 1, window) if window else pos + 1
        out = decode_attention(q, kc, vc, length)
        new_cache = {"k": kc, "v": vc}
    else:
        out = flash_attention(q, k, v, causal=cfg.causal, window=window)
        if mode == "prefill":
            S = x.shape[1]
            kc, vc = cache["k"], cache["v"]
            if window is not None and window < S:
                # keep the trailing window in ring order: slot = pos % window
                shift = S % window
                kc.copy_(torch.roll(k[:, S - window:], shift, dims=1))
                vc.copy_(torch.roll(v[:, S - window:], shift, dims=1))
            else:
                kc[:, :S] = k
                kc[:, S:] = 0
                vc[:, :S] = v
                vc[:, S:] = 0
            new_cache = {"k": kc, "v": vc}
    if cfg.padded_heads != cfg.n_heads:
        # zero the padded heads before the output projection
        hmask = (torch.arange(cfg.padded_heads, device=out.device) < cfg.n_heads).to(out.dtype)
        out = out * hmask[None, None, :, None]
    o = torch.einsum("bshk,hkd->bsd", out, p["wo"])
    return x + o, new_cache

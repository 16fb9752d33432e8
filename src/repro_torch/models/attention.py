"""Attention blocks, GQA and MLA, with train / prefill / decode modes
(``repro.models.attention`` twin: ``gqa_block``, ``mla_block``).

The port writes the caches in place: prefill and decode store into the
cache tensors they are given and return them, where the JAX version returns
new arrays.  That keeps one cache in device memory.
"""
from __future__ import annotations

import torch

from repro_torch.kernels.flash_attention import decode_attention, flash_attention

from .layers import rms_norm, rope


def _write_cache(cache_kv, new, pos: int, ring: int | None):
    """Store new (B, S_new, ...) at position ``pos`` of the cache's dim 1
    (slot ``pos % ring`` when the cache is a ring of ``ring`` entries)."""
    slot = pos if ring is None else pos % ring
    cache_kv[:, slot:slot + new.shape[1]] = new
    return cache_kv


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
    if masked and cfg.n_kv_heads == 1:
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
    if masked:
        # zero the padded heads before the output projection
        hmask = (torch.arange(cfg.padded_heads, device=out.device) < cfg.n_heads).to(out.dtype)
        out = out * hmask[None, None, :, None]
    o = torch.einsum("bshk,hkd->bsd", out, wo)
    return x + o, new_cache


def _mla_two_pass(q_abs, q_rope, ckv, krope, length: int, scale):
    """Absorbed-MLA decode attention: logits from the compressed cache.

    q_abs: (B, 1, H, R); q_rope: (B, 1, H, P); ckv: (B, S, R); krope: (B,
    S, P).  The values are the compressed ckv themselves: returns (B, 1, H,
    R) in f32.  The products are taken in f32, as the JAX version's
    preferred_element_type; cache entries at and beyond ``length`` take no
    part (the JAX version masks them, here they are sliced away).
    """
    ckv, krope = ckv[:, :length].float(), krope[:, :length].float()
    s = (torch.einsum("bqhr,bsr->bqhs", q_abs.float(), ckv)
         + torch.einsum("bqhp,bsp->bqhs", q_rope.float(), krope)) * scale
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
        q_abs = torch.einsum("bshn,rhn->bshr", q_nope, wkv_b_k)
        ctx = _mla_two_pass(q_abs, q_rope, ckv_c, kr_c, pos + 1, scale)
        out = torch.einsum("bshr,rhv->bshv", ctx.to(x.dtype), wkv_b_v)
        new_cache = {"ckv": ckv_c, "krope": kr_c}
    else:
        k_nope = torch.einsum("bsr,rhn->bshn", ckv, wkv_b_k)
        v = torch.einsum("bsr,rhv->bshv", ckv, wkv_b_v)
        k = torch.cat([k_nope, krope[:, :, None, :].expand(-1, -1, k_nope.shape[2], -1)],
                      dim=-1)
        out = flash_attention(torch.cat([q_nope, q_rope], dim=-1), k, v, causal=cfg.causal,
                              window=window)
        if mode == "prefill":
            S = x.shape[1]
            ckv_c, kr_c = cache["ckv"], cache["krope"]
            ckv_c[:, :S] = ckv
            ckv_c[:, S:] = 0
            kr_c[:, :S] = krope
            kr_c[:, S:] = 0
            new_cache = {"ckv": ckv_c, "krope": kr_c}
    if cfg.padded_heads != cfg.n_heads:
        hmask = (torch.arange(cfg.padded_heads, device=out.device) < cfg.n_heads).to(out.dtype)
        out = out * hmask[None, None, :, None]
    o = torch.einsum("bshv,hvd->bsd", out, p["wo"])
    return x + o, new_cache

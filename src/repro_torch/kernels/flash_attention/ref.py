"""Naive attention oracle (``repro.kernels.flash_attention.ref`` twin), and the
plain version of the backward kernel.

Both compute in f32, or in f64 for f64 inputs (which the tests' gradcheck
uses).  Used only by the tests and by ``chip_smoke.py``; no model path calls
them.
"""
from __future__ import annotations

import torch


def attention_reference(q, k, v, *, causal=True, window=None, q_offset=0,
                        kv_len=None):
    """Naive attention with the full score matrix, softmax in f32.

    q: (B, Sq, H, Dk); k: (B, Sk, KH, Dk); v: (B, Sk, KH, Dv), H % KH == 0.
    ``q_offset``: absolute position of q[0]; ``window``: key j is visible to
    query i iff i - window < j <= i; ``kv_len``: number of valid keys.
    Returns (B, Sq, H, Dv) in q.dtype.
    """
    B, Sq, H, D = q.shape
    Sk, KH, Dv = k.shape[1], k.shape[2], v.shape[3]
    G = H // KH
    acc = torch.promote_types(q.dtype, torch.float32)
    scale = 1.0 / (D ** 0.5)
    qf = q.to(acc).reshape(B, Sq, KH, G, D)
    s = torch.einsum("bqhgd,bkhd->bqhgk", qf, k.to(acc)) * scale
    mask = _mask(Sq, Sk, causal, window, q_offset, kv_len, q.device)
    s = torch.where(mask[None, :, None, None, :], s, -torch.inf)
    p = torch.exp(s - torch.amax(s, dim=-1, keepdim=True))
    p = torch.where(torch.isfinite(s), p, 0.0)
    denom = torch.clamp_min(torch.sum(p, dim=-1, keepdim=True), 1e-30)
    o = torch.einsum("bqhgk,bkhd->bqhgd", p / denom, v.to(acc))
    return o.reshape(B, Sq, H, Dv).to(q.dtype)


def _mask(Sq, Sk, causal, window, q_offset, kv_len, device):
    """(Sq, Sk) bool: key j is visible to query i."""
    qi = q_offset + torch.arange(Sq, device=device)[:, None]
    kj = torch.arange(Sk, device=device)[None, :]
    mask = torch.ones((Sq, Sk), dtype=torch.bool, device=device)
    if causal:
        mask &= kj <= qi
    if window is not None:
        mask &= kj > qi - window
    if kv_len is not None:
        mask &= kj < kv_len
    return mask


def flash_attention_bwd_reference(q, k, v, o, dout, *, causal=True, window=None,
                                  q_offset=0, kv_len=None):
    """The plain version of ``kernel.flash_attention_bwd``, with its arithmetic.

    q: (B, Sq, H, Dk); k: (B, Sk, KH, Dk); v: (B, Sk, KH, Dv); o: the
    forward's output and dout its gradient, (B, Sq, H, Dv).  Recomputes each
    row's log-sum-exp lse over the visible keys, then P = exp(S - lse),
    delta = rowsum(dout * o), dS = P * (dP - delta) with dP = dout V^T, and
    dq = scale dS K, dk = scale dS^T Q, dv = P^T dout, dk and dv summed over
    each kv head's query heads.  A row that sees no key has P = 0: dq = 0,
    and it adds nothing to dk and dv.  Returns (dq, dk, dv) in q.dtype.
    """
    B, Sq, H, D = q.shape
    Sk, KH, Dv = k.shape[1], k.shape[2], v.shape[3]
    G = H // KH
    acc = torch.promote_types(q.dtype, torch.float32)
    scale = 1.0 / (D ** 0.5)
    qf = q.to(acc).reshape(B, Sq, KH, G, D)
    kf, vf = k.to(acc), v.to(acc)
    dof = dout.to(acc).reshape(B, Sq, KH, G, Dv)
    mask = _mask(Sq, Sk, causal, window, q_offset, kv_len, q.device)[None, :, None, None, :]
    s = torch.where(mask, torch.einsum("bqhgd,bkhd->bqhgk", qf, kf) * scale, -torch.inf)
    lse = torch.logsumexp(s, dim=-1, keepdim=True)
    p = torch.where(mask, torch.exp(s - torch.where(torch.isfinite(lse), lse, 0.0)), 0.0)
    delta = torch.sum(dof * o.to(acc).reshape(B, Sq, KH, G, Dv), dim=-1, keepdim=True)
    dp = torch.einsum("bqhgd,bkhd->bqhgk", dof, vf)
    ds = p * (dp - delta)
    dq = torch.einsum("bqhgk,bkhd->bqhgd", ds, kf) * scale
    dk = torch.einsum("bqhgk,bqhgd->bkhd", ds, qf) * scale
    dv = torch.einsum("bqhgk,bqhgd->bkhd", p, dof)
    return (dq.reshape(B, Sq, H, D).to(q.dtype), dk.to(q.dtype), dv.to(q.dtype))

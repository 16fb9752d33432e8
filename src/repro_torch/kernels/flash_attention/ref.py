"""Naive attention oracle (``repro.kernels.flash_attention.ref`` twin).

Used only as the ground truth in tests, at small shapes.
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
    scale = 1.0 / (D ** 0.5)
    qf = q.float().reshape(B, Sq, KH, G, D)
    s = torch.einsum("bqhgd,bkhd->bqhgk", qf, k.float()) * scale

    qi = q_offset + torch.arange(Sq, device=q.device)[:, None]
    kj = torch.arange(Sk, device=q.device)[None, :]
    mask = torch.ones((Sq, Sk), dtype=torch.bool, device=q.device)
    if causal:
        mask &= kj <= qi
    if window is not None:
        mask &= kj > qi - window
    if kv_len is not None:
        mask &= kj < kv_len
    s = torch.where(mask[None, :, None, None, :], s, -torch.inf)
    p = torch.exp(s - torch.amax(s, dim=-1, keepdim=True))
    p = torch.where(torch.isfinite(s), p, 0.0)
    denom = torch.clamp_min(torch.sum(p, dim=-1, keepdim=True), 1e-30)
    o = torch.einsum("bqhgk,bkhd->bqhgd", p / denom, v.float())
    return o.reshape(B, Sq, H, Dv).to(q.dtype)

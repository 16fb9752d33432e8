"""Attention entry points (``repro.kernels.flash_attention.ops`` twin).

* ``flash_attention`` — the entry point the models call.  A CUDA tensor goes
  through ``FlashAttention`` (``flash_attention_cuda``): forward by the
  hand-written kernel (``kernel.flash_attention_fwd``, which also writes
  each row's lse when the call makes a gradient), gradient by the backward kernel
  (``kernel.flash_attention_bwd``, which reads it).  A CPU tensor
  goes to ``chunked_attention``, which torch differentiates.  There is no
  other switch.
* ``chunked_attention`` — the kernel's plain PyTorch version: the same online
  softmax over (q chunk × kv chunk) tiles, in f32.
* ``decode_attention`` — single-token softmax over a KV cache, in plain
  PyTorch, as the JAX package computes it outside any kernel.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from .kernel import flash_attention_bwd, flash_attention_fwd

NEG_INF = -1e30


def _pad_to(x, dim, mult):
    pad = (-x.shape[dim]) % mult
    if pad == 0:
        return x
    widths = [0, 0] * (x.ndim - dim - 1) + [0, pad]
    return F.pad(x, widths)


def chunked_attention(q, k, v, *, causal=True, window=None, q_offset=0,
                      kv_len=None, q_chunk=512, k_chunk=512):
    """Online-softmax attention over (q chunks × kv chunks), in f32.

    q: (B, Sq, H, Dk); k: (B, Sk, KH, Dk); v: (B, Sk, KH, Dv).
    Returns (B, Sq, H, Dv) in q.dtype; a row that sees no key is 0.
    """
    B, Sq, H, D = q.shape
    Sk, KH, Dv = k.shape[1], k.shape[2], v.shape[3]
    group = H // KH
    kv_len = Sk if kv_len is None else kv_len
    q_chunk = min(q_chunk, Sq)
    k_chunk = min(k_chunk, Sk)
    scale = 1.0 / (D ** 0.5)

    # GQA: expand kv to H heads, as the JAX plain path does.
    qf = _pad_to(q.float(), 1, q_chunk)
    kf = _pad_to(k.float().repeat_interleave(group, dim=2), 1, k_chunk)
    vf = _pad_to(v.float().repeat_interleave(group, dim=2), 1, k_chunk)
    nq, nk = qf.shape[1] // q_chunk, kf.shape[1] // k_chunk

    outs = []
    for iq in range(nq):
        qb = qf[:, iq * q_chunk:(iq + 1) * q_chunk]
        qpos = q_offset + iq * q_chunk + torch.arange(q_chunk, device=q.device)
        m = torch.full((B, q_chunk, H), NEG_INF, dtype=torch.float32, device=q.device)
        l = torch.zeros((B, q_chunk, H), dtype=torch.float32, device=q.device)
        acc = torch.zeros((B, q_chunk, H, Dv), dtype=torch.float32, device=q.device)
        for ik in range(nk):
            kb = kf[:, ik * k_chunk:(ik + 1) * k_chunk]
            vb = vf[:, ik * k_chunk:(ik + 1) * k_chunk]
            s = torch.einsum("bqhd,bkhd->bqhk", qb, kb) * scale
            kpos = ik * k_chunk + torch.arange(k_chunk, device=q.device)
            mask = (kpos < kv_len)[None, :]
            if causal:
                mask = mask & (kpos[None, :] <= qpos[:, None])
            if window is not None:
                mask = mask & (kpos[None, :] > qpos[:, None] - window)
            mask = mask[None, :, None, :]  # (1, qc, 1, kc)
            s = torch.where(mask, s, NEG_INF)
            m_new = torch.maximum(m, torch.amax(s, dim=-1))
            p = torch.where(mask, torch.exp(s - m_new[..., None]), 0.0)
            alpha = torch.exp(m - m_new)
            l = alpha * l + torch.sum(p, dim=-1)
            acc = acc * alpha[..., None] + torch.einsum("bqhk,bkhd->bqhd", p, vb)
            m = m_new
        safe = torch.where(l > 0.0, l, 1.0)
        out = torch.where((l > 0.0)[..., None], acc / safe[..., None], 0.0)
        outs.append(out.to(q.dtype))
    return torch.cat(outs, dim=1)[:, :Sq]


def decode_attention(q, k_cache, v_cache, length: int):
    """Single-step attention over a KV cache of which ``length`` entries are valid.

    q: (B, 1, H, D); caches: (B, S, KH, D).  Entries at and beyond ``length``
    take no part, as the JAX version masks them; here they are sliced away.
    The products are taken in f32.
    """
    B, _, H, D = q.shape
    KH = k_cache.shape[2]
    group = H // KH
    scale = 1.0 / (D ** 0.5)
    k = k_cache[:, :length].float()
    v = v_cache[:, :length].float()
    qf = q.float().reshape(B, 1, KH, group, D)
    s = torch.einsum("bqhgd,bshd->bqhgs", qf, k) * scale
    p = torch.exp(s - torch.amax(s, dim=-1, keepdim=True))
    num = torch.einsum("bqhgs,bshd->bqhgd", p, v)
    den = torch.sum(p, dim=-1)
    out = num / torch.clamp_min(den, 1e-30)[..., None]
    return out.reshape(B, 1, H, D).to(q.dtype)


class FlashAttention(torch.autograd.Function):
    """Attention with a kernel each way.  ``grad``: the call makes a
    gradient (grad mode on and an input that requires grad, which
    ``flash_attention_cuda`` decides: inside ``forward`` grad mode is off and
    ``ctx.needs_input_grad`` follows requires_grad alone).  Then the forward
    kernel also writes each row's lse, and the forward saves q, k, v, its
    output and the lse for the backward kernel; otherwise (serving, or a
    no_grad call on a trainer's parameters) it writes and saves nothing.
    The masks take no gradient."""

    @staticmethod
    def forward(ctx, q, k, v, causal, window, q_offset, kv_len, grad):
        ctx.masks = dict(causal=causal, window=window, q_offset=q_offset, kv_len=kv_len)
        if not grad:
            return flash_attention_fwd(q, k, v, **ctx.masks)
        o, lse = flash_attention_fwd(q, k, v, with_lse=True, **ctx.masks)
        ctx.save_for_backward(q, k, v, o, lse)
        return o

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, dout):
        q, k, v, o, lse = ctx.saved_tensors
        dq, dk, dv = flash_attention_bwd(q, k, v, o, dout.contiguous(), lse, **ctx.masks)
        return dq, dk, dv, None, None, None, None, None


def flash_attention_cuda(q, k, v, *, causal=True, window=None, q_offset=0, kv_len=None):
    """``flash_attention`` on the card: ``FlashAttention``, making a gradient
    when grad mode is on and an input requires grad (a no_grad or
    inference_mode call on a trainer's parameters serves: no lse)."""
    grad = torch.is_grad_enabled() and any(t.requires_grad for t in (q, k, v))
    return FlashAttention.apply(q.contiguous(), k.contiguous(), v.contiguous(),
                                causal, window, q_offset, kv_len, grad)


def flash_attention(q, k, v, *, causal=True, window=None, q_offset=0, kv_len=None):
    """Attention entry point used by the models.

    q: (B, Sq, H, Dk); k: (B, Sk, KH, Dk); v: (B, Sk, KH, Dv).  The kernels
    mask the ragged edge of the last q and kv tiles themselves, so nothing is
    padded.  ``kv_len`` masks trailing (padded) keys.  On the card the result
    has a ``grad_fn`` whenever grad mode is on and an input requires grad.
    """
    if q.device.type == "cuda":
        return flash_attention_cuda(q, k, v, causal=causal, window=window, q_offset=q_offset,
                                    kv_len=kv_len)
    if q.device.type == "cpu":
        return chunked_attention(q, k, v, causal=causal, window=window,
                                 q_offset=q_offset, kv_len=kv_len)
    raise ValueError(f"flash_attention: unsupported device {q.device}")

"""Attention entry points (``repro.kernels.flash_attention.ops`` twin).

* ``flash_attention`` — the entry point the models call.  A CUDA tensor goes
  through the custom op ``flash_attention_op`` (``flash_attention_cuda``),
  and a fake one (the dry-run) reaches its fake implementation: forward by the
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

import functools
from typing import Optional

import torch
import torch.nn.functional as F
from torch.distributed.tensor import DTensor, Replicate
from torch.utils.flop_counter import register_flop_formula

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


def decode_attention(q, k_cache, v_cache, length: int, logits_constraint=None):
    """Single-step attention over a KV cache of which ``length`` entries are valid.

    q: (B, 1, H, D); caches: (B, S, KH, D).  Entries at and beyond ``length``
    take no part, as the JAX version masks them; here they are sliced away,
    and masked in a cache sharded as a DTensor, which slicing would gather.
    The products are taken in f32.  ``logits_constraint`` pins the sharding
    of the (B, 1, KH, group, S) logits.
    """
    B, _, H, D = q.shape
    KH = k_cache.shape[2]
    group = H // KH
    scale = 1.0 / (D ** 0.5)
    sharded = isinstance(k_cache, DTensor)
    if not sharded:
        k_cache, v_cache = k_cache[:, :length], v_cache[:, :length]
    k, v = k_cache.float(), v_cache.float()
    qf = q.float().reshape(B, 1, KH, group, D)
    s = torch.einsum("bqhgd,bshd->bqhgs", qf, k) * scale
    if logits_constraint is not None:
        s = logits_constraint(s)
    if sharded:  # the mask as a DTensor every rank holds whole
        valid = DTensor.from_local(torch.arange(s.shape[-1], device=s.device) < length,
                                   s.device_mesh, [Replicate()] * s.device_mesh.ndim,
                                   run_check=False)
        s = torch.where(valid, s, NEG_INF)
    p = torch.exp(s - torch.amax(s, dim=-1, keepdim=True))
    num = torch.einsum("bqhgs,bshd->bqhgd", p, v)
    den = torch.sum(p, dim=-1)
    out = num / torch.clamp_min(den, 1e-30)[..., None]
    return out.reshape(B, 1, H, D).to(q.dtype)


# The kernels' entry points as custom ops: a call on fake or meta tensors (the
# dry-run) reaches their fake implementations, never ctypes; autograd, the
# FLOP counters and DTensor's local_map see one op each way.  Launches are
# counted by the kernel wrappers, which only the real implementations call.

@torch.library.custom_op("repro_torch::flash_attention", mutates_args=())
def flash_attention_op(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, causal: bool,
                       window: Optional[int], q_offset: int, kv_len: Optional[int],
                       grad: bool) -> tuple[torch.Tensor, torch.Tensor]:
    """Attention by the forward kernel: (o, lse).  ``grad``: the call makes a
    gradient (grad mode on and an input that requires grad, which
    ``flash_attention_cuda`` decides); then the kernel also writes each
    row's lse, which the backward kernel reads, and autograd saves q, k, v,
    o and the lse.  Otherwise (serving, or a no_grad call on a trainer's
    parameters) nothing is written or saved, and lse is empty."""
    if not grad:
        o = flash_attention_fwd(q, k, v, causal=causal, window=window, q_offset=q_offset,
                                kv_len=kv_len)
        return o, q.new_empty(0, dtype=torch.float32)
    return flash_attention_fwd(q, k, v, causal=causal, window=window, q_offset=q_offset,
                               kv_len=kv_len, with_lse=True)


@flash_attention_op.register_fake
def _(q, k, v, causal, window, q_offset, kv_len, grad):
    B, Sq, H, _ = q.shape
    o = q.new_empty((B, Sq, H, v.shape[3]))
    if not grad:
        return o, q.new_empty(0, dtype=torch.float32)
    pitch = -(-Sq // 4) * 4  # kernel.empty_lse's rows, 16 bytes apart
    return o, q.new_empty_strided((B, H, Sq), (H * pitch, pitch, 1), dtype=torch.float32)


@torch.library.custom_op("repro_torch::flash_attention_bwd", mutates_args=())
def flash_attention_bwd_op(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                           o: torch.Tensor, dout: torch.Tensor, lse: torch.Tensor,
                           causal: bool, window: Optional[int], q_offset: int,
                           kv_len: Optional[int]) -> tuple[torch.Tensor, torch.Tensor,
                                                           torch.Tensor]:
    """The gradient of ``flash_attention_op`` by the backward kernels: (dq, dk, dv)."""
    return flash_attention_bwd(q, k, v, o, dout, lse, causal=causal, window=window,
                               q_offset=q_offset, kv_len=kv_len)


@flash_attention_bwd_op.register_fake
def _(q, k, v, o, dout, lse, causal, window, q_offset, kv_len):
    return torch.empty_like(q), torch.empty_like(k), torch.empty_like(v)


def _setup_context(ctx, inputs, output):
    q, k, v, causal, window, q_offset, kv_len, grad = inputs
    ctx.masks = dict(causal=causal, window=window, q_offset=q_offset, kv_len=kv_len)
    if grad:
        ctx.save_for_backward(q, k, v, *output)
    ctx.set_materialize_grads(False)


def _backward(ctx, dout, _dlse):
    """The masks take no gradient; the lse is no output to differentiate."""
    saved = ctx.saved_tensors  # unpacked once: a checkpoint allows no second time
    if not saved:
        raise RuntimeError("flash_attention_op: a gradient of a call made with grad=False")
    q, k, v, o, lse = saved
    dout = torch.zeros_like(o) if dout is None else dout.contiguous()
    dq, dk, dv = flash_attention_bwd_op(q, k, v, o, dout, lse, **ctx.masks)
    return dq, dk, dv, None, None, None, None, None


flash_attention_op.register_autograd(_backward, setup_context=_setup_context)


@functools.lru_cache(maxsize=256)
def visible_pairs(Sq: int, Sk: int, causal: bool, window: Optional[int], q_offset: int,
                  kv_len: Optional[int]) -> int:
    """(query, key) pairs the masks leave visible in one (batch, head)."""
    end = Sk if kv_len is None else min(kv_len, Sk)
    n = 0
    for pos in range(q_offset, q_offset + Sq):
        hi = min(end, pos + 1) if causal else end
        lo = max(0, pos - window + 1) if window is not None else 0
        n += max(0, hi - lo)
    return n


@register_flop_formula(torch.ops.repro_torch.flash_attention)
def _flash_flops(q_shape, k_shape, v_shape, causal, window, q_offset, kv_len, grad, *,
                 out_shape=None, **kwargs):
    """The two products over the visible pairs: S = Q K^T and P V."""
    B, Sq, H, Dk = q_shape
    pairs = visible_pairs(Sq, k_shape[1], causal, window, q_offset, kv_len)
    return 2 * B * H * pairs * (Dk + v_shape[3])


@register_flop_formula(torch.ops.repro_torch.flash_attention_bwd)
def _flash_bwd_flops(q_shape, k_shape, v_shape, o_shape, dout_shape, lse_shape, causal,
                     window, q_offset, kv_len, *, out_shape=None, **kwargs):
    """The five products over the visible pairs: S = Q K^T, dP = dout V^T,
    dV = P^T dout, dQ = dS K, dK = dS^T Q."""
    B, Sq, H, Dk = q_shape
    pairs = visible_pairs(Sq, k_shape[1], causal, window, q_offset, kv_len)
    return 2 * B * H * pairs * (3 * Dk + 2 * v_shape[3])


def flash_attention_cuda(q, k, v, *, causal=True, window=None, q_offset=0, kv_len=None):
    """``flash_attention`` on the card: ``flash_attention_op``, making a
    gradient when grad mode is on and an input requires grad (a no_grad or
    inference_mode call on a trainer's parameters serves: no lse)."""
    grad = torch.is_grad_enabled() and any(t.requires_grad for t in (q, k, v))
    return flash_attention_op(q.contiguous(), k.contiguous(), v.contiguous(), causal, window,
                              q_offset, kv_len, grad)[0]


def flash_attention(q, k, v, *, causal=True, window=None, q_offset=0, kv_len=None):
    """Attention entry point used by the models.

    q: (B, Sq, H, Dk); k: (B, Sk, KH, Dk); v: (B, Sk, KH, Dv).  The kernels
    mask the ragged edge of the last q and kv tiles themselves, so nothing is
    padded.  ``kv_len`` masks trailing (padded) keys.  On the card the result
    has a ``grad_fn`` whenever grad mode is on and an input requires grad.
    """
    if q.device.type == "cuda":  # a fake CUDA tensor too: the dry-run
        return flash_attention_cuda(q, k, v, causal=causal, window=window, q_offset=q_offset,
                                    kv_len=kv_len)
    if q.device.type == "cpu":
        return chunked_attention(q, k, v, causal=causal, window=window,
                                 q_offset=q_offset, kv_len=kv_len)
    raise ValueError(f"flash_attention: unsupported device {q.device}")

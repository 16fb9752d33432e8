"""RWKV6 WKV entry point (``repro.kernels.rwkv6_wkv.ops`` twin).

A CUDA tensor goes through ``RWKV6WKV`` (``rwkv6_wkv_cuda``): forward by the
hand-written kernels (``kernel.rwkv6_wkv_fwd``) for every T >= 1, which
launch the route ``kernel.route()`` names (in chunks on the tensor cores for
bf16 prefill at head dim 64, a step at a time otherwise and for the forward
of a gradient); gradient by the backward kernel (``kernel.rwkv6_wkv_bwd``).
A CPU tensor goes to the plain version (``rwkv6_reference``), which torch
differentiates.  There is no other switch.
"""
from __future__ import annotations

import torch

from .kernel import rwkv6_wkv_bwd, rwkv6_wkv_fwd
from .ref import rwkv6_reference


class RWKV6WKV(torch.autograd.Function):
    """The recurrence with a kernel each way.  ``grad``: the call makes a
    gradient (grad mode on and an input that requires grad, which
    ``rwkv6_wkv_cuda`` decides: inside ``forward`` grad mode is off and
    ``ctx.needs_input_grad`` follows requires_grad alone).  Then the forward
    runs on the route ``kernel.route(..., grad=True)`` names and saves r, k,
    v, w, u and s0 for the backward kernel, which walks the states again
    from s0; otherwise (serving) it runs the serving route and saves
    nothing.  A cotangent autograd leaves undefined (s_last's, in training)
    is taken as zero."""

    @staticmethod
    def forward(ctx, r, k, v, w, u, s0, grad):
        y, s_last = rwkv6_wkv_fwd(r, k, v, w, u, s0, grad=grad)
        if grad:
            ctx.save_for_backward(r, k, v, w, u, s0)
            ctx.set_materialize_grads(False)
        return y, s_last

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, dy, ds_last):
        r, k, v, w, u, s0 = ctx.saved_tensors
        dy = torch.zeros_like(r) if dy is None else dy.contiguous()
        dr, dk, dv, dw, du, ds0 = rwkv6_wkv_bwd(
            r, k, v, w, u, s0, dy, None if ds_last is None else ds_last.contiguous())
        return dr, dk, dv, dw, du, ds0 if ctx.needs_input_grad[5] else None, None


def rwkv6_wkv_cuda(r, k, v, w, u, s0=None):
    """``rwkv6_wkv`` on the card: ``RWKV6WKV``, making a gradient when grad
    mode is on and an input requires grad (a no_grad or inference_mode call
    on a trainer's parameters serves)."""
    grad = torch.is_grad_enabled() and any(
        t is not None and t.requires_grad for t in (r, k, v, w, u, s0))
    return RWKV6WKV.apply(r.contiguous(), k.contiguous(), v.contiguous(), w.contiguous(),
                          u.contiguous(), None if s0 is None else s0.contiguous(), grad)


def rwkv6_wkv(r, k, v, w, u, s0=None):
    """RWKV6 recurrence.  r/k/v/w: (B, T, H, D); u: (H, D); s0: (B, H, D, D)
    f32, or None for a zero state.  Returns (y in r.dtype, s_last in f32).
    On the card the results have a ``grad_fn`` whenever grad mode is on and
    an input requires grad."""
    if r.device.type == "cuda":
        return rwkv6_wkv_cuda(r, k, v, w, u, s0)
    if r.device.type == "cpu":
        return rwkv6_reference(r, k, v, w, u, s0)
    raise ValueError(f"rwkv6_wkv: unsupported device {r.device}")

"""RG-LRU scan entry point (``repro.kernels.rglru_scan.ops`` twin).

A CUDA tensor goes through ``RGLRUScan`` (``rglru_scan_cuda``): forward by
the hand-written kernel (``kernel.rglru_scan_fwd``) for every T >= 1 and
every W, gradient by the backward kernel (``kernel.rglru_scan_bwd``).  A CPU tensor goes to the
plain version (``rglru_reference``), which torch differentiates.  There is
no other switch.
"""
from __future__ import annotations

import torch

from .kernel import rglru_scan_bwd, rglru_scan_fwd
from .ref import rglru_reference


class RGLRUScan(torch.autograd.Function):
    """The recurrence with a kernel each way.  ``grad``: the call makes a
    gradient (grad mode on and an input that requires grad, which
    ``rglru_scan_cuda`` decides: inside ``forward`` grad mode is off and
    ``ctx.needs_input_grad`` follows requires_grad alone).  Then the forward
    saves a, its output h and h0 for the backward kernel; otherwise
    (serving, or a no_grad call on a trainer's parameters) it saves
    nothing.  A cotangent autograd leaves undefined is taken as zero."""

    @staticmethod
    def forward(ctx, a, b, h0, grad):
        h, h_last = rglru_scan_fwd(a, b, h0)
        if grad:
            ctx.save_for_backward(a, h, h0)
            ctx.set_materialize_grads(False)
        return h, h_last

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, dh, dh_last):
        a, h, h0 = ctx.saved_tensors
        dh = torch.zeros_like(h) if dh is None else dh.contiguous()
        da, db, dh0 = rglru_scan_bwd(a, h, h0, dh,
                                     None if dh_last is None else dh_last.contiguous())
        return da, db, dh0 if ctx.needs_input_grad[2] else None, None


def rglru_scan_cuda(a, b, h0=None):
    """``rglru_scan`` on the card: ``RGLRUScan``, making a gradient when grad
    mode is on and an input requires grad (a no_grad or inference_mode call
    on a trainer's parameters serves: nothing saved)."""
    grad = torch.is_grad_enabled() and any(
        t is not None and t.requires_grad for t in (a, b, h0))
    return RGLRUScan.apply(a.contiguous(), b.contiguous(),
                           None if h0 is None else h0.contiguous(), grad)


def rglru_scan(a, b, h0=None):
    """h_t = a_t * h_{t-1} + b_t.  a, b: (B, T, W); h0: (B, W) f32, or None for
    a zero state.  Returns (h in a.dtype, h_last in f32).  On the card the
    results have a ``grad_fn`` whenever grad mode is on and an input
    requires grad."""
    if a.device.type == "cuda":
        return rglru_scan_cuda(a, b, h0)
    if a.device.type == "cpu":
        return rglru_reference(a, b, h0)
    raise ValueError(f"rglru_scan: unsupported device {a.device}")

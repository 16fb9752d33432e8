"""RG-LRU scan entry point (``repro.kernels.rglru_scan.ops`` twin).

A CUDA tensor goes through the custom op ``rglru_scan_op``
(``rglru_scan_cuda``), and a fake one (the dry-run) reaches its fake
implementation: forward by
the hand-written kernel (``kernel.rglru_scan_fwd``) for every T >= 1 and
every W, gradient by the backward kernel (``kernel.rglru_scan_bwd``).  A CPU tensor goes to the
plain version (``rglru_reference``), which torch differentiates.  There is
no other switch.
"""
from __future__ import annotations

from typing import Optional

import torch
from torch.utils.flop_counter import register_flop_formula

from .kernel import rglru_scan_bwd, rglru_scan_fwd
from .ref import rglru_reference


# The kernels' entry points as custom ops: a call on fake or meta tensors (the
# dry-run) reaches their fake implementations, never ctypes.  Launches are
# counted by the kernel wrappers, which only the real implementations call.

@torch.library.custom_op("repro_torch::rglru_scan", mutates_args=())
def rglru_scan_op(a: torch.Tensor, b: torch.Tensor, h0: Optional[torch.Tensor],
                  grad: bool) -> tuple[torch.Tensor, torch.Tensor]:
    """The recurrence by the forward kernel: (h, h_last).  ``grad``: the call
    makes a gradient (grad mode on and an input that requires grad, which
    ``rglru_scan_cuda`` decides); then autograd saves a, h and h0 for the
    backward kernel, otherwise (serving, or a no_grad call on a trainer's
    parameters) nothing."""
    return rglru_scan_fwd(a, b, h0)


@rglru_scan_op.register_fake
def _(a, b, h0, grad):
    return torch.empty_like(a), a.new_empty((a.shape[0], a.shape[2]), dtype=torch.float32)


@torch.library.custom_op("repro_torch::rglru_scan_bwd", mutates_args=())
def rglru_scan_bwd_op(a: torch.Tensor, h: torch.Tensor, h0: Optional[torch.Tensor],
                      dh: torch.Tensor, dh_last: Optional[torch.Tensor]
                      ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The gradient of ``rglru_scan_op`` by the backward kernel: (da, db, dh0)."""
    return rglru_scan_bwd(a, h, h0, dh, dh_last)


@rglru_scan_bwd_op.register_fake
def _(a, h, h0, dh, dh_last):
    return (torch.empty_like(a), torch.empty_like(a),
            a.new_empty((a.shape[0], a.shape[2]), dtype=torch.float32))


def _setup_context(ctx, inputs, output):
    a, _, h0, grad = inputs
    if grad:
        ctx.save_for_backward(a, output[0], h0)
    ctx.set_materialize_grads(False)


def _backward(ctx, dh, dh_last):
    """A cotangent autograd leaves undefined is taken as zero."""
    saved = ctx.saved_tensors  # unpacked once: a checkpoint allows no second time
    if not saved:
        raise RuntimeError("rglru_scan_op: a gradient of a call made with grad=False")
    a, h, h0 = saved
    dh = torch.zeros_like(h) if dh is None else dh.contiguous()
    da, db, dh0 = rglru_scan_bwd_op(a, h, h0, dh,
                                    None if dh_last is None else dh_last.contiguous())
    return da, db, dh0 if ctx.needs_input_grad[2] else None, None


rglru_scan_op.register_autograd(_backward, setup_context=_setup_context)


@register_flop_formula(torch.ops.repro_torch.rglru_scan)
def _scan_flops(a_shape, b_shape, h0_shape, grad, *, out_shape=None, **kwargs):
    """h_t = a_t h_{t-1} + b_t: 2 FLOP an element."""
    B, T, W = a_shape
    return 2 * B * T * W


@register_flop_formula(torch.ops.repro_torch.rglru_scan_bwd)
def _scan_bwd_flops(a_shape, h_shape, h0_shape, dh_shape, dh_last_shape, *, out_shape=None,
                    **kwargs):
    """The gradient's recurrence and da: 3 FLOP an element."""
    B, T, W = a_shape
    return 3 * B * T * W


def rglru_scan_cuda(a, b, h0=None):
    """``rglru_scan`` on the card: ``rglru_scan_op``, making a gradient when
    grad mode is on and an input requires grad (a no_grad or inference_mode
    call on a trainer's parameters serves: nothing saved)."""
    grad = torch.is_grad_enabled() and any(
        t is not None and t.requires_grad for t in (a, b, h0))
    return rglru_scan_op(a.contiguous(), b.contiguous(),
                         None if h0 is None else h0.contiguous(), grad)


def rglru_scan(a, b, h0=None):
    """h_t = a_t * h_{t-1} + b_t.  a, b: (B, T, W); h0: (B, W) f32, or None for
    a zero state.  Returns (h in a.dtype, h_last in f32).  On the card the
    results have a ``grad_fn`` whenever grad mode is on and an input
    requires grad."""
    if a.device.type == "cuda":  # a fake CUDA tensor too: the dry-run
        return rglru_scan_cuda(a, b, h0)
    if a.device.type == "cpu":
        return rglru_reference(a, b, h0)
    raise ValueError(f"rglru_scan: unsupported device {a.device}")

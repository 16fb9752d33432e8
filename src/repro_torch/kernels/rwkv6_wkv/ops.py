"""RWKV6 WKV entry point (``repro.kernels.rwkv6_wkv.ops`` twin).

A CUDA tensor goes through the custom op ``rwkv6_wkv_op`` (``rwkv6_wkv_cuda``),
and a fake one (the dry-run) reaches its fake implementation: forward by the
hand-written kernels (``kernel.rwkv6_wkv_fwd``) for every T >= 1, which
launch the route ``kernel.route()`` names (in bf16 at head dim 64 in chunks:
on the tensor cores for prefill, with y the f32 recurrence's for the forward
of a gradient; a step at a time otherwise); gradient by the backward kernels
(``kernel.rwkv6_wkv_bwd``, on the route ``kernel.bwd_route()`` names).
A CPU tensor goes to the plain version (``rwkv6_reference``), which torch
differentiates.  There is no other switch.
"""
from __future__ import annotations

from typing import Optional

import torch
from torch.utils.flop_counter import register_flop_formula

from .kernel import rwkv6_wkv_bwd, rwkv6_wkv_fwd
from .ref import rwkv6_reference


# The kernels' entry points as custom ops: a call on fake or meta tensors (the
# dry-run) reaches their fake implementations, never ctypes.  Launches are
# counted by the kernel wrappers, which only the real implementations call.

@torch.library.custom_op("repro_torch::rwkv6_wkv", mutates_args=())
def rwkv6_wkv_op(r: torch.Tensor, k: torch.Tensor, v: torch.Tensor, w: torch.Tensor,
                 u: torch.Tensor, s0: Optional[torch.Tensor],
                 grad: bool) -> tuple[torch.Tensor, torch.Tensor]:
    """The recurrence by the forward kernels: (y, s_last).  ``grad``: the call
    makes a gradient (grad mode on and an input that requires grad, which
    ``rwkv6_wkv_cuda`` decides); then it runs on the route
    ``kernel.route(..., grad=True)`` names and autograd saves r, k, v, w, u
    and s0 for the backward kernel, which walks the states again from s0;
    otherwise (serving) it runs the serving route and saves nothing."""
    return rwkv6_wkv_fwd(r, k, v, w, u, s0, grad=grad)


@rwkv6_wkv_op.register_fake
def _(r, k, v, w, u, s0, grad):
    B, _, H, D = r.shape
    return torch.empty_like(r), r.new_empty((B, H, D, D), dtype=torch.float32)


@torch.library.custom_op("repro_torch::rwkv6_wkv_bwd", mutates_args=())
def rwkv6_wkv_bwd_op(r: torch.Tensor, k: torch.Tensor, v: torch.Tensor, w: torch.Tensor,
                     u: torch.Tensor, s0: Optional[torch.Tensor], dy: torch.Tensor,
                     ds_last: Optional[torch.Tensor]
                     ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor,
                                torch.Tensor, torch.Tensor]:
    """The gradient of ``rwkv6_wkv_op`` by the backward kernels: (dr, dk, dv,
    dw, du, ds0)."""
    return rwkv6_wkv_bwd(r, k, v, w, u, s0, dy, ds_last)


@rwkv6_wkv_bwd_op.register_fake
def _(r, k, v, w, u, s0, dy, ds_last):
    B, _, H, D = r.shape
    return (*(torch.empty_like(r) for _ in range(4)), torch.empty_like(u),
            r.new_empty((B, H, D, D), dtype=torch.float32))


def _setup_context(ctx, inputs, output):
    *tensors, grad = inputs
    if grad:
        ctx.save_for_backward(*tensors)
    ctx.set_materialize_grads(False)


def _backward(ctx, dy, ds_last):
    """A cotangent autograd leaves undefined (s_last's, in training) is taken
    as zero."""
    saved = ctx.saved_tensors  # unpacked once: a checkpoint allows no second time
    if not saved:
        raise RuntimeError("rwkv6_wkv_op: a gradient of a call made with grad=False")
    r, k, v, w, u, s0 = saved
    dy = torch.zeros_like(r) if dy is None else dy.contiguous()
    dr, dk, dv, dw, du, ds0 = rwkv6_wkv_bwd_op(
        r, k, v, w, u, s0, dy, None if ds_last is None else ds_last.contiguous())
    return dr, dk, dv, dw, du, ds0 if ctx.needs_input_grad[5] else None, None


rwkv6_wkv_op.register_autograd(_backward, setup_context=_setup_context)


@register_flop_formula(torch.ops.repro_torch.rwkv6_wkv)
def _wkv_flops(r_shape, *args, out_shape=None, **kwargs):
    """4 D^2 FLOP a (b, t, h): the state's decay and update, and y."""
    B, T, H, D = r_shape
    return 4 * B * T * H * D * D


@register_flop_formula(torch.ops.repro_torch.rwkv6_wkv_bwd)
def _wkv_bwd_flops(r_shape, *args, out_shape=None, **kwargs):
    """14 D^2 + 8 D FLOP a (b, t, h): the state's recurrence and the
    gradient's, 3 D^2 each; dr, dk, dv and dw, 2 D^2 each; v . dy, u r . k
    and du's term, 8 D."""
    B, T, H, D = r_shape
    return (14 * D * D + 8 * D) * B * T * H


def rwkv6_wkv_cuda(r, k, v, w, u, s0=None):
    """``rwkv6_wkv`` on the card: ``rwkv6_wkv_op``, making a gradient when
    grad mode is on and an input requires grad (a no_grad or inference_mode
    call on a trainer's parameters serves)."""
    grad = torch.is_grad_enabled() and any(
        t is not None and t.requires_grad for t in (r, k, v, w, u, s0))
    return rwkv6_wkv_op(r.contiguous(), k.contiguous(), v.contiguous(), w.contiguous(),
                        u.contiguous(), None if s0 is None else s0.contiguous(), grad)


def rwkv6_wkv(r, k, v, w, u, s0=None):
    """RWKV6 recurrence.  r/k/v/w: (B, T, H, D); u: (H, D); s0: (B, H, D, D)
    f32, or None for a zero state.  Returns (y in r.dtype, s_last in f32).
    On the card the results have a ``grad_fn`` whenever grad mode is on and
    an input requires grad."""
    if r.device.type == "cuda":  # a fake CUDA tensor too: the dry-run
        return rwkv6_wkv_cuda(r, k, v, w, u, s0)
    if r.device.type == "cpu":
        return rwkv6_reference(r, k, v, w, u, s0)
    raise ValueError(f"rwkv6_wkv: unsupported device {r.device}")

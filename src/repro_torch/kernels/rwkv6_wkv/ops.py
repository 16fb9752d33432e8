"""RWKV6 WKV entry point (``repro.kernels.rwkv6_wkv.ops`` twin).

A CUDA tensor goes to the hand-written kernels (``kernel.rwkv6_wkv_fwd``)
for every T >= 1, which launch the route ``kernel.route()`` names (in chunks
on the tensor cores for bf16 prefill at head dim 64, a step at a time
otherwise); a CPU tensor goes to the plain version (``rwkv6_reference``).
There is no other switch.
"""
from __future__ import annotations

from .kernel import rwkv6_wkv_fwd
from .ref import rwkv6_reference


def rwkv6_wkv(r, k, v, w, u, s0=None):
    """RWKV6 recurrence.  r/k/v/w: (B, T, H, D); u: (H, D); s0: (B, H, D, D)
    f32, or None for a zero state.  Returns (y in r.dtype, s_last in f32)."""
    if r.device.type == "cuda":
        return rwkv6_wkv_fwd(r.contiguous(), k.contiguous(), v.contiguous(),
                             w.contiguous(), u.contiguous(),
                             None if s0 is None else s0.contiguous())
    if r.device.type == "cpu":
        return rwkv6_reference(r, k, v, w, u, s0)
    raise ValueError(f"rwkv6_wkv: unsupported device {r.device}")

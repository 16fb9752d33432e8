"""RG-LRU scan entry point (``repro.kernels.rglru_scan.ops`` twin).

A CUDA tensor goes to the hand-written kernel (``kernel.rglru_scan_fwd``) for
every T >= 1 and every W; a CPU tensor goes to the plain version
(``rglru_reference``).  There is no other switch.
"""
from __future__ import annotations

from .kernel import rglru_scan_fwd
from .ref import rglru_reference


def rglru_scan(a, b, h0=None):
    """h_t = a_t * h_{t-1} + b_t.  a, b: (B, T, W); h0: (B, W) f32, or None for
    a zero state.  Returns (h in a.dtype, h_last in f32)."""
    if a.device.type == "cuda":
        return rglru_scan_fwd(a.contiguous(), b.contiguous(),
                              None if h0 is None else h0.contiguous())
    if a.device.type == "cpu":
        return rglru_reference(a, b, h0)
    raise ValueError(f"rglru_scan: unsupported device {a.device}")

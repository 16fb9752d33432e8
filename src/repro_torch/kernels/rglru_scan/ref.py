"""Plain PyTorch version of the RG-LRU diagonal linear recurrence
(``repro.kernels.rglru_scan.ref`` twin).

    h_t = a_t * h_{t-1} + b_t   (elementwise over channels)

The gates (a_t, b_t) are computed by the surrounding block; this runs only
the recurrence.
"""
from __future__ import annotations

import torch


def rglru_reference(a, b, h0=None):
    """a, b: (B, T, W); h0: (B, W) or None (zeros).

    A loop over T with the state in f32.  Returns (h (B, T, W) in a.dtype,
    h_last (B, W) in f32).
    """
    B, T, W = a.shape
    h = (torch.zeros((B, W), dtype=torch.float32, device=a.device) if h0 is None
         else h0.float())
    af, bf = a.float(), b.float()
    hs = []
    for t in range(T):
        h = af[:, t] * h + bf[:, t]
        hs.append(h)
    return torch.stack(hs, dim=1).to(a.dtype), h

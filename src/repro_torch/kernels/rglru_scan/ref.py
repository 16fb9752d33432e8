"""Plain PyTorch version of the RG-LRU diagonal linear recurrence
(``repro.kernels.rglru_scan.ref`` twin), and of its backward.

    h_t = a_t * h_{t-1} + b_t   (elementwise over channels)

The gates (a_t, b_t) are computed by the surrounding block; this runs only
the recurrence.  Both compute in f32, or in f64 for f64 inputs (which the
tests' gradcheck uses).
"""
from __future__ import annotations

import torch


def rglru_reference(a, b, h0=None):
    """a, b: (B, T, W); h0: (B, W) or None (zeros).

    A loop over T with the state in f32.  Returns (h (B, T, W) in a.dtype,
    h_last (B, W) in f32).
    """
    B, T, W = a.shape
    acc = torch.promote_types(a.dtype, torch.float32)
    h = (torch.zeros((B, W), dtype=acc, device=a.device) if h0 is None
         else h0.to(acc))
    af, bf = a.to(acc), b.to(acc)
    hs = []
    for t in range(T):
        h = af[:, t] * h + bf[:, t]
        hs.append(h)
    return torch.stack(hs, dim=1).to(a.dtype), h


def rglru_scan_bwd_reference(a, h, h0, dh, dh_last):
    """The plain version of ``kernel.rglru_scan_bwd``, with its arithmetic.

    a: (B, T, W) as the forward was given it; h: the forward's output (B, T,
    W) in a.dtype; h0: (B, W) f32, or None for a zero state; dh: the
    gradient of h, in h's shape and dtype; dh_last: the gradient of h_last,
    (B, W) f32, or None for zero.  A reverse loop over T in f32, with c_t
    the cotangent that reaches h_t:

        c_{T-1} = dh_{T-1} + dh_last,   c_t = dh_t + a_{t+1} c_{t+1},
        db_t = c_t,   da_t = c_t h_{t-1} (h_{-1} = h0),   dh0 = a_0 c_0.

    Returns (da, db) in a.dtype and dh0 (B, W) in f32.
    """
    B, T, W = a.shape
    acc = torch.promote_types(a.dtype, torch.float32)
    af, hf, dhf = a.to(acc), h.to(acc), dh.to(acc)
    zeros = torch.zeros((B, W), dtype=acc, device=a.device)
    g = zeros if dh_last is None else dh_last.to(acc)   # a_{t+1} c_{t+1}
    h_init = zeros if h0 is None else h0.to(acc)
    da = torch.empty((B, T, W), dtype=acc, device=a.device)
    db = torch.empty_like(da)
    for t in reversed(range(T)):
        c = dhf[:, t] + g
        db[:, t] = c
        da[:, t] = c * (hf[:, t - 1] if t else h_init)
        g = af[:, t] * c
    return da.to(a.dtype), db.to(a.dtype), g

"""Plain PyTorch version of the RWKV6 (Finch) WKV recurrence
(``repro.kernels.rwkv6_wkv.ref`` twin).

Per head, with a state S of shape (D_k, D_v):
    y_t = r_t^T (S_t + (u * k_t) v_t^T)
    S_{t+1} = diag(w_t) S_t + k_t v_t^T
with a data-dependent per-channel decay w_t in (0, 1).
"""
from __future__ import annotations

import torch


def rwkv6_reference(r, k, v, w, u, s0=None):
    """r, k, v, w: (B, T, H, D); u: (H, D); s0: (B, H, D, D) or None (zeros).

    A loop over T with the state in f32.  Returns (y (B, T, H, D) in
    r.dtype, s_last (B, H, D, D) in f32).
    """
    B, T, H, D = r.shape
    S = (torch.zeros((B, H, D, D), dtype=torch.float32, device=r.device) if s0 is None
         else s0.float())
    rf, kf, vf, wf = (x.float() for x in (r, k, v, w))
    uf = u.float()[None, :, :, None]
    ys = []
    for t in range(T):
        kv = torch.einsum("bhi,bhj->bhij", kf[:, t], vf[:, t])
        ys.append(torch.einsum("bhi,bhij->bhj", rf[:, t], S + uf * kv))
        S = wf[:, t, :, :, None] * S + kv
    return torch.stack(ys, dim=1).to(r.dtype), S

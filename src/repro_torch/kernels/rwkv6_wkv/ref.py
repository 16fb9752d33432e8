"""Plain PyTorch version of the RWKV6 (Finch) WKV recurrence
(``repro.kernels.rwkv6_wkv.ref`` twin), and of its backward.

Per head, with a state S of shape (D_k, D_v):
    y_t = r_t^T (S_t + (u * k_t) v_t^T)
    S_{t+1} = diag(w_t) S_t + k_t v_t^T
with a data-dependent per-channel decay w_t in [0, 1].  Both compute in
f32, or in f64 for f64 inputs (which the tests' gradcheck uses).
"""
from __future__ import annotations

import torch


def rwkv6_reference(r, k, v, w, u, s0=None):
    """r, k, v, w: (B, T, H, D); u: (H, D); s0: (B, H, D, D) or None (zeros).

    A loop over T with the state in f32 (f64 for f64 inputs).  Returns (y
    (B, T, H, D) in r.dtype, s_last (B, H, D, D) in f32, or f64).
    """
    B, T, H, D = r.shape
    acc = torch.promote_types(r.dtype, torch.float32)
    S = (torch.zeros((B, H, D, D), dtype=acc, device=r.device) if s0 is None
         else s0.to(acc))
    rf, kf, vf, wf = (x.to(acc) for x in (r, k, v, w))
    uf = u.to(acc)[None, :, :, None]
    ys = []
    for t in range(T):
        kv = torch.einsum("bhi,bhj->bhij", kf[:, t], vf[:, t])
        ys.append(torch.einsum("bhi,bhij->bhj", rf[:, t], S + uf * kv))
        S = wf[:, t, :, :, None] * S + kv
    return torch.stack(ys, dim=1).to(r.dtype), S


def rwkv6_wkv_bwd_reference(r, k, v, w, u, s0, dy, ds_last):
    """The plain version of ``kernel.rwkv6_wkv_bwd``, with its arithmetic.

    r, k, v, w: (B, T, H, D) and u (H, D), s0 (B, H, D, D) f32 or None (a
    zero state), as the forward was given them; dy: the gradient of y, in
    r's shape and dtype; ds_last: the gradient of s_last, (B, H, D, D) f32,
    or None for zero.  In f32 (f64 for f64 inputs), with S_t the state
    before step t (a forward walk from s0) and G_t the gradient that
    reaches S_{t+1} (G_{T-1} = ds_last), walking t from T - 1 down to 0:

        dr_t[i] = sum_j S_t[i,j] dy_t[j] + u[i] k_t[i] (v_t . dy_t)
        dk_t[i] = u[i] r_t[i] (v_t . dy_t) + sum_j G_t[i,j] v_t[j]
        dv_t[j] = dy_t[j] sum_i u[i] r_t[i] k_t[i] + sum_i k_t[i] G_t[i,j]
        dw_t[i] = sum_j S_t[i,j] G_t[i,j]
        du[i]   = sum over b and t of r_t[i] k_t[i] (v_t . dy_t)
        G_{t-1}[i,j] = w_t[i] G_t[i,j] + r_t[i] dy_t[j]

    and ds0 = G_{-1}, the gradient that reaches S_0.  No state is rebuilt
    from a later one (w is 0 at times), so the forward walk keeps every
    S_t.  Returns (dr, dk, dv, dw) in r.dtype, and du (H, D) and ds0 (B, H,
    D, D) in f32 (f64).
    """
    B, T, H, D = r.shape
    acc = torch.promote_types(r.dtype, torch.float32)
    rf, kf, vf, wf, dyf = (x.to(acc) for x in (r, k, v, w, dy))
    uf = u.to(acc)
    S = (torch.zeros((B, H, D, D), dtype=acc, device=r.device) if s0 is None
         else s0.to(acc))
    states = []
    for t in range(T):
        states.append(S)
        S = wf[:, t, :, :, None] * S + kf[:, t, :, :, None] * vf[:, t, :, None, :]
    vdy = (vf * dyf).sum(-1)                           # (B, T, H)
    urk = (uf * rf * kf).sum(-1)                       # (B, T, H)
    G = (torch.zeros((B, H, D, D), dtype=acc, device=r.device) if ds_last is None
         else ds_last.to(acc))
    dr, dk, dv, dw = (torch.empty((B, T, H, D), dtype=acc, device=r.device)
                      for _ in range(4))
    for t in reversed(range(T)):
        St = states[t]
        dr[:, t] = (torch.einsum("bhij,bhj->bhi", St, dyf[:, t])
                    + uf * kf[:, t] * vdy[:, t, :, None])
        dk[:, t] = (uf * rf[:, t] * vdy[:, t, :, None]
                    + torch.einsum("bhij,bhj->bhi", G, vf[:, t]))
        dv[:, t] = (dyf[:, t] * urk[:, t, :, None]
                    + torch.einsum("bhi,bhij->bhj", kf[:, t], G))
        dw[:, t] = (St * G).sum(-1)
        G = wf[:, t, :, :, None] * G + rf[:, t, :, :, None] * dyf[:, t, :, None, :]
    du = (rf * kf * vdy[..., None]).sum((0, 1))
    return (*(x.to(r.dtype) for x in (dr, dk, dv, dw)), du, G)

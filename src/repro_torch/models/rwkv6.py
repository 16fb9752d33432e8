"""RWKV6 (Finch) block: data-dependent token-shift time mix and channel mix
(``repro.models.rwkv6`` twin).

The WKV state recurrence runs through ``kernels.rwkv6_wkv.rwkv6_wkv``: the
CUDA kernel for a tensor on the card, its plain version on the CPU.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch import sharding
from repro_torch.kernels.rwkv6_wkv import rwkv6_wkv
from repro_torch.sharding import constrain, is_sharded

from .layers import rms_norm

_HEADS = ("batch", "seq", "heads", "head_dim")
_STATE = ("batch", "heads", "head_dim", None)


def _wkv(r, k, v, w, u, state):
    """``rwkv6_wkv``; under a mesh on each rank's batch rows and heads, u's
    gradient a partial sum over the batch's mesh axes."""
    if not is_sharded(r):
        return rwkv6_wkv(r, k, v, w, u, state)
    return sharding.local_call(rwkv6_wkv, (r, k, v, w, u, state),
                               (_HEADS,) * 4 + (("heads", "head_dim"),
                                                None if state is None else _STATE),
                               (_HEADS, _STATE), grad_sum={4: ("batch",)})


def _shift(x, prev):
    """Token shift: x_{t-1} with x_{-1} = prev (or zeros).  x: (B, S, D)."""
    if prev is None:
        prev = torch.zeros_like(x[:, :1])
    else:
        prev = prev[:, None, :].to(x.dtype)
    return torch.cat([prev, x[:, :-1]], dim=1)


def _group_norm(x, scale, eps=1e-5):
    """Per-head layer norm with the population variance.  x: (B, S, H, D);
    scale: (H, D)."""
    xf = x.float()
    mu = torch.mean(xf, dim=-1, keepdim=True)
    var = torch.var(xf, dim=-1, keepdim=True, correction=0)
    return ((xf - mu) * torch.rsqrt(var + eps) * (1.0 + scale.float())).to(x.dtype)


def _time_mix(p, x, x_prev, *, cfg, state):
    B, S, D = x.shape
    hd = cfg.rwkv_head_dim
    H = D // hd
    dx = x_prev - x
    xxx = x + dx * p["tm_mu_x"].to(x.dtype)
    z = torch.tanh(torch.einsum("bsd,dk->bsk", xxx, p["tm_w1"]))
    z = z.reshape(B, S, 5, 32)
    adj = torch.einsum("bsfk,fkd->bsfd", z, p["tm_w2"])
    mixed = x[:, :, None, :] + dx[:, :, None, :] * (p["tm_mus"].to(x.dtype) + adj)
    xw, xk, xv, xr, xg = (mixed[:, :, j, :] for j in range(5))

    r = torch.einsum("bsd,dhk->bshk", xr, p["wr"])
    k = torch.einsum("bsd,dhk->bshk", xk, p["wk"])
    v = torch.einsum("bsd,dhk->bshk", xv, p["wv"])
    g = F.silu(torch.einsum("bsd,dhk->bshk", xg, p["wg"]))
    r = constrain(r, *_HEADS)

    dz = torch.tanh(torch.einsum("bsd,dk->bsk", xw, p["decay_w1"]))
    decay = p["decay_base"].float() + torch.einsum("bsk,kd->bsd", dz, p["decay_w2"]).float()
    w = torch.exp(-torch.exp(decay)).reshape(B, S, H, hd)  # in (0, 1)

    # the decay is rounded to the activations' dtype before the recurrence,
    # as the JAX package does
    y, s_last = _wkv(r, k, v, w.to(r.dtype), p["u"], state)
    y = constrain(_group_norm(y, p["ln_x"]) * g, *_HEADS)
    out = torch.einsum("bshk,hkd->bsd", y, p["wo"])
    return out, s_last


def rwkv_block(p, x, *, cfg, mode, cache):
    """Full RWKV6 layer (time-mix and channel-mix residual branches).

    Returns (x, new_cache); new_cache is {"s", "x_tm", "x_cm"} in f32 in
    prefill and decode, None in train.  Prefill starts from a zero state.
    """
    # --- time mix ---
    y = rms_norm(x, p["ln1"])
    if mode == "decode":
        x_prev = cache["x_tm"][:, None, :].to(y.dtype)
        state = cache["s"]
    else:
        x_prev = _shift(y, None)
        state = None
    tm_out, s_last = _time_mix(p, y, x_prev, cfg=cfg, state=state)
    x = x + tm_out

    # --- channel mix ---
    y2 = rms_norm(x, p["ln2"])
    if mode == "decode":
        y2_prev = cache["x_cm"][:, None, :].to(y2.dtype)
    else:
        y2_prev = _shift(y2, None)
    dk = y2 + (y2_prev - y2) * p["cm_mu_k"].to(y2.dtype)
    dr = y2 + (y2_prev - y2) * p["cm_mu_r"].to(y2.dtype)
    kk = torch.relu(torch.einsum("bsd,df->bsf", dk, p["cm_k"]))
    kk = constrain(kk * kk, "batch", "seq", "ffn")
    cm = torch.einsum("bsf,fd->bsd", kk, p["cm_v"])
    rr = torch.sigmoid(torch.einsum("bsd,de->bse", dr, p["cm_r"]))
    x = x + rr.to(cm.dtype) * cm

    new_cache = None
    if mode in ("prefill", "decode"):
        new_cache = {"s": s_last,
                     "x_tm": y[:, -1, :].float(),
                     "x_cm": y2[:, -1, :].float()}
    return x, new_cache

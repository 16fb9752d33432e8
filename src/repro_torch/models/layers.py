"""Shared primitive layers: norms, rope, MLPs (``repro.models.layers`` twin)."""
from __future__ import annotations

import torch
import torch.nn.functional as F


def rms_norm(x, scale, eps=1e-6):
    """RMS norm computed in f32, scaled by ``1 + scale``, returned in x.dtype."""
    xf = x.float()
    var = torch.mean(xf * xf, dim=-1, keepdim=True)
    return ((xf * torch.rsqrt(var + eps)) * (1.0 + scale.float())).to(x.dtype)


def rope(x, positions, theta):
    """Rotary embedding, half-split rotation.  x: (..., S, H, D); positions (..., S)."""
    half = x.shape[-1] // 2
    freqs = theta ** (-torch.arange(0, half, dtype=torch.float32, device=x.device) / half)
    ang = positions[..., None].float() * freqs  # (..., S, half)
    cos = torch.cos(ang)[..., None, :]
    sin = torch.sin(ang)[..., None, :]
    x1, x2 = torch.chunk(x.float(), 2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


def _act(kind, g, u):
    if kind == "swiglu":
        return F.silu(g) * u
    if kind == "geglu":  # jax.nn.gelu's default is the tanh approximation
        return F.gelu(g, approximate="tanh") * u
    raise NotImplementedError(f"mlp kind {kind!r} is not ported yet")


def mlp_apply(p, x, kind):
    """Gated / plain MLP.  p: {wg?, wu, wo}."""
    u = torch.matmul(x, p["wu"])
    g = torch.matmul(x, p["wg"]) if "wg" in p else None
    return torch.matmul(_act(kind, g, u), p["wo"])

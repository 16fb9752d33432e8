"""Shared primitive layers: norms, rope, MLPs, chunked CE loss
(``repro.models.layers`` twin)."""
from __future__ import annotations

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from repro_torch.sharding import constant, constrain, is_sharded


def rms_norm(x, scale, eps=1e-6):
    """RMS norm computed in f32, scaled by ``1 + scale``, returned in x.dtype."""
    xf = x.float()
    var = torch.mean(xf * xf, dim=-1, keepdim=True)
    return ((xf * torch.rsqrt(var + eps)) * (1.0 + scale.float())).to(x.dtype)


def rope(x, positions, theta):
    """Rotary embedding, half-split rotation.  x: (..., S, H, D); positions (..., S)."""
    half = x.shape[-1] // 2
    freqs = theta ** (-torch.arange(0, half, dtype=torch.float32, device=x.device) / half)
    ang = positions[..., None].float() * constant(positions, freqs)  # (..., S, half)
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
    if kind == "gelu":  # ungated: g is None
        return F.gelu(u, approximate="tanh")
    if kind == "relu2":  # ungated: g is None
        r = F.relu(u)
        return r * r
    raise ValueError(kind)


def mlp_apply(p, x, kind):
    """Gated / plain MLP.  p: {wg?, wu, wo}."""
    u = torch.matmul(x, p["wu"])
    g = torch.matmul(x, p["wg"]) if "wg" in p else None
    h = constrain(_act(kind, g, u), "batch", "seq", "ffn")
    return torch.matmul(h, p["wo"])


def _chunk_nll(xc, head_w32, labels, mask):
    """Sum of the chunk's masked negative log-likelihoods, from f32 logits."""
    logits = torch.matmul(xc.float(), head_w32)              # (B, chunk, V) f32
    logits = constrain(logits, "batch", "seq", "vocab")
    if is_sharded(logits):
        lse, picked = _sharded_lse_picked(logits, labels)
    else:
        lse = torch.logsumexp(logits, dim=-1)
        picked = torch.gather(logits, -1, labels[..., None])[..., 0]
    return torch.sum(torch.where(mask, lse - picked, 0.0))


def _sharded_lse_picked(logits, labels):
    """Each row's logsumexp and its label's logit from logits whose vocab
    stays sharded: the max, the sum of exponentials and the picked logit
    are reduced across the vocab's shards (all-reduces of (B, chunk) values),
    where gather and logsumexp would gather each f32 chunk whole.  The max
    is a constant of the gradient, as in logsumexp's own."""
    m = torch.amax(logits, dim=-1, keepdim=True).detach()
    lse = torch.log(torch.sum(torch.exp(logits - m), dim=-1)) + m[..., 0]
    vocab = constant(logits, torch.arange(logits.shape[-1], device=logits.device), "vocab")
    picked = torch.sum(torch.where(vocab == labels[..., None], logits, 0.0), dim=-1)
    return lse, picked


def chunked_ce_loss(x, head_w, labels, *, chunk=512, label_mask=None):
    """Cross-entropy over a large vocab without keeping the full f32 logits:
    a loop over sequence chunks, each under ``torch.utils.checkpoint`` so its
    (B, chunk, V) f32 logits are recomputed in the backward pass instead of
    saved.

    x: (B, S, D) final hidden; head_w: (D, V); labels: (B, S) int.  Labels
    below 0, and positions where ``label_mask`` is False, take no part; label
    ids are clipped into the vocab before the gather.  The f32 copy of
    ``head_w`` is made once per call and shared by every chunk.
    Returns (mean_loss, token_count).
    """
    B, S, D = x.shape
    chunk = min(chunk, S)
    pad = (-S) % chunk
    if pad:
        x = F.pad(x, (0, 0, 0, pad))
        labels = F.pad(labels, (0, pad), value=-1)
        if label_mask is not None:
            label_mask = F.pad(label_mask, (0, pad))
    mask = labels >= 0
    if label_mask is not None:
        mask = mask & label_mask.bool()
    head_w32 = head_w.float()
    lab = torch.clamp(labels, 0, head_w.shape[-1] - 1).long()
    tot = torch.zeros((), dtype=torch.float32, device=x.device)
    for i in range(0, S + pad, chunk):
        tot = tot + checkpoint(_chunk_nll, x[:, i:i + chunk], head_w32, lab[:, i:i + chunk],
                               mask[:, i:i + chunk], use_reentrant=False,
                               preserve_rng_state=False)
    cnt = constrain(torch.sum(mask))  # a sharded sum replicated: the loss every rank holds
    return constrain(tot / torch.clamp_min(cnt, 1)), cnt

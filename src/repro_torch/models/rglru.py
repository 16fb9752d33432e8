"""RecurrentGemma recurrent block: gated branch, causal conv1d and RG-LRU
(``repro.models.rglru`` twin).

The RG-LRU recurrence of train and prefill runs through
``kernels.rglru_scan.rglru_scan``: the CUDA kernel for a tensor on the card,
its plain version on the CPU.  A decode step is one elementwise update
outside any kernel, as in the JAX package.  The gate projections are
block-diagonal with ``RGLRU_BLOCKS`` blocks.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.kernels.rglru_scan import rglru_scan

from .layers import rms_norm
from .schema import RGLRU_BLOCKS

RGLRU_C = 8.0  # recurrence sharpness constant (RG-LRU paper value)


def _causal_conv(x, w, b, state=None):
    """Depthwise causal conv, width 4.  x: (B, S, W); w: (4, W); state:
    (B, 3, W) or None (zeros).  The new state is the last 3 rows of the
    padded input."""
    S = x.shape[1]
    if state is None:
        xp = F.pad(x, (0, 0, 3, 0))
    else:
        xp = torch.cat([state.to(x.dtype), x], dim=1)
    out = sum(xp[:, i:i + S] * w[i] for i in range(4)) + b
    new_state = xp[:, -3:] if S >= 1 else state
    return out.to(x.dtype), new_state


def _gates(xb, p, B, S, w_total):
    """Recurrence and input gates in f32.  The block-diagonal products take
    f32 copies of their inputs: a product of two bf16 values is exact in
    f32, so this is the JAX package's ``preferred_element_type=f32``."""
    g = RGLRU_BLOCKS
    wb = w_total // g
    xg = xb.reshape(B, S, g, wb).float()
    r = torch.sigmoid(torch.einsum("bsgw,gwv->bsgv", xg, p["gate_r"].float())
                      + p["bias_r"].float().reshape(g, wb))
    i = torch.sigmoid(torch.einsum("bsgw,gwv->bsgv", xg, p["gate_i"].float())
                      + p["bias_i"].float().reshape(g, wb))
    return r.reshape(B, S, w_total), i.reshape(B, S, w_total)


def _lru_coeffs(p, r, i, xb):
    """a_t = exp(-c softplus(lam) r_t); b_t = sqrt(1 - a_t^2) (i_t x_t), in f32."""
    log_a = -RGLRU_C * F.softplus(p["lam"].float()) * r
    a = torch.exp(log_a)
    mult = torch.sqrt(torch.clamp_min(-torch.expm1(2.0 * log_a), 1e-12))
    b = mult * (i * xb.float())
    return a, b


def rglru_block(p, x, *, cfg, mode, cache):
    """Recurrent residual branch.  x: (B, S, D).

    Returns (x + out, new_cache); new_cache is {"h" (B, W) f32, "conv"
    (B, 3, W)} in prefill and decode, None in train.  Prefill starts from a
    zero state.
    """
    B, S, D = x.shape
    W = cfg.lru_width or D
    y = rms_norm(x, p["ln1"])
    xz = torch.einsum("bsd,dcw->bscw", y, p["w_in"])
    xb, gate = xz[:, :, 0, :], xz[:, :, 1, :]

    new_cache = None
    if mode == "decode":
        xb, conv_state = _causal_conv(xb, p["conv_w"], p["conv_b"], cache["conv"])
        r, i = _gates(xb, p, B, S, W)
        a, b = _lru_coeffs(p, r[:, 0], i[:, 0], xb[:, 0])
        h = a * cache["h"] + b                       # a single step (B, W)
        new_cache = {"h": h, "conv": conv_state}
        h = h[:, None, :]
    else:
        xb, conv_state = _causal_conv(xb, p["conv_w"], p["conv_b"])
        r, i = _gates(xb, p, B, S, W)
        a, b = _lru_coeffs(p, r, i, xb)
        h, h_last = rglru_scan(a, b)
        if mode == "prefill":
            new_cache = {"h": h_last, "conv": conv_state.float()}
    out = torch.einsum("bsw,wd->bsd", F.gelu(gate, approximate="tanh") * h.to(x.dtype),
                       p["w_out"])
    return x + out, new_cache

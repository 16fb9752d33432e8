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

from repro_torch import sharding
from repro_torch.kernels.rglru_scan import rglru_scan
from repro_torch.sharding import constrain, is_sharded

from .layers import rms_norm
from .schema import RGLRU_BLOCKS

_WIDTH = ("batch", "seq", "lru_blocks")


def _scan(a, b):
    """``rglru_scan``; under a mesh on each rank's batch rows and width."""
    if not is_sharded(a):
        return rglru_scan(a, b)
    return sharding.local_call(rglru_scan, (a, b), (_WIDTH, _WIDTH),
                               (_WIDTH, ("batch", "lru_blocks")))

RGLRU_C = 8.0  # recurrence sharpness constant (RG-LRU paper value)


def _causal_conv(x, w, b, state=None):
    """Depthwise causal conv, width 4.  x: (B, S, W); w: (4, W); state:
    (B, 3, W) or None (zeros).  The new state is the last 3 rows of the
    padded input."""
    S = x.shape[1]
    if state is None:  # zeros before x: a pad, written as a cat, which DTensor takes
        xp = torch.cat([torch.zeros_like(x[:, :1]).expand(-1, 3, -1), x], dim=1)
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
    xg = constrain(xb.reshape(B, S, g, wb), "batch", "seq", "lru_blocks", "lru_width").float()
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
    # each branch by its own product: under a mesh the width is sharded, and
    # one product over (D, 2, W) would need a view across the sharded dim
    xb, gate = (torch.einsum("bsd,dw->bsw", y, p["w_in"][:, c]) for c in (0, 1))
    xb = constrain(xb, *_WIDTH)

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
        h, h_last = _scan(a, b)
        if mode == "prefill":
            new_cache = {"h": h_last, "conv": conv_state.float()}
    h = constrain(h.to(x.dtype), *_WIDTH)
    out = torch.einsum("bsw,wd->bsd", F.gelu(gate, approximate="tanh") * h, p["w_out"])
    return x + out, new_cache

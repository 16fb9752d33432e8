"""Mixture-of-Experts layer: a top-k router and a sort/gather dispatch to
capacity buffers (``repro.models.moe`` twin).

The dispatch is capacity-based, as the reference's: token copies are
sorted by expert id (stably), each expert takes up to
C = max(4, ceil(cf * T * k / n_experts)) copies in token order, and the
copies past C are dropped.  Two things the reference leaves to XLA are the
port's contract here:

- the router's top-k puts the lower expert index first on ties, as
  ``lax.top_k`` does (a stable descending sort, where ``torch.topk``
  promises no order);
- the combine is deterministic and uses no atomics: each token's kept
  copies are summed in ascending expert order, from zero, in the experts'
  output dtype, the order in which the reference's scatter-add over the
  expert-sorted buffer adds them.  ``index_add_`` on CUDA adds in an order
  that changes from run to run, which in bf16 changes the result.
"""
from __future__ import annotations

import functools

import torch

from repro_torch import sharding
from repro_torch.sharding import constrain, is_sharded

from .layers import _act, mlp_apply, rms_norm

NEG_INF = -1e30  # the padded experts' router logit: probability exactly 0


def _router(y, p, moe):
    """f32 router: (gates (B, S, k) f32, expert ids (B, S, k), probs (B, S, E))."""
    logits = torch.einsum("bsd,de->bse", y.float(), p["router"].float())
    e_pad = p["router"].shape[-1]
    if e_pad != moe.n_experts:
        # padded experts are unreachable
        emask = torch.arange(e_pad, device=logits.device) < moe.n_experts
        logits = torch.where(emask, logits, NEG_INF)
    probs = torch.softmax(logits, dim=-1)
    ranked = torch.sort(probs, dim=-1, descending=True, stable=True)
    gates, idx = ranked.values[..., :moe.top_k], ranked.indices[..., :moe.top_k]
    if moe.router_norm_topk:
        gates = gates / torch.clamp_min(torch.sum(gates, -1, keepdim=True), 1e-9)
    return gates, idx, probs


def _capacity(moe, tokens: int) -> int:
    """Copies an expert takes: the reference's float arithmetic, scaled by
    the real (not padded) expert count."""
    return max(4, int(-(-moe.capacity_factor * tokens * moe.top_k // moe.n_experts)))


def _shared(p, y, cfg, out):
    """out plus the shared experts behind their sigmoid gate (computed in f32)."""
    if not cfg.moe.n_shared:
        return out
    sh = mlp_apply({"wg": p["sh_wg"], "wu": p["sh_wu"], "wo": p["sh_wo"]}, y, cfg.mlp_kind)
    sg = torch.sigmoid(torch.einsum("bsd,d->bs", y.float(), p["sh_gate"].float()))
    return out + sh * sg[..., None].to(sh.dtype)


def moe_block(p, x, *, cfg):
    """MoE residual branch (pre-norm).  x: (B, S, D).  Returns x + the branch.

    Under a mesh the routed experts run on each rank's shard of them
    (``sharding.local_call``): every rank routes all B S tokens, gathered
    from the batch's shards, so the capacities and drops are the unsharded
    layer's, runs its own experts' slots and sums their copies into a
    partial output, which the reduction over the experts' mesh axes
    completes."""
    y = rms_norm(x, p["ln2"])
    experts = tuple(p[n] for n in ("we_g", "we_u", "we_o") if n in p)
    if not is_sharded(y):
        out = _routed(y, p["router"], *experts, cfg=cfg, e0=0)
    else:
        routed = functools.partial(_routed, cfg=cfg, e0=sharding.local_offset(experts[-1], 0))
        whole = (None, None, None)
        out = sharding.local_call(
            routed, (y, p["router"], *experts),
            (whole, (None, None), *(("experts",),) * len(experts)), (whole,),
            grad_sum={0: ("experts",), 1: ("experts",)}, out_sum={0: ("experts",)})
    out = constrain(out, "batch", "seq", "embed")
    return x + _shared(p, y, cfg, out)


def _routed(y, router, *experts, cfg, e0):
    """The routed experts' sum for every token of y (B, S, D), from the
    experts e0, e0 + 1, ... whose weights ``experts`` holds ((we_g,) we_u,
    we_o, their first dim the experts'); the rest of the padded experts'
    copies take no part.  e0 0 with every expert is the whole layer."""
    moe = cfg.moe
    B, S, D = y.shape
    T = B * S
    E, K = cfg.padded_experts, moe.top_k
    C = _capacity(moe, T)
    El = experts[-1].shape[0]
    dev = y.device

    gates, idx, _ = _router(y, {"router": router}, moe)

    flat_e = idx.reshape(T * K)                        # expert id per copy
    flat_g = gates.reshape(T * K)
    order = torch.argsort(flat_e, stable=True)         # copies by expert, in token order
    sorted_e = flat_e[order]
    seg_start = torch.searchsorted(sorted_e, torch.arange(E, device=dev))
    pos = torch.arange(T * K, device=dev) - seg_start[sorted_e]  # rank within expert
    dest = torch.where(pos < C, sorted_e * C + pos, E * C)       # E*C: dropped

    # (E*C,) source token of each slot, T for an empty one (a zero row); the
    # dropped copies all land in the extra slot E*C, which is cut off
    buf_tok = torch.full((E * C + 1,), T, dtype=torch.long, device=dev)
    buf_tok[dest] = order // K
    buf_gate = torch.zeros((E * C + 1,), dtype=flat_g.dtype, device=dev)
    buf_gate[dest] = flat_g[order]
    buf_tok, buf_gate = buf_tok[e0 * C:(e0 + El) * C], buf_gate[e0 * C:(e0 + El) * C]

    y_pad = torch.cat([y.reshape(T, D), y.new_zeros(1, D)])
    xg = constrain(y_pad[buf_tok].reshape(El, C, D), "experts", "capacity", "embed")
    if len(experts) == 3:
        we_g, we_u, we_o = experts
        g = torch.bmm(xg, we_g)
    else:
        (we_u, we_o), g = experts, None
    u = torch.bmm(xg, we_u)
    h = constrain(_act(cfg.mlp_kind, g, u), "experts", "capacity", "expert_ffn")
    eo = torch.bmm(h, we_o).reshape(El * C, D)
    eo = eo * buf_gate[:, None].to(eo.dtype)

    # the combine: each copy's slot here (El*C, a zero row, where it was
    # dropped or another rank's expert took it), then each token's K copies
    # added in ascending expert order, from zero
    slot = torch.empty_like(dest)
    slot[order] = dest - e0 * C
    slot = torch.where((slot >= 0) & (slot < El * C), slot, El * C).reshape(T, K)
    slot = torch.gather(slot, 1, torch.argsort(idx.reshape(T, K), dim=1))
    eo = torch.cat([eo, eo.new_zeros(1, D)])
    out = torch.zeros((T, D), dtype=eo.dtype, device=dev)
    for k in range(K):
        out = out + eo[slot[:, k]]
    return out.reshape(B, S, D)


def moe_block_dense_reference(p, x, *, cfg):
    """O(E) dense oracle: every expert on every token, no capacity (tests only)."""
    moe = cfg.moe
    y = rms_norm(x, p["ln2"])
    gates, idx, _ = _router(y, p, moe)
    u = torch.einsum("bsd,edf->bsef", y, p["we_u"])
    g = torch.einsum("bsd,edf->bsef", y, p["we_g"]) if "we_g" in p else None
    h = _act(cfg.mlp_kind, g, u)
    eo = torch.einsum("bsef,efd->bsed", h, p["we_o"])
    onehot = torch.nn.functional.one_hot(idx, p["we_o"].shape[0]).to(eo.dtype)  # (B,S,k,E)
    w = torch.einsum("bske,bsk->bse", onehot, gates.to(eo.dtype))
    out = torch.einsum("bsed,bse->bsd", eo, w)
    return x + _shared(p, y, cfg, out)

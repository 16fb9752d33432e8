"""AdamW with f32 master weights, global-norm clipping and a cosine schedule
(``repro.optim.adamw`` twin).

Train state is a plain dict tree, the JAX package's:
  {"params": compute params (bf16 on the card), "master"/"mu"/"nu": f32,
   "step": int32 scalar tensor}
so that a checkpoint of either package restores in the other
(``repro_torch.checkpoint``).  ``torch.optim.AdamW`` keeps another state and
is not used.

The update works in place: master, mu and nu are updated where they lie
and the params are recast into their own storage (at qwen3-1.7b's full width
the f32 state alone is 20.6 GB, so no second copy of it is made); the
returned state is the same dict, its leaves updated.  The arithmetic is the
JAX package's, leaf by leaf.

ZeRO-1: optimizer leaves get one extra data-parallel partition on the first
dimension that is unsharded and divisible by the DP world size
(``train_state_specs``).  On DTensor state the update redistributes each
gradient (a partial sum over the data axes) to its master's placements, a
reduce-scatter, updates the shards, and redistributes the new bf16 params
back to theirs, an all-gather.
"""
from __future__ import annotations

import math

import torch

from torch.distributed.tensor import DTensor

from repro_torch.sharding import mesh_axes
from repro_torch.tree import is_spec, leaves, map_tree, unflatten


def _whole(x):
    """A DTensor's value as every rank holds it whole; a tensor as it is."""
    return x.full_tensor() if isinstance(x, DTensor) else x


def global_norm(tree):
    """sqrt of the sum of squares of every leaf, in f32 (of a sharded leaf,
    all its shards')."""
    return torch.sqrt(torch.stack([_whole(torch.sum(torch.square(x.float())))
                                   for x in leaves(tree)]).sum())


def _like(g, m):
    """g redistributed to m's placements when both are DTensors."""
    if isinstance(g, DTensor) and tuple(g.placements) != tuple(m.placements):
        return g.redistribute(m.device_mesh, m.placements)
    return g


def cosine_schedule(base_lr, warmup, total):
    """lr(step): linear warm-up to ``base_lr`` over ``warmup`` steps, then a
    cosine decay to 0 at ``total``.  ``step`` is a tensor; the lr is f32."""
    def lr(step):
        step = step.float()
        warm = base_lr * step / max(warmup, 1)
        frac = torch.clamp((step - warmup) / max(total - warmup, 1), 0.0, 1.0)
        cos = 0.5 * base_lr * (1.0 + torch.cos(math.pi * frac))
        return torch.where(step < warmup, warm, cos)
    return lr


def adamw_init(params):
    return {"master": map_tree(lambda x: x.detach().float().clone(), params),
            "mu": map_tree(lambda x: torch.zeros(x.shape, dtype=torch.float32,
                                                 device=x.device), params),
            "nu": map_tree(lambda x: torch.zeros(x.shape, dtype=torch.float32,
                                                 device=x.device), params)}


def init_train_state(params):
    st = adamw_init(params)
    st["params"] = params
    st["step"] = torch.zeros((), dtype=torch.int32, device=leaves(params)[0].device)
    return st


@torch.no_grad()
def adamw_update(state, grads, *, lr, b1=0.9, b2=0.95, eps=1e-8, weight_decay=0.1, clip=1.0):
    """One AdamW step from ``grads`` (a tree like the params, or their leaves
    in jax's order).  Clips by the global norm before the moments, corrects
    the bias on the incremented step, and decays every leaf's f32 master
    (decoupled).  Updates ``state`` in place and returns
    (state, {"grad_norm": norm before clipping})."""
    step = state["step"] + 1
    grads = [_like(g, m) for g, m in zip(leaves(grads), leaves(state["master"]), strict=True)]
    gnorm = global_norm(grads)
    scale = torch.clamp(clip / torch.clamp(gnorm, min=1e-12), max=1.0)
    lr_t = lr(step) if callable(lr) else lr
    t = step.float()
    bc1, bc2 = 1 - b1 ** t, 1 - b2 ** t
    for m, mu, nu, g, p in zip(leaves(state["master"]), leaves(state["mu"]),
                               leaves(state["nu"]), grads, leaves(state["params"]),
                               strict=True):
        g = g.float() * scale
        mu.mul_(b1).add_((1 - b1) * g)
        nu.mul_(b2).add_((1 - b2) * g * g)
        upd = (mu / bc1) / (torch.sqrt(nu / bc2) + eps) + weight_decay * m
        m.sub_(lr_t * upd)
        # a sharded master is cast first: the all-gather carries bf16
        p.copy_(_like(m.to(p.dtype), p) if isinstance(m, DTensor) else m)
    state["step"] = step
    return state, {"grad_norm": gnorm}


# ---------------------------------------------------------------------------
# sharding specs
# ---------------------------------------------------------------------------

def _zero1(spec, shape, dp_axes, mesh):
    """Add a DP partition on the first unsharded, divisible dim."""
    if dp_axes is None:
        return spec
    sizes = mesh_axes(mesh)
    dp_size = 1
    for a in dp_axes:
        dp_size *= sizes[a]
    parts = list(spec) + [None] * (len(shape) - len(spec))
    for i, (p, s) in enumerate(zip(parts, shape)):
        if p is None and s % dp_size == 0 and s > 0:
            parts[i] = dp_axes if len(dp_axes) > 1 else dp_axes[0]
            return tuple(parts)
    return spec


def train_state_specs(param_spec_tree, abstract_param_tree, mesh, rules):
    """Specs of the whole train state: the params' own, and ZeRO-1's for
    master, mu and nu."""
    dp = rules.get("batch")
    dp_axes = (dp,) if isinstance(dp, str) else dp
    opt_spec = unflatten(param_spec_tree, [
        _zero1(spec, a.shape, dp_axes, mesh)
        for spec, a in zip(leaves(param_spec_tree, is_spec), leaves(abstract_param_tree),
                           strict=True)], is_spec)
    return {"params": param_spec_tree, "master": opt_spec, "mu": opt_spec, "nu": opt_spec,
            "step": ()}

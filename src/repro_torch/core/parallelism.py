"""Per-job hybrid-parallelism plans (DP / TP / PP / EP traffic model).

The paper's Table I derives network sensitivity from one pattern only — a
data-parallel ring all-reduce of the full gradient.  Real datacenter mixes
(Hu et al., arXiv:2109.01313) run hybrid plans whose collectives stress the
shared fabric very differently:

* **DP** gradients: ring all-reduce of the model shard, once per iteration —
  bandwidth-heavy, sensitive to the worst tier the replicas span.
* **TP** activations: all-gather + reduce-scatter inside every layer — only
  viable at the innermost tier; a TP group forced across machines pays the
  full activation volume at the worst tier (catastrophic).
* **PP** activations: point-to-point sends across stage boundaries — small
  volume, no ring, a single hop: pipeline stages *tolerate* cross-rack
  placement (the one pattern that does).
* **EP** expert dispatch: all-to-all of routed tokens in every MoE layer —
  hyper-sensitive to cross-rack placement (per-hop latency scales with the
  group size and the token volume does not reduce).

A :class:`ParallelPlan` is pure data: the four degrees plus per-iteration
byte volumes, derivable from the architecture configs (``plan_for``) and
optionally calibrated against the compiled dry-run's collective-bytes-by-
group-size breakdown (``launch/hlo_analysis``).  ``CommModel.plan_time``
composes the per-pattern costs; a *degenerate* plan (dp=n, tp=pp=ep=1)
routes through the exact pure-DP code path, bit-for-bit.
"""
from __future__ import annotations

from dataclasses import dataclass
from functools import lru_cache
from typing import Optional, Tuple

GRAD_DTYPE_BYTES = 2  # bf16 gradients, matching CommModel's default


@dataclass(frozen=True)
class ParallelPlan:
    """Degrees and per-iteration byte volumes of one job's parallelism.

    ``dp * tp * pp * ep`` equals the job's GPU count.  Byte volumes are
    per-iteration totals: ``grad_bytes`` is the gradient shard each DP
    replica ring-all-reduces, ``tp_bytes`` the activation volume each TP
    rank all-gathers (and reduce-scatters) across all layers, ``pp_bytes``
    the activation volume crossing one pipeline-stage boundary (forward;
    the model doubles it for backward), and ``ep_bytes`` the routed-token
    volume each EP rank exchanges all-to-all across all MoE layers.
    ``model_grad_bytes`` is the FULL model's gradient volume — what a
    degenerate pure-DP plan would all-reduce — used to normalize the
    plan's fabric footprint against the pure-DP reference.
    """
    dp: int = 1
    tp: int = 1
    pp: int = 1
    ep: int = 1
    grad_bytes: float = 0.0
    tp_bytes: float = 0.0
    pp_bytes: float = 0.0
    ep_bytes: float = 0.0
    model_grad_bytes: float = 0.0
    n_buckets: int = 1  # gradient/activation buckets (≈ layers): latency term

    @property
    def n_gpus(self) -> int:
        return self.dp * self.tp * self.pp * self.ep

    @property
    def is_pure_dp(self) -> bool:
        """True when the plan degenerates to today's single-pattern model."""
        return self.tp == 1 and self.pp == 1 and self.ep == 1

    # -- traffic decomposition ------------------------------------------
    def internode_components(self) -> Tuple[float, float, float]:
        """(dp, ep, pp) per-iteration byte volumes that cross the worst
        tier when the plan's outer dimensions span it.  TP is absent: it
        is pinned to the innermost tier by construction (when it spills,
        ``CommModel.plan_time`` charges it; the *preference* model here
        assumes the scheduler never wants that)."""
        dp_x = (2.0 * (self.dp - 1) / self.dp * self.grad_bytes
                if self.dp > 1 else 0.0)
        ep_x = (2.0 * (self.ep - 1) / self.ep * self.ep_bytes
                if self.ep > 1 else 0.0)
        pp_x = 2.0 * self.pp_bytes if self.pp > 1 else 0.0
        return dp_x, ep_x, pp_x

    @property
    def fabric_weight(self) -> float:
        """Relative shared-fabric footprint vs a pure-DP job of the same
        model (1.0).  Weights the plan's per-link usage in
        ``FairShareFabric``: a PP-heavy job barely loads the spine, an
        EP-heavy job hammers it."""
        if self.is_pure_dp or self.model_grad_bytes <= 0.0:
            return 1.0
        ref = 2.0 * self.model_grad_bytes  # pure-DP ring volume (n >> 1)
        w = sum(self.internode_components()) / ref
        return min(max(w, 0.05), 4.0)

    @lru_cache(maxsize=None)
    def delay_scales(self) -> Tuple[float, float]:
        """(machine_scale, rack_scale): multipliers for Dally's delay
        timers — how much each consolidation tier is worth waiting for,
        given the plan's traffic mix.  Pure DP = (1.0, 1.0), today's
        behaviour exactly.  Memoized (the plan is frozen and the offer
        pass queries it once per waiting job per round): lru_cache keyed
        on the hashable plan keeps equal plans deduped too.

        The machine scale weighs everything that profits from intra-
        machine bandwidth: TP activations (which *spill* to the worst
        tier if the group leaves the machine), DP gradients, and EP
        all-to-all (double-weighted: hyper-sensitive).  The rack scale
        weighs only the outer patterns — TP is pinned inside a machine
        either way — so a PP-dominated job scores → 0.0 (pipeline stages
        tolerate cross-rack placement: take the offer, yield the
        rack-local slots) while an EP-dominated job scores → 2.0 (hold
        out for consolidation)."""
        dp_x, ep_x, pp_x = self.internode_components()
        tp_x = (2.0 * (self.tp - 1) / self.tp * self.tp_bytes
                if self.tp > 1 else 0.0)
        total = dp_x + ep_x + pp_x + tp_x
        if total <= 0.0:
            return 0.0, 0.0  # no cross-GPU traffic: nothing to wait for
        machine = (dp_x + 2.0 * ep_x + tp_x) / total
        outer = dp_x + ep_x + pp_x
        rack = (dp_x + 2.0 * ep_x) / outer if outer > 0.0 else 0.0
        return machine, rack


def pure_dp_plan(n_gpus: int, model_grad_bytes: float = 0.0,
                 n_buckets: int = 1) -> ParallelPlan:
    """The degenerate plan: all GPUs data-parallel, one gradient ring."""
    return ParallelPlan(dp=n_gpus, grad_bytes=model_grad_bytes,
                        model_grad_bytes=model_grad_bytes,
                        n_buckets=n_buckets)


def _pow2_at_most(n: int) -> int:
    p = 1
    while p * 2 <= n:
        p *= 2
    return p


def plan_for(cfg, n_gpus: int, tokens_per_gpu_iter: int = 1024,
             gpus_per_machine: int = 8,
             grad_dtype_bytes: int = GRAD_DTYPE_BYTES,
             large_params: float = 8e9,
             max_ep: int = 16) -> Optional[ParallelPlan]:
    """Derive a plan from an architecture config and GPU count.

    Deterministic in (cfg, n_gpus, tokens_per_gpu_iter): trace generation
    stays seed-reproducible.  Assignment mirrors the datacenter mixes of
    Hu et al. (arXiv:2109.01313):

    * MoE configs with ≥ 4 GPUs → expert parallelism (all-to-all) over up
      to ``max_ep`` ranks, data parallelism outside it.
    * Large dense configs (> ``large_params``) with ≥ 8 GPUs → tensor
      parallelism up to one machine; ≥ 16 GPUs adds pipeline stages.
    * Everything else — the small-job bulk AND any non-power-of-two
      demand (whose degrees could not multiply back to ``n_gpus``) —
      → ``None``: pure DP, the exact legacy code path.
    """
    g = n_gpus
    if g < 4 or g & (g - 1):
        return None
    full_grad = float(cfg.n_params()) * grad_dtype_bytes
    layers = max(cfg.n_layers, 1)
    tokens_total = float(tokens_per_gpu_iter) * g
    act = float(cfg.d_model) * grad_dtype_bytes  # bytes per token activation

    if cfg.moe is not None:
        ep = min(_pow2_at_most(g), _pow2_at_most(cfg.moe.n_experts), max_ep)
        if ep <= 1:
            return None
        dp = max(g // ep, 1)
        tokens_rep = tokens_total / dp
        n_moe_layers = sum(1 for k in cfg.layer_kinds()
                           if k not in ("rwkv",))  # MoE rides the mlp slot
        ep_bytes = (tokens_rep * cfg.moe.top_k * act
                    * cfg.moe.capacity_factor * n_moe_layers / ep)
        return ParallelPlan(
            dp=dp, ep=ep,
            grad_bytes=full_grad / ep,
            ep_bytes=ep_bytes,
            model_grad_bytes=full_grad,
            n_buckets=layers)

    if full_grad >= large_params * grad_dtype_bytes and g >= 8:
        # both factors must be powers of two or the degrees cannot
        # multiply back to g (6-GPU machines would yield tp=6, rest=g//6)
        tp = min(_pow2_at_most(g), _pow2_at_most(gpus_per_machine))
        rest = g // tp
        pp = min(_pow2_at_most(rest), 4) if rest >= 2 and g >= 16 else 1
        dp = max(rest // pp, 1)
        tokens_rep = tokens_total / max(dp, 1)
        tp_bytes = tokens_rep * act * layers
        pp_bytes = tokens_rep * act if pp > 1 else 0.0
        return ParallelPlan(
            dp=dp, tp=tp, pp=pp,
            grad_bytes=full_grad / (tp * pp),
            tp_bytes=tp_bytes,
            pp_bytes=pp_bytes,
            model_grad_bytes=full_grad,
            n_buckets=layers)

    return None

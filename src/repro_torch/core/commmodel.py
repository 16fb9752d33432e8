"""Per-placement communication latency model (the ASTRA-sim analogue).

For a data-parallel job the per-iteration exposed communication time is a
hierarchical ring all-reduce of the model's gradient bytes over the worst
network tier the placement spans, minus the compute it overlaps with:

  T_ar(tier) = 2(n-1)/n * M / bw(tier) + 2(n-1) * alpha(tier) * n_buckets
  hierarchical: intra-machine stage at machine bw + inter-node stage at tier bw
  exposed = max(0, T_comm - overlap_frac * T_compute)

M (gradient bytes) and n_buckets (layers) come from the real architecture
configs; an optional calibration factor per arch is derived from the compiled
dry-run artifacts (measured collective bytes / analytic bytes), mirroring the
paper's <1% calibration of ASTRA-sim workload files against real runs.

Jobs carrying a hybrid :class:`~repro_torch.core.parallelism.ParallelPlan` are
priced by ``plan_time`` instead: a composition of per-pattern collective
costs — DP gradient ring, TP all-gather/reduce-scatter pinned to the
innermost tier, point-to-point pipeline-stage activations (tolerant of the
worst tier), and MoE expert all-to-all (hyper-sensitive to it).  A
degenerate plan (dp=n, tp=pp=ep=1) routes through the exact pure-DP path,
bit-for-bit, so plan-less workloads reproduce the legacy numbers.
"""
from __future__ import annotations

import json
import pathlib
from typing import Dict, Optional

from repro_torch.types import NVIDIA_PAPER, HardwareProfile

from .parallelism import ParallelPlan
from .topology import Placement


class CommModel:
    def __init__(self, arch_table: Dict[str, dict],
                 profile: HardwareProfile = NVIDIA_PAPER,
                 overlap_frac: float = 0.25,
                 grad_dtype_bytes: int = 2,
                 calibration: Optional[Dict[str, float]] = None,
                 cache_size: int = 1 << 16):
        """arch_table: name -> {"params": N, "layers": L} (+ optional extras).

        cache_size: max entries for the all-reduce memo cache (0 disables).
        The latency only depends on a placement's *shape* — (tier, total
        GPUs, machine count, max GPUs on one machine) — not on which
        machines were picked, so large sweeps hit a few hundred distinct
        keys per model while querying millions of placements.
        """
        self.arch_table = arch_table
        self.profile = profile
        self.overlap_frac = overlap_frac
        self.grad_dtype_bytes = grad_dtype_bytes
        self.calibration = calibration or {}
        self.cache_size = cache_size
        self._ar_cache: Dict[tuple, float] = {}
        self.cache_hits = 0
        self.cache_misses = 0

    # -- construction helpers -------------------------------------------
    @classmethod
    def from_configs(cls, configs, **kw):
        table = {}
        for cfg in configs:
            # gradients synchronize ALL parameters (an MoE job must all-reduce
            # every expert even though compute touches only top-k — this is
            # precisely what makes per-model network sensitivity diverge,
            # the paper's Table I phenomenon)
            table[cfg.name] = {"params": cfg.n_params(),
                               "layers": cfg.n_layers}
        return cls(table, **kw)

    def load_calibration(self, artifact_dir: str, shape: str = "train_4k",
                         mesh: str = "pod16x16"):
        """Calibrate per-arch gradient volume against the compiled dry-run:
        factor = measured collective bytes / analytic ring all-reduce bytes.
        Mirrors ArtISt-sim's calibration of ASTRA-sim workload files.  Reads
        the records of ``repro_torch.launch.dryrun`` (their ``ops`` hold the
        collective bytes a rank moves)."""
        d = pathlib.Path(artifact_dir)
        for name in self.arch_table:
            f = d / f"{name}__{shape}__{mesh}.json"
            if not f.exists():
                continue
            rec = json.loads(f.read_text())
            if rec.get("status") != "ok":
                continue
            measured = rec["ops"]["collective_bytes"]
            grad = self.arch_table[name]["params"] * self.grad_dtype_bytes
            if grad > 0 and measured > 0:
                # per-device measured vs 2M/n analytic per device
                n = rec.get("n_chips", 256)
                analytic = 2.0 * grad / n
                self.calibration[name] = min(max(measured / analytic, 0.1),
                                             50.0)
        self._ar_cache.clear()  # calibration changes the cached latencies

    # -- core latency model ---------------------------------------------
    def _ring(self, bytes_, n, tier_name, n_buckets, bw_override=None):
        if n <= 1:
            return 0.0
        t = self.profile.tier(tier_name)
        bw = t.bandwidth if bw_override is None else bw_override
        bw_time = 2.0 * (n - 1) / n * bytes_ / bw
        lat_time = 2.0 * (n - 1) * t.latency * n_buckets
        return bw_time + lat_time

    def _allgather(self, bytes_, n, tier_name, n_buckets, bw_override=None):
        """All-gather (== reduce-scatter) of ``bytes_`` over n ranks: one
        ring pass instead of the all-reduce's two."""
        if n <= 1:
            return 0.0
        t = self.profile.tier(tier_name)
        bw = t.bandwidth if bw_override is None else bw_override
        return (n - 1) / n * bytes_ / bw + (n - 1) * t.latency * n_buckets

    def _alltoall(self, bytes_, n, tier_name, n_buckets, bw_override=None):
        """All-to-all of ``bytes_`` per rank over n ranks.  Per byte it
        prices like one all-gather pass — (n-1) message rounds moving
        (n-1)/n of the payload.  What makes expert dispatch hyper-sensitive
        in aggregate is not the per-byte constant but that the routed-token
        volume is charged per MoE layer, never reduces like a gradient
        ring, and runs at whatever tier the expert group spans."""
        return self._allgather(bytes_, n, tier_name, n_buckets, bw_override)

    def _p2p(self, bytes_, tier_name, bw_override=None):
        """One point-to-point transfer (a pipeline-stage boundary): a
        single hop, no ring — the pattern that tolerates any tier."""
        t = self.profile.tier(tier_name)
        bw = t.bandwidth if bw_override is None else bw_override
        return bytes_ / bw + t.latency

    def allreduce_time(self, model: str, placement: Placement,
                       machines_per_rack: int,
                       gpus_per_machine: int,
                       internode_bw: Optional[float] = None) -> float:
        """Hierarchical all-reduce time for one iteration's gradients.

        ``internode_bw`` overrides the inter-node stage's bandwidth (the
        shared-fabric fair share of a contended placement); per-hop
        latency and the intra-machine stage are unaffected.
        """
        tier = placement.tier(machines_per_rack)
        n_machines = len(placement.alloc)
        n_gpus = placement.n_gpus
        max_local = max(c for _, c in placement.alloc)
        key = (model, tier, n_gpus, n_machines, max_local, internode_bw)
        if self.cache_size:
            hit = self._ar_cache.get(key)
            if hit is not None:
                self.cache_hits += 1
                return hit
            self.cache_misses += 1

        info = self.arch_table[model]
        M = info["params"] * self.grad_dtype_bytes
        M *= self.calibration.get(model, 1.0)
        L = max(info["layers"], 1)

        if tier == "machine":
            t = self._ring(M, n_gpus, "machine", L)
        else:
            # stage 1: reduce within each machine (max gpus on one machine)
            t = self._ring(M, max_local, "machine", L)
            # stage 2: ring across machine leaders at the bottleneck tier
            t += self._ring(M, n_machines, tier, L,
                            bw_override=internode_bw)
        if self.cache_size:
            while len(self._ar_cache) >= self.cache_size:
                # bounded FIFO eviction (dicts preserve insertion order):
                # dropping only the oldest entry keeps the hot keys of a
                # long sweep cached instead of cold-starting everything
                self._ar_cache.pop(next(iter(self._ar_cache)))
            self._ar_cache[key] = t
        return t

    def plan_time(self, model: str, plan: Optional[ParallelPlan],
                  placement: Placement, machines_per_rack: int,
                  gpus_per_machine: int,
                  internode_bw: Optional[float] = None) -> float:
        """Per-iteration communication time of a hybrid-parallel job:
        the sum of its plan's per-pattern collective costs on this
        placement.  ``plan=None`` and degenerate (pure-DP) plans route
        through :meth:`allreduce_time` — the exact legacy path, so
        plan-less workloads stay bit-for-bit reproducible.
        """
        if plan is None or plan.is_pure_dp:
            return self.allreduce_time(model, placement, machines_per_rack,
                                       gpus_per_machine,
                                       internode_bw=internode_bw)
        tier = placement.tier(machines_per_rack)
        n_machines = len(placement.alloc)
        max_local = max(c for _, c in placement.alloc)
        # group residency: an inner group of `size` ranks stays on one
        # machine only if EVERY machine chunk is a whole number of groups
        # (checking just the largest chunk would let one whole machine
        # hide a genuinely split group on a fragmented placement)
        tp_resident = (plan.tp == 1 or
                       all(c % plan.tp == 0 for _, c in placement.alloc))
        ep_size = plan.ep * plan.tp
        ep_resident = (plan.ep == 1 or
                       all(c % ep_size == 0 for _, c in placement.alloc))
        key = (model, tier, placement.n_gpus, n_machines, max_local,
               tp_resident, ep_resident, internode_bw, plan)
        if self.cache_size:
            hit = self._ar_cache.get(key)
            if hit is not None:
                self.cache_hits += 1
                return hit
            self.cache_misses += 1

        cal = self.calibration.get(model, 1.0)
        L = max(plan.n_buckets, 1)
        # the fair-share override prices only inter-node (cross-machine)
        # stages; intra-machine stages always run at the machine tier rate
        inter_bw = internode_bw if tier != "machine" else None
        t = 0.0
        # TP all-gather + reduce-scatter, pinned to the innermost tier; a
        # TP group not wholly machine-resident spills to the placement's
        # worst tier and pays the full activation volume there
        if plan.tp > 1:
            if tp_resident:
                t += 2.0 * self._allgather(plan.tp_bytes, plan.tp,
                                           "machine", L)
            else:
                t += 2.0 * self._allgather(plan.tp_bytes, plan.tp, tier, L,
                                           bw_override=inter_bw)
        # DP gradient ring over the replicas, hierarchical like the pure
        # path: replicas co-resident on one machine reduce at machine
        # bandwidth first, then the leaders ring at the placement tier.
        # A replica's physical footprint is tp*pp*ep GPUs — a replica
        # wider than one machine makes the whole DP ring inter-node
        # traffic (and therefore subject to the fair-share override).
        if plan.dp > 1:
            grad = plan.grad_bytes * cal
            if tier == "machine":
                t += self._ring(grad, plan.dp, "machine", L)
            else:
                replica = plan.tp * plan.pp * plan.ep
                intra = min(plan.dp, max(max_local // replica, 1))
                t += self._ring(grad, intra, "machine", L)
                inter = -(-plan.dp // intra)
                if inter > 1:
                    t += self._ring(grad, inter, tier, L,
                                    bw_override=inter_bw)
        # PP stage-boundary activations: forward + backward point-to-point
        # sends at the worst tier — small volume, one hop, tolerant
        if plan.pp > 1:
            t += (plan.pp - 1) * 2.0 * self._p2p(
                plan.pp_bytes, tier, bw_override=inter_bw)
        # EP expert dispatch + combine: all-to-all at the tier the expert
        # group spans — the pattern that punishes cross-rack placement.
        # The group's footprint includes the inner TP dimension: ep ranks
        # stride across tp-sized cells.
        if plan.ep > 1:
            ep_tier = "machine" if ep_resident else tier
            t += 2.0 * self._alltoall(
                plan.ep_bytes, plan.ep, ep_tier, L,
                bw_override=inter_bw if ep_tier == tier else None)
        if self.cache_size:
            while len(self._ar_cache) >= self.cache_size:
                self._ar_cache.pop(next(iter(self._ar_cache)))
            self._ar_cache[key] = t
        return t

    def iteration_time(self, model: str, compute_time: float,
                       placement: Placement, machines_per_rack: int,
                       gpus_per_machine: int,
                       internode_bw: Optional[float] = None,
                       plan: Optional[ParallelPlan] = None):
        """Returns (iter_time, exposed_comm_per_iter)."""
        t_comm = self.plan_time(model, plan, placement, machines_per_rack,
                                gpus_per_machine,
                                internode_bw=internode_bw)
        exposed = max(0.0, t_comm - self.overlap_frac * compute_time)
        return compute_time + exposed, exposed

    def sensitivity_pct(self, model: str, compute_time: float, g: int,
                        machines_per_rack: int = 8,
                        gpus_per_machine: int = 8) -> Dict[str, float]:
        """Table-I analogue: comm latency as % of compute per tier."""
        out = {}
        for tier in ("machine", "rack", "network"):
            pl = self._canonical_placement(g, tier, machines_per_rack,
                                           gpus_per_machine)
            t = self.allreduce_time(model, pl, machines_per_rack,
                                    gpus_per_machine)
            out[tier] = 100.0 * t / max(compute_time, 1e-12)
        return out

    @staticmethod
    def _canonical_placement(g, tier, machines_per_rack, gpus_per_machine):
        if tier == "machine" or g <= 1:
            # a single GPU does no all-reduce at any tier; the rack/network
            # splits below would emit a zero-GPU machine entry ((1, 0)) that
            # counts as a second ring participant and skews sensitivity_pct
            return Placement(((0, g),))
        if tier == "rack":
            per = max(1, g // 2)
            return Placement(((0, per), (1, g - per)))
        return Placement(((0, max(1, g // 2)),
                          (machines_per_rack, g - max(1, g // 2))))

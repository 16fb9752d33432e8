"""Gandiva baseline (Xiao et al., OSDI'18) as reproduced in the paper.

Network-agnostic: jobs accept whatever GPUs are free (no consolidation
preference, FIFO priority).  Its introspective *migration* is modelled per
the paper's description: whenever resources free up, running jobs are
opportunistically migrated to a better consolidation tier (at a restart
cost).
"""
from __future__ import annotations

from .base import Policy


class GandivaPolicy(Policy):
    name = "gandiva"
    preemption_enabled = False  # Gandiva packs/migrates; no priority eviction

    def __init__(self, migrate: bool = True):
        self.migrate = migrate

    def priority(self, job, now):
        return job.arrival  # FIFO

    def on_offer(self, job, sim, now):
        # network-agnostic: take whatever fragments are free, as-is
        return "scatter" if sim.cluster.free_gpus() >= job.n_gpus else None

    def on_round(self, sim, now):
        if not self.migrate:
            return
        # NB: under a shared fabric (endogenous contention) migrations also
        # change the contending set; the simulator re-prices every affected
        # running job after the round
        # migrate at most one job per round to a strictly better tier;
        # sim.upgrade_level is a pure index query (would the job fit better
        # right now, counting its own GPUs as free?), and machine-tier jobs
        # can never upgrade, so only the scattered minority is scanned
        order = {"machine": 0, "rack": 1, "network": 2}
        # With zero free GPUs no scattered job can upgrade: a rack- or
        # network-tier placement spans >= 2 machines (so each machine's
        # own-share contribution is < n_gpus) and a network placement
        # spans >= 2 racks, so every upgrade probe needs at least one
        # free GPU somewhere to beat the current tier.  Skipping the
        # probes is decision-identical — they would all return None.
        if sim.cluster.free_gpus() == 0:
            return
        best = None
        for job in sim.running_scattered:
            target = sim.upgrade_level(job)
            if target is not None and (best is None
                                       or order[target] < order[best[1]]):
                best = (job, target)
        if best is not None:
            sim.migrate(best[0], best[1], now)


class ScatterPolicy(GandivaPolicy):
    """Pure network-agnostic scatter: Gandiva minus its introspective
    migration.  Placements take whatever fragments are free and never
    improve — the baseline that endogenous shared-fabric contention
    punishes hardest (scattered cross-rack jobs fair-share the spine and
    throttle each other), and the foil for the paper's "under congested
    networking conditions" headline claims."""
    name = "scatter"

    def __init__(self):
        super().__init__(migrate=False)

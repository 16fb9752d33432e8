"""Dally ablations used as baselines in the paper (§V-C).

All keep Dally's Nw_sens preemption; only the delay-timer source differs.
"""
from __future__ import annotations

from .dally import DallyPolicy

_INF = float("inf")


class DallyManualPolicy(DallyPolicy):
    """Hand-set fixed timers (the YARN-style configuration): 12h machine-level
    + another 12h rack-level (24h total), never adapted."""
    name = "dally-manual"

    def __init__(self, machine_timer: float = 12 * 3600.0,
                 rack_timer: float = 12 * 3600.0):
        super().__init__()
        self._fixed = (machine_timer, rack_timer)

    def _timers(self, job, sim, now):
        t_mc, t_rk = self._fixed
        if job.n_gpus > sim.cluster.gpus_per_machine:
            t_mc = 0.0
        if job.n_gpus > sim.cluster.max_rack_capacity:
            t_rk = 0.0
        # fixed timers never age and have no tuner dependency: offer
        # holds stay valid until the live capacity checks unblock or
        # starvation crosses the fixed timer
        return t_mc, t_rk, (_INF, None), (_INF, None)

    def record_acceptance(self, job, tier, now):
        return  # no tuning


class DallyNoWaitPolicy(DallyManualPolicy):
    """Timers = 0: accept whatever consolidation is available right now."""
    name = "dally-nowait"

    def __init__(self):
        super().__init__(machine_timer=0.0, rack_timer=0.0)


class DallyFullyConsolidatedPolicy(DallyManualPolicy):
    """Waits as long as needed for the most consolidated placement that can
    ever fit the job (machine if g <= 8, else rack, else network)."""
    name = "dally-fullyconsolidated"

    def __init__(self):
        super().__init__(machine_timer=_INF, rack_timer=_INF)


class DallyPatternBlindPolicy(DallyPolicy):
    """Full Dally (auto-tuned timers, Nw_sens preemption, upgrades) minus
    the pattern-aware tier preference: every job's delay timers are priced
    as if it ran a pure-DP gradient ring, regardless of its parallelism
    plan.  The A/B foil for fig13: on hybrid-parallelism workloads this is
    "pattern-blind consolidation" — EP jobs stop out-waiting PP jobs for
    the rack-local slots.  Identical to ``dally`` on plan-less traces."""
    name = "dally-blind"

    def _plan_timer_scales(self, job):
        return (1.0, 1.0)

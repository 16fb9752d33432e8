"""Tiresias baseline (Gu et al., NSDI'19) as reproduced in the paper.

* Priority: Discretized 2D-LAS (2DAS = t_run * n_gpus) — MLFQ with K levels;
  lower attained service = higher priority, FIFO within a level.
* Placement: skew-based consolidation.  High-skew models (largest tensor /
  model size above a threshold) demand the fewest machines possible
  (machine-level if the job fits one machine, else rack-level) and keep
  waiting otherwise; low-skew models accept any offer.
"""
from __future__ import annotations

from ..job import DEFAULT_PRIORITY, PRIORITY_MULT, priority_mults_many, two_das_many
from .base import Policy

try:
    import numpy as _np
except ImportError:  # pragma: no cover - numpy ships with the toolchain
    _np = None


class TiresiasPolicy(Policy):
    name = "tiresias"
    # Tiresias preempts on MLFQ level changes only: a waiting job evicts a
    # running one only from a strictly lower queue (priority unit = 1e12)
    preemption_margin = 0.5e12

    def __init__(self, queue_thresholds=(3600.0 * 8, 3600.0 * 64),
                 skew_threshold: float = 0.15):
        self.queue_thresholds = queue_thresholds
        self.skew_threshold = skew_threshold

    def priority(self, job, now):
        das = job.two_das(now)
        if job.priority != DEFAULT_PRIORITY:
            # priority-class scaling on attained service: a low-priority
            # job looks like it already consumed more GPU-time (sinks to
            # deeper MLFQ levels sooner), a high-priority one less.  The
            # guard keeps default-class populations bit-identical.
            das *= PRIORITY_MULT[job.priority]
        level = 0
        for th in self.queue_thresholds:
            if das > th:
                level += 1
        # MLFQ: level first, then FIFO (arrival) within the level
        return level * 1e12 + job.arrival

    def priority_many(self, jobs, now):
        das = two_das_many(jobs, now)
        if das is None:
            return None
        mults = priority_mults_many(jobs)
        if mults is not None:
            # elementwise multiply matches the guarded scalar branch: a
            # default-class job's das * 1.0 is a bitwise no-op
            das = das * mults
        # level is a small exact integer (<= len(thresholds)), so the
        # float accumulation and level * 1e12 are exact, and the final
        # add matches the scalar int-level * 1e12 + arrival bit for bit
        level = _np.zeros(len(jobs), _np.float64)
        for th in self.queue_thresholds:
            level += das > th
        arrivals = _np.fromiter((j.arrival for j in jobs),
                                _np.float64, len(jobs))
        return level * 1e12 + arrivals

    def on_offer(self, job, sim, now):
        cl = sim.cluster
        g = job.n_gpus
        if job.skew >= self.skew_threshold:
            # stringent consolidation for skewed models
            if g <= cl.gpus_per_machine:
                if cl.max_free_on_machine() >= g:
                    return "machine"
                return None  # wait indefinitely for machine-level
            if g <= cl.max_rack_capacity:
                if cl.max_free_on_rack() >= g:
                    return "rack"
                return None
            return "network" if cl.free_gpus() >= g else None
        # low skew: accept any offer — i.e. whatever fragments are free
        # (Tiresias is consolidation-blind for non-skewed models; this is
        # exactly the paper's critique when skew mispredicts sensitivity)
        return "scatter" if cl.free_gpus() >= g else None

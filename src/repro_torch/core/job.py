"""Job model and priority metrics (paper §IV-B1).

Nw_sens = W_compl / T_norm, with
  W_compl = iters_done / total_iters
  T_norm  = t_run / (compute_time_per_iter * total_iters)
Low Nw_sens => the job suffered network-induced slowdowns => offer first.

2DAS (Tiresias) = t_run * n_gpus, discretized into MLFQ levels.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import List, Optional

from .parallelism import ParallelPlan
from .topology import Placement

try:  # optional: the batch scorers fall back to the scalar path without it
    import numpy as _np
except ImportError:  # pragma: no cover - numpy ships with the toolchain
    _np = None

# -- priority classes --------------------------------------------------------
# A job's priority class scales its policy priority VALUE (lower value =
# served first, so the multiplier is > 1 for low-priority jobs and < 1 for
# high-priority ones) and gates preemption: a waiting job may only evict
# running jobs of an equal-or-lower class.  The class index doubles as the
# eviction rank ("low" < "normal" < "high").  DEFAULT_PRIORITY keeps every
# pre-existing trace and v1 job spec decision-identical: the multiplier is
# only ever applied when a job's class differs from the default.
PRIORITY_CLASSES = ("low", "normal", "high")
PRIORITY_MULT = (4.0, 1.0, 0.25)
DEFAULT_PRIORITY = PRIORITY_CLASSES.index("normal")


@dataclass(eq=False)  # identity equality: O(1) list removal in the simulator
class Job:
    job_id: int
    model: str                   # arch name (network-sensitivity key)
    n_gpus: int
    total_iters: int
    compute_time_per_iter: float  # seconds, no communication (ideal)
    arrival: float = 0.0
    skew: float = 0.0            # largest tensor / model size (Tiresias)
    # hybrid-parallelism traffic plan; None = pure DP (the legacy path)
    plan: Optional[ParallelPlan] = None
    # multi-tenancy: None = the shared default tenant (kept None, not
    # materialized to a name, so single-tenant journals/artifacts keep
    # their legacy bytes); priority is an index into PRIORITY_CLASSES
    tenant: Optional[str] = None
    priority: int = DEFAULT_PRIORITY

    # dynamic state ------------------------------------------------------
    iters_done: int = 0
    t_run: float = 0.0           # total time spent in the run queue
    t_queue: float = 0.0         # total time spent waiting
    comm_time: float = 0.0       # exposed communication time accumulated
    placement: Optional[Placement] = None
    placement_tier: Optional[str] = None  # tier of `placement`, pinned at
    # placement time (placements are immutable, so recomputing it per
    # upgrade probe per round was pure waste at datacenter scale)
    iter_time: float = 0.0       # current per-iteration time (w/ comm)
    slow_factor: float = 1.0     # machine-slowdown factor of this placement
    degrade_factor: float = 1.0  # live straggler/throttling factor (max
    # over the placement's currently degraded machines; 1.0 = healthy)
    iters_frac: float = 0.0      # partial iteration carried across re-prices
    run_start: float = 0.0       # when the current run segment started
    # when the job last changed resource state: set to `now` at every
    # _start and at every preemption.  It anchors BOTH the starvation
    # clock (T_starvation, while waiting) AND preemption/upgrade
    # eligibility (while running) — unlike run_start it is never reset by
    # progress folds or fair-share re-pricing, so eligibility keeps
    # accruing for contended jobs.
    last_assignment_time: Optional[float] = None
    wait_since: float = 0.0      # when the job (re)entered the wait queue
    finish_time: Optional[float] = None
    preemptions: int = 0
    failures: int = 0            # placements lost to machine failures
    started_once: bool = False

    def remaining_iters(self) -> int:
        return max(self.total_iters - self.iters_done, 0)

    @property
    def ideal_runtime(self) -> float:
        return self.compute_time_per_iter * self.total_iters

    def _live(self, now: Optional[float]):
        """(t_run, iters_done) including the in-flight run segment."""
        t_run, iters = self.t_run, self.iters_done
        if (now is not None and self.placement is not None
                and now > self.run_start):
            el = now - self.run_start
            t_run += el
            iters = min(iters + int(el / max(self.iter_time, 1e-9)),
                        self.total_iters)
        return t_run, iters

    def nw_sens(self, now: Optional[float] = None) -> float:
        """Network-sensitive priority; lower = more starved = higher prio."""
        t_run, iters = self._live(now)
        if t_run <= 0.0:
            return 0.0  # never ran: maximally starved
        w_compl = iters / max(self.total_iters, 1)
        t_norm = t_run / max(self.ideal_runtime, 1e-9)
        return w_compl / max(t_norm, 1e-12)

    def two_das(self, now: Optional[float] = None) -> float:
        t_run, _ = self._live(now)
        return t_run * self.n_gpus

    def starvation(self, now: float) -> float:
        ref = self.last_assignment_time
        if ref is None:
            ref = self.arrival
        return max(now - ref, 0.0)


# -- vectorized batch scorers (simulator/policy hot loops) -------------------
# Bit-identical to the scalar methods above: every step is an elementwise
# IEEE-754 float64 operation (+, -, *, /, maximum, minimum, floor, where)
# applied in the same order as the scalar code, and numpy's elementwise
# float64 arithmetic matches CPython's float arithmetic operation for
# operation.  No reductions (numpy's pairwise sums would NOT match) —
# the differential tests pin the equality per element.


def _live_many(jobs: List[Job], now: float):
    """Batch twin of ``Job._live``: (t_run, iters_done) float64 arrays
    including the in-flight run segment, or None when numpy is missing."""
    if _np is None:
        return None
    n = len(jobs)
    t_run = _np.fromiter((j.t_run for j in jobs), _np.float64, n)
    iters = _np.fromiter((j.iters_done for j in jobs), _np.float64, n)
    run_start = _np.fromiter((j.run_start for j in jobs), _np.float64, n)
    iter_time = _np.fromiter((j.iter_time for j in jobs), _np.float64, n)
    total = _np.fromiter((j.total_iters for j in jobs), _np.float64, n)
    placed = _np.fromiter((j.placement is not None for j in jobs),
                          _np.bool_, n)
    # el == 0.0 where inactive: t_run + 0.0 and iters + 0.0 are exact
    # no-ops (t_run/iters are never -0.0), matching the scalar branch skip
    el = _np.where(placed & (now > run_start), now - run_start, 0.0)
    inc = _np.floor(el / _np.maximum(iter_time, 1e-9))
    # int counts stay far below 2**53 wherever min() doesn't clamp to
    # total_iters, so the float adds here are exact like the scalar ints
    return t_run + el, _np.minimum(iters + inc, total), total


def nw_sens_many(jobs: List[Job], now: float):
    """Batch ``Job.nw_sens``: a float64 array of bit-identical values, or
    None when numpy is unavailable."""
    live = _live_many(jobs, now)
    if live is None:
        return None
    t_run, iters, total = live
    n = len(jobs)
    ctpi = _np.fromiter((j.compute_time_per_iter for j in jobs),
                        _np.float64, n)
    w_compl = iters / _np.maximum(total, 1.0)
    t_norm = t_run / _np.maximum(ctpi * total, 1e-9)
    out = w_compl / _np.maximum(t_norm, 1e-12)
    return _np.where(t_run <= 0.0, 0.0, out)


def two_das_many(jobs: List[Job], now: float):
    """Batch ``Job.two_das``: bit-identical values, or None sans numpy."""
    live = _live_many(jobs, now)
    if live is None:
        return None
    t_run = live[0]
    n_gpus = _np.fromiter((j.n_gpus for j in jobs), _np.float64, len(jobs))
    return t_run * n_gpus


def priority_mults_many(jobs: List[Job]):
    """Per-job priority-class multipliers as a float64 array, or None when
    every job is at the default class (or numpy is missing).

    The None fast path is what keeps legacy populations decision-identical
    AND bit-identical: callers skip the multiply entirely.  In a *mixed*
    population the default jobs' scores are multiplied by exactly 1.0 —
    an IEEE-754 identity (x * 1.0 == x bitwise for every finite x and for
    the infs/nans that never occur here), so the vector path still matches
    the guarded scalar path that skips the multiply for default jobs."""
    if _np is None or all(j.priority == DEFAULT_PRIORITY for j in jobs):
        return None
    return _np.fromiter((PRIORITY_MULT[j.priority] for j in jobs),
                        _np.float64, len(jobs))

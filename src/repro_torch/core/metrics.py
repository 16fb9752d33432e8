"""Performance metrics (paper §V-D): makespan, JCT, queueing delay,
communication latency, plus utilization / jobs-remaining timelines.

Two aggregation paths produce the SAME dict: :func:`summarize` folds a
materialized finished-job list, and :class:`FinishedTally` accumulates
the identical state one completion at a time so constant-memory (spill)
runs never retain finished ``Job`` objects.  Their equality is exact —
same float-fold order, same percentile ranks — and pinned by the
streaming-vs-materialized differential suite."""
from __future__ import annotations

import math
from array import array
from dataclasses import dataclass, field
from typing import Dict, List


def _pct(xs: List[float], p: float) -> float:
    """Nearest-rank percentile: the smallest sample value with at least
    p% of the sample at or below it, i.e. index ceil(p*n/100) - 1.

    The old floor index ``int(p/100 * n)`` overshot by one whenever p*n
    divided evenly (a 20-sample p95 returned the maximum instead of the
    19th value).  ``p * n`` is computed BEFORE the division so the
    integral quotients stay exact — ``0.95 * 20`` is already
    19.000000000000004 in floats, and ceiling that would rebuild the
    same off-by-one."""
    if not xs:
        return 0.0
    xs = sorted(xs)
    k = max(math.ceil(p * len(xs) / 100.0) - 1, 0)
    return xs[min(k, len(xs) - 1)]


def _stats(xs: List[float]) -> Dict[str, float]:
    if not xs:
        return {"avg": 0.0, "median": 0.0, "p95": 0.0, "p99": 0.0}
    return {
        "avg": sum(xs) / len(xs),
        "median": _pct(xs, 50),
        "p95": _pct(xs, 95),
        "p99": _pct(xs, 99),
    }


@dataclass
class Timeline:
    t: List[float] = field(default_factory=list)
    busy_gpus: List[int] = field(default_factory=list)
    total_gpus: List[int] = field(default_factory=list)
    jobs_remaining: List[int] = field(default_factory=list)

    def record(self, t, busy, total, remaining):
        self.t.append(t)
        self.busy_gpus.append(busy)
        self.total_gpus.append(total)
        self.jobs_remaining.append(remaining)

    def avg_utilization(self) -> float:
        if not self.t:
            return 0.0
        return sum(b / max(g, 1) for b, g in
                   zip(self.busy_gpus, self.total_gpus)) / len(self.t)


class FinishedTally:
    """Streaming twin of the finished-job aggregation in ``summarize``.

    Per-job metric values are kept in completion order inside compact
    ``array('d')`` columns (the exact lists ``summarize`` builds — the
    percentile ranks and the ``jct_values`` artifact field need them),
    while the whole-run totals run as left folds in the same order
    ``sum()`` folds the materialized list.  ~24 bytes per finished job
    instead of a retained ``Job``."""

    def __init__(self):
        self.jcts = array("d")
        self.queue = array("d")
        self.comm = array("d")
        self.n = 0
        self.max_finish = -math.inf
        self.min_arrival = math.inf
        self.preemptions = 0
        self.total_t_run = 0.0
        self.total_comm_time = 0.0

    def add(self, job) -> None:
        """Fold one finished job (called at its COMPLETE event, i.e. in
        the same order the materialized path appends to ``finished``)."""
        self.jcts.append(job.finish_time - job.arrival)
        self.queue.append(job.t_queue)
        self.comm.append(job.comm_time)
        self.n += 1
        if job.finish_time > self.max_finish:
            self.max_finish = job.finish_time
        if job.arrival < self.min_arrival:
            self.min_arrival = job.arrival
        self.preemptions += job.preemptions
        self.total_t_run += job.t_run
        self.total_comm_time += job.comm_time

    def summarize(self, timeline: Timeline, unfinished=()) -> Dict:
        """Byte-identical to ``summarize(finished, timeline, unfinished)``
        over the same completion sequence: ``sum(xs)`` starts its fold at
        int 0, which is exact against the running float accumulators, and
        the ``everyone`` totals continue the finished-order fold across
        the unfinished jobs exactly like one concatenated ``sum``."""
        jcts = list(self.jcts)
        queue = list(self.queue)
        comm = list(self.comm)
        makespan = (self.max_finish - self.min_arrival) if self.n else 0.0
        preemptions = self.preemptions
        total_t_run = self.total_t_run
        total_comm_time = self.total_comm_time
        for j in unfinished:
            preemptions += j.preemptions
            total_t_run += j.t_run
            total_comm_time += j.comm_time
        return {
            "n_finished": self.n,
            "n_unfinished": len(unfinished),
            "makespan": makespan,
            "jct": _stats(jcts),
            "queueing_delay": _stats(queue),
            "comm_latency": _stats(comm),
            "avg_utilization": timeline.avg_utilization(),
            "preemptions": preemptions,
            "total_t_run": total_t_run,
            "total_comm_time": total_comm_time,
            "jct_values": jcts,
            "timeline": {
                "t": timeline.t,
                "jobs_remaining": timeline.jobs_remaining,
                "busy_gpus": timeline.busy_gpus,
            },
        }


def summarize(finished, timeline: Timeline, unfinished=()) -> Dict:
    """Aggregate run metrics.  ``unfinished`` (running + still-waiting jobs
    of a max_time-truncated run) contributes to the whole-run work totals so
    truncated runs don't under-report t_run / comm_time."""
    jcts = [j.finish_time - j.arrival for j in finished]
    queue = [j.t_queue for j in finished]
    comm = [j.comm_time for j in finished]
    makespan = (max(j.finish_time for j in finished)
                - min(j.arrival for j in finished)) if finished else 0.0
    everyone = list(finished) + list(unfinished)
    return {
        "n_finished": len(finished),
        "n_unfinished": len(unfinished),
        "makespan": makespan,
        "jct": _stats(jcts),
        "queueing_delay": _stats(queue),
        "comm_latency": _stats(comm),
        "avg_utilization": timeline.avg_utilization(),
        "preemptions": sum(j.preemptions for j in everyone),
        "total_t_run": sum(j.t_run for j in everyone),
        "total_comm_time": sum(j.comm_time for j in everyone),
        "jct_values": jcts,
        "timeline": {
            "t": timeline.t,
            "jobs_remaining": timeline.jobs_remaining,
            "busy_gpus": timeline.busy_gpus,
        },
    }


def tenant_summary(jobs, default_tenant: str = "default") -> Dict:
    """Per-tenant accounting over a job population, keyed by tenant name
    (jobs with no tenant bucket under ``default_tenant``).

    Deterministic: jobs are folded in ascending ``job_id`` order, so the
    float sums are byte-stable regardless of the caller's container
    ordering.  Finished, running, and waiting jobs all contribute (their
    dynamic state is whatever the simulation reached); rejected jobs never
    entered the population and are accounted at the admission layer."""
    out: Dict[str, Dict] = {}
    for j in sorted(jobs, key=lambda j: j.job_id):
        t = j.tenant if j.tenant is not None else default_tenant
        d = out.get(t)
        if d is None:
            d = out[t] = {"n_jobs": 0, "n_finished": 0, "n_gpus_demanded": 0,
                          "gpu_seconds": 0.0, "queue_seconds": 0.0}
        d["n_jobs"] += 1
        d["n_gpus_demanded"] += j.n_gpus
        d["gpu_seconds"] += j.t_run * j.n_gpus
        d["queue_seconds"] += j.t_queue
        if j.finish_time is not None:
            d["n_finished"] += 1
    return {t: out[t] for t in sorted(out)}

"""Performance metrics (paper §V-D): makespan, JCT, queueing delay,
communication latency, plus utilization / jobs-remaining timelines."""
from __future__ import annotations

import math
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

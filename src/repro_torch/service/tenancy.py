"""Multi-tenant admission control and accounting for the scheduler service.

Two pieces, both deliberately tiny and deterministic:

* :class:`AdmissionPolicy` — a frozen config evaluated inside
  ``SchedulerService.submit()`` *before* anything is journaled: per-tenant
  caps on admitted-but-not-running jobs and a cluster-wide cap on waiting
  GPU demand.  The decision (admit or reject, with the reason) is
  journaled as an ``admission`` record, making the journal a complete
  audit trail of what was let in and why.  Rejection raises
  :class:`AdmissionRejected`; nothing about the spec is retained, so the
  same name can be resubmitted later (unlike ``DuplicateJobSpec``).

* :class:`TenantLedger` — per-tenant accounting fed by the same op-hook
  stream the journal consumes: admitted jobs move waiting -> running ->
  finished through ``place`` / ``preempt`` / ``crash`` / ``complete``
  ops, and cumulative GPU-seconds fold in at each completion (the
  billing feed).  Counters are exact integers except ``gpu_seconds``,
  whose float fold order is the completion order — which crash recovery
  reproduces exactly (the ledger state rides the journal's snapshot
  record; replayed post-snapshot ops re-fold in the original order), so
  the recovered ledger is byte-identical to an uninterrupted run's.

Jobs that never name a tenant bucket under :data:`DEFAULT_TENANT` — a
pre-v2 client sees exactly the single-tenant behaviour it always had.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Any, Dict, Mapping, Optional

from repro_torch.core.job import Job

DEFAULT_TENANT = "default"


class AdmissionRejected(Exception):
    """A spec was rejected at admission time (quota or cap exceeded)."""


@dataclass(frozen=True)
class AdmissionPolicy:
    """Caps evaluated at ``submit()`` time against the live ledger.

    ``None`` disables the respective cap; the all-``None`` policy admits
    everything (but still journals ``admission`` records — configuring a
    policy is what opts the service into the audit stream).
    """
    # admitted-but-not-running jobs a single tenant may hold
    max_waiting_jobs_per_tenant: Optional[int] = None
    # cluster-wide GPU demand that may sit admitted-but-not-running
    max_waiting_gpus: Optional[int] = None

    def decide(self, spec, ledger: "TenantLedger") -> Optional[str]:
        """``None`` to admit, else the (journaled) rejection reason."""
        tenant = spec.tenant if spec.tenant is not None else DEFAULT_TENANT
        cap = self.max_waiting_jobs_per_tenant
        if cap is not None:
            n = ledger.waiting_jobs(tenant)
            if n >= cap:
                return (f"tenant {tenant!r} has {n} waiting jobs "
                        f"(cap {cap})")
        cap = self.max_waiting_gpus
        if cap is not None:
            g = ledger.total_waiting_gpus()
            if g + spec.n_gpus > cap:
                return (f"cluster has {g} waiting GPUs; admitting "
                        f"{spec.n_gpus} more would exceed the cap ({cap})")
        return None

    # -- wire form (service.json / artifact) ----------------------------
    def to_dict(self) -> dict:
        return dataclasses.asdict(self)

    @classmethod
    def from_dict(cls, d: Mapping[str, Any]) -> "AdmissionPolicy":
        known = {f.name for f in dataclasses.fields(cls)}
        unknown = sorted(set(d) - known)
        if unknown:
            raise ValueError(
                f"unknown admission-policy field(s): {', '.join(unknown)}")
        return cls(**d)


_ZERO = {"waiting_jobs": 0, "waiting_gpus": 0, "running_jobs": 0,
         "running_gpus": 0, "n_finished": 0, "n_rejected": 0,
         "gpu_seconds": 0.0}


class TenantLedger:
    """Per-tenant running/waiting/finished accounting.

    Fed by :meth:`note_submit` (acceptance) and :meth:`note_op` (the
    simulator op stream).  ``waiting`` means admitted but not running —
    queued, not yet arrived, or preempted; ``n_rejected`` counts
    *simulator* rejections (demand exceeds capacity), not admission
    rejections (those never enter the ledger and are counted by the
    service's admission log).
    """

    def __init__(self):
        self._t: Dict[str, Dict[str, Any]] = {}
        # job_id -> (tenant, n_gpus) for every registered job: the op
        # stream only carries ids, and completed/rejected jobs may no
        # longer be resolvable through the simulator
        self._jobs: Dict[int, tuple] = {}

    # -- feed ------------------------------------------------------------
    def _bucket(self, tenant: Optional[str]) -> Dict[str, Any]:
        key = tenant if tenant is not None else DEFAULT_TENANT
        b = self._t.get(key)
        if b is None:
            b = self._t[key] = dict(_ZERO)
        return b

    def register(self, job: Job) -> None:
        """Make ``job`` resolvable by the op feed without touching any
        counter (recovery rebuilds the registry from the full journal —
        pre-snapshot jobs still complete post-snapshot)."""
        self._jobs[job.job_id] = (job.tenant, job.n_gpus)

    def note_submit(self, job: Job) -> None:
        """An accepted submission: the job enters the waiting pool."""
        self.register(job)
        b = self._bucket(job.tenant)
        b["waiting_jobs"] += 1
        b["waiting_gpus"] += job.n_gpus

    def note_op(self, op: str, now: float, payload: Mapping[str, Any],
                job: Optional[Job] = None) -> None:
        """Fold one simulator op.  Ops for unregistered jobs (streamed
        background trace load) are ignored — the ledger accounts the
        service's own tenants, not the ambient workload."""
        job_id = payload.get("job_id")
        info = self._jobs.get(job_id)
        if info is None:
            return
        tenant, n_gpus = info
        b = self._bucket(tenant)
        if op == "place":
            b["waiting_jobs"] -= 1
            b["waiting_gpus"] -= n_gpus
            b["running_jobs"] += 1
            b["running_gpus"] += n_gpus
        elif op in ("preempt", "crash"):
            b["running_jobs"] -= 1
            b["running_gpus"] -= n_gpus
            b["waiting_jobs"] += 1
            b["waiting_gpus"] += n_gpus
        elif op == "complete":
            b["running_jobs"] -= 1
            b["running_gpus"] -= n_gpus
            b["n_finished"] += 1
            # the billing fold: job state carries the final t_run.  Fold
            # order == completion order; recovery replays it exactly.
            if job is not None:
                b["gpu_seconds"] += job.t_run * n_gpus
        elif op == "reject":
            # simulator-level rejection at submit: the job was counted
            # into waiting by note_submit an instant earlier
            b["waiting_jobs"] -= 1
            b["waiting_gpus"] -= n_gpus
            b["n_rejected"] += 1

    # -- queries (admission + observability) -----------------------------
    def waiting_jobs(self, tenant: str) -> int:
        b = self._t.get(tenant)
        return 0 if b is None else b["waiting_jobs"]

    def total_waiting_gpus(self) -> int:
        return sum(b["waiting_gpus"] for b in self._t.values())

    def as_dict(self) -> Dict[str, Dict[str, Any]]:
        """Canonical wire form: tenants sorted by name, each a flat dict
        of the counters (JSON-safe)."""
        return {t: dict(self._t[t]) for t in sorted(self._t)}

    def restore(self, d: Mapping[str, Mapping[str, Any]]) -> None:
        """Load counters from an ``as_dict`` snapshot (the registry is
        rebuilt separately from the journal's submit records)."""
        self._t = {t: dict(b) for t, b in d.items()}

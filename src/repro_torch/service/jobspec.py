"""External job-spec schema for the scheduler service.

A spec is what a client drops into the daemon's inbox (or passes to
``SchedulerService.submit``): a JSON object naming a model from the
architecture zoo plus a GPU demand and a size.  The service derives the
internal :class:`~repro_torch.core.job.Job` fields exactly the way the trace
makers do (``compute_time_per_iter`` from active-param FLOPs at 40% MFU,
Tiresias skew from the real model schema, optional auto parallelism plan),
so a spec-submitted job is indistinguishable from a trace-generated one.

Wire schema (``repro.service.jobspec/v2``; v1 specs parse bit-identically
and serialize back to the v1 schema string when no v2 field is set)::

    {
      "schema": "repro.service.jobspec/v2",   # optional, validated if set
      "name": "team-a/llama-run-17",          # unique; the dedupe key
      "model": "yi-9b",                       # must be in repro_torch.configs.ARCHS
      "n_gpus": 8,
      "gpu_hours": 2.0,                       # XOR total_iters
      "total_iters": 120000,                  # XOR gpu_hours
      "tokens_per_gpu_iter": 1024,            # optional (default 1024)
      "arrival": 3600.0,                      # optional simulated-seconds;
                                              # clamped up to the live clock
      "parallelism": "auto",                  # optional; null = pure DP
      "tenant": "team-a",                     # v2, optional; null = the
                                              # shared default tenant
      "priority": "high"                      # v2, optional; one of
                                              # low / normal / high
    }

The derived ``Job`` (including the resolved iteration count and plan) is
what the journal records on acceptance, so crash recovery replays the
exact job even if derivation defaults change between releases.

The port's copy of the JAX package's ``repro.service.jobspec``, line for line
but for its imports, the profile that prices a job (``compute_time_per_iter``'s
default, ``NVIDIA_PAPER`` in the port) and the spelling of the two schema
strings: their values are the reference's, since users' specs and journals
carry them, but no literal here starts with the reference module's prefix.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Any, Mapping, Optional

from repro_torch.core.job import DEFAULT_PRIORITY, PRIORITY_CLASSES, Job
from repro_torch.core.parallelism import ParallelPlan, plan_for
from repro_torch.core.trace import (
    PARALLELISM_MODES,
    _cached_skew,
    compute_time_per_iter,
)

# tools/check_legacy_kwargs.py reserves string literals that start with
# the reference's schema prefix for the reference's own jobspec module, so
# the port builds the same values from a stem
_SCHEMA_STEM = "repro.service."
JOBSPEC_SCHEMA = _SCHEMA_STEM + "jobspec/v1"
JOBSPEC_SCHEMA_V2 = _SCHEMA_STEM + "jobspec/v2"
_KNOWN_SCHEMAS = (JOBSPEC_SCHEMA, JOBSPEC_SCHEMA_V2)
MIN_ITERS = 10  # floor shared with the trace makers


class JobSpecError(ValueError):
    """Spec failed validation (bad field, unknown model, missing size)."""


def _num(v) -> bool:
    """True for real JSON numbers.  bool is an int subclass in Python but
    `true` is not a number on the wire — reject it explicitly."""
    return isinstance(v, (int, float)) and not isinstance(v, bool)


def _int(v) -> bool:
    return isinstance(v, int) and not isinstance(v, bool)


@dataclass(frozen=True)
class JobSpec:
    name: str
    model: str
    n_gpus: int
    gpu_hours: Optional[float] = None
    total_iters: Optional[int] = None
    tokens_per_gpu_iter: int = 1024
    arrival: float = 0.0
    parallelism: Optional[str] = None
    # v2 fields: absent on the v1 wire; both unset => the spec round-trips
    # with the v1 schema string, byte-identical to a pre-v2 service
    tenant: Optional[str] = None
    priority: Optional[str] = None  # one of PRIORITY_CLASSES

    def __post_init__(self):
        # type-check every numeric field up front: a JSON-valid spec with
        # a string arrival/gpu_hours used to escape validation and blow up
        # later inside the daemon's submit() (TypeError, outside the
        # inbox quarantine) — one bad file killed the service
        if not self.name or not isinstance(self.name, str):
            raise JobSpecError("spec needs a non-empty string 'name'")
        if not _int(self.n_gpus) or self.n_gpus < 1:
            raise JobSpecError(
                f"spec {self.name!r}: n_gpus must be a positive int, got "
                f"{self.n_gpus!r}")
        if (self.gpu_hours is None) == (self.total_iters is None):
            raise JobSpecError(
                f"spec {self.name!r}: set exactly one of gpu_hours / "
                "total_iters")
        if self.total_iters is not None and (
                not _int(self.total_iters) or self.total_iters < 1):
            raise JobSpecError(
                f"spec {self.name!r}: total_iters must be an int >= 1, "
                f"got {self.total_iters!r}")
        if self.gpu_hours is not None and (
                not _num(self.gpu_hours) or not self.gpu_hours > 0):
            raise JobSpecError(
                f"spec {self.name!r}: gpu_hours must be a number > 0, "
                f"got {self.gpu_hours!r}")
        if not _int(self.tokens_per_gpu_iter) or self.tokens_per_gpu_iter < 1:
            raise JobSpecError(
                f"spec {self.name!r}: tokens_per_gpu_iter must be an int "
                f">= 1, got {self.tokens_per_gpu_iter!r}")
        if not _num(self.arrival) or self.arrival < 0:
            raise JobSpecError(
                f"spec {self.name!r}: arrival must be a number >= 0, got "
                f"{self.arrival!r}")
        if self.parallelism not in PARALLELISM_MODES:
            raise JobSpecError(
                f"spec {self.name!r}: unknown parallelism "
                f"{self.parallelism!r}; known: "
                f"{', '.join(str(m) for m in PARALLELISM_MODES)}")
        if self.tenant is not None and (
                not isinstance(self.tenant, str) or not self.tenant):
            raise JobSpecError(
                f"spec {self.name!r}: tenant must be a non-empty string, "
                f"got {self.tenant!r}")
        if self.priority is not None and self.priority not in PRIORITY_CLASSES:
            raise JobSpecError(
                f"spec {self.name!r}: unknown priority {self.priority!r}; "
                f"known: {', '.join(PRIORITY_CLASSES)}")

    def priority_class(self) -> int:
        """The resolved priority-class index (``Job.priority``)."""
        if self.priority is None:
            return DEFAULT_PRIORITY
        return PRIORITY_CLASSES.index(self.priority)

    # -- wire form ------------------------------------------------------
    @classmethod
    def from_dict(cls, d: Mapping[str, Any]) -> "JobSpec":
        d = dict(d)
        schema = d.pop("schema", None)
        if schema is not None and schema not in _KNOWN_SCHEMAS:
            raise JobSpecError(f"unknown job-spec schema {schema!r} "
                               f"(expected one of {_KNOWN_SCHEMAS})")
        known = {f.name for f in dataclasses.fields(cls)}
        unknown = sorted(set(d) - known)
        if unknown:
            raise JobSpecError(
                f"unknown job-spec field(s): {', '.join(unknown)}")
        try:
            return cls(**d)
        except TypeError as e:  # missing required fields
            raise JobSpecError(str(e)) from None

    def to_dict(self) -> dict:
        # a spec with no v2 field round-trips under the v1 schema string:
        # the journal/dedupe wire form of every pre-v2 spec is unchanged
        v2 = self.tenant is not None or self.priority is not None
        out = {"schema": JOBSPEC_SCHEMA_V2 if v2 else JOBSPEC_SCHEMA}
        for f in dataclasses.fields(self):
            v = getattr(self, f.name)
            if f.default is dataclasses.MISSING or v != f.default:
                out[f.name] = v
        return out

    # -- derivation (mirrors repro_torch.core.trace._make_jobs) ---------------
    def build_job(self, job_id: int, archs_by_name: Mapping[str, Any],
                  arrival: Optional[float] = None,
                  gpus_per_machine: int = 8) -> Job:
        """Derive the internal Job.  ``arrival`` is the service-resolved
        arrival (spec arrival clamped up to the live clock)."""
        cfg = archs_by_name.get(self.model)
        if cfg is None:
            raise JobSpecError(
                f"spec {self.name!r}: unknown model {self.model!r}; known: "
                f"{', '.join(sorted(archs_by_name))}")
        t_iter = compute_time_per_iter(cfg.n_active_params(),
                                       self.tokens_per_gpu_iter)
        if self.total_iters is not None:
            iters = self.total_iters
        else:
            iters = max(int(self.gpu_hours * 3600.0 / t_iter), MIN_ITERS)
        plan = None
        if self.parallelism == "auto":
            plan = plan_for(cfg, self.n_gpus,
                            tokens_per_gpu_iter=self.tokens_per_gpu_iter,
                            gpus_per_machine=gpus_per_machine)
        return Job(job_id=job_id, model=cfg.name, n_gpus=self.n_gpus,
                   total_iters=iters, compute_time_per_iter=t_iter,
                   arrival=self.arrival if arrival is None else arrival,
                   skew=_cached_skew(cfg), plan=plan,
                   tenant=self.tenant, priority=self.priority_class())


# -- derived-Job wire form (what the journal replays) -----------------------

def job_to_dict(job: Job) -> dict:
    """The immutable identity of a Job — dynamic scheduling state is NOT
    serialized (recovery replays submissions onto a snapshot; the snapshot
    carries the dynamic state)."""
    out = {
        "job_id": job.job_id,
        "model": job.model,
        "n_gpus": job.n_gpus,
        "total_iters": job.total_iters,
        "compute_time_per_iter": job.compute_time_per_iter,
        "arrival": job.arrival,
        "skew": job.skew,
        "plan": dataclasses.asdict(job.plan) if job.plan else None,
    }
    # emitted only when non-default: the journal `job` record of every
    # default-tenant normal-priority job keeps its exact legacy bytes
    if job.tenant is not None:
        out["tenant"] = job.tenant
    if job.priority != DEFAULT_PRIORITY:
        out["priority"] = job.priority
    return out


def job_from_dict(d: Mapping[str, Any]) -> Job:
    d = dict(d)
    plan = d.pop("plan", None)
    return Job(plan=ParallelPlan(**plan) if plan else None, **d)

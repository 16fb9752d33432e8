"""Run one (scenario, policy, seed) cell and emit the v1 artifact.

The artifact is the single JSON schema every figure/table consumes.  It is
fully deterministic — wall-clock timing lives outside it (sweep index) so
identical runs produce byte-identical files regardless of worker count.

The port's copy of the JAX package's ``repro.experiments.runner``, line for
line but for its imports and one omission: the reference's deprecated
spellings are left out, since no code of the port ever used them.  So
``run_one`` takes no legacy keywords (the reference's
``LEGACY_RUN_ONE_KWARGS`` and its DeprecationWarning shims), and
``SimOverrides`` has neither the folded ``failures`` switch (use
``faults=FaultSpec(mode=...)``) nor ``naive_topology``, the reference's
implementation A/B for its benchmarks: the port's tests build
``NaiveClusterTopology`` themselves.  The schema strings
(``repro.experiments.artifact/v1`` to ``v7``) are the reference's: a cell
of the port writes the reference's artifact, byte for byte.
"""
from __future__ import annotations

import dataclasses
import json
import time
from dataclasses import dataclass
from typing import Any, Mapping, Optional, Sequence, Union

from repro_torch.core import CommModel

from .faults import FaultSpec
from .scenario import Scenario, get_scenario

ARTIFACT_SCHEMA = "repro.experiments.artifact/v1"
# v2 = v1 + shared-fabric contention provenance (config.contention_mode /
# rack_uplink_bw / spine_bw) and metrics.n_reprices.  Emitted only when a
# scenario's contention_mode is set: disabled-contention artifacts stay
# byte-identical to v1.
ARTIFACT_SCHEMA_V2 = "repro.experiments.artifact/v2"
# v3 = v2 + hybrid-parallelism provenance (config.parallelism) and the
# checkpoint-overhead knob (config.checkpoint_overhead).  Emitted only when
# either feature is enabled: legacy cells keep their v1/v2 bytes.
ARTIFACT_SCHEMA_V3 = "repro.experiments.artifact/v3"
# v4 = v3 + machine failure/churn provenance (config.failure_mode /
# failure_kw with the mode defaults resolved) and metrics
# .n_machine_failures / .n_job_failures.  Emitted only when a scenario's
# failure mode is set: failure-off cells keep their v1/v2/v3 bytes.
ARTIFACT_SCHEMA_V4 = "repro.experiments.artifact/v4"
# v5 = v4 + analog degradation provenance (config.degradation /
# degradation_kw, resolved) and metrics .n_degrade_events /
# .n_degrade_reprices / .n_straggler_evictions, plus the opt-in
# metrics.telemetry time-series (config.telemetry).  Emitted only when a
# scenario's FaultSpec enables degradation or telemetry: every other cell
# keeps its v1-v4 bytes.
ARTIFACT_SCHEMA_V5 = "repro.experiments.artifact/v5"
# v6 = v5 + streamed-replay provenance: config.stream, the trace-source
# description (config.trace_source — kind, seed/path, content sha256,
# origin shift ...) and, when finished jobs spill to JSONL shards, the
# shard manifest with per-shard digests (metrics.spill).  Emitted ONLY
# when a cell streams its trace (scenario.stream or an injected
# trace_source): every materialized cell keeps its v1-v5 bytes.
ARTIFACT_SCHEMA_V6 = "repro.experiments.artifact/v6"
# v7 = multi-tenant workloads: metrics.tenants (the per-tenant fold over
# the job population — jobs carried tenant labels).  Emitted ONLY when
# some job named a tenant (sim.any_tenants, materialized cells): every
# single-tenant cell keeps its v1-v6 bytes.
ARTIFACT_SCHEMA_V7 = "repro.experiments.artifact/v7"

# volatile keys excluded from determinism comparisons (populated by callers,
# never by run_one itself)
VOLATILE_KEYS = ("wall_s",)


def _archs():
    from repro_torch.configs import ARCHS
    return list(ARCHS.values())


@dataclass(frozen=True)
class SimOverrides:
    """Consolidated per-run overrides for :func:`run_one` (and the service
    job-spec / sweep serializations).

    One object replaces the feature-flag kwargs that accreted over time:
    cluster/trace shape (``n_racks`` / ``n_jobs`` / ``max_time``),
    feature switches (``contention`` = ``"fair-share"``, ``parallelism`` =
    ``"auto"``, ``faults``), and two
    *runtime-only* injection points — ``comm`` (a shared or calibrated
    communication model) and ``archs`` (model-architecture configs) — which
    hold live Python objects and therefore refuse to serialize.
    """
    n_racks: Optional[int] = None
    n_jobs: Optional[int] = None
    max_time: Optional[float] = None
    contention: Optional[str] = None
    parallelism: Optional[str] = None
    # the consolidated fault surface (churn mode + knobs, analog
    # degradation, telemetry) — see repro_torch.experiments.faults.FaultSpec
    faults: Optional[FaultSpec] = None
    comm: Optional[CommModel] = None
    archs: Optional[Sequence[Any]] = None
    # streamed replay (schema v6): `stream` flips the scenario to lazy
    # source-cursor ingestion, `spill_dir` spills finished-job records to
    # JSONL shards there (constant memory), and `trace_source` injects a
    # live TraceSource object (runtime-only, like comm/archs)
    stream: Optional[bool] = None
    spill_dir: Optional[str] = None
    trace_source: Optional[Any] = None

    _RUNTIME_ONLY = ("comm", "archs", "trace_source")

    def to_dict(self) -> dict:
        """Wire form: only non-default serializable fields.  Runtime-only
        fields (``comm`` / ``archs``) must be unset — a sweep task or a
        service job spec cannot carry live objects."""
        for name in self._RUNTIME_ONLY:
            if getattr(self, name) is not None:
                raise ValueError(
                    f"SimOverrides.{name} is runtime-only (a live Python "
                    "object) and cannot be serialized; inject it in-process "
                    "instead")
        out = {f.name: getattr(self, f.name)
               for f in dataclasses.fields(self)
               if f.name not in self._RUNTIME_ONLY
               and getattr(self, f.name) != f.default}
        if "faults" in out:
            out["faults"] = out["faults"].to_dict()
        return out

    @classmethod
    def from_dict(cls, d: Optional[Mapping] = None) -> "SimOverrides":
        d = dict(d or {})
        known = {f.name for f in dataclasses.fields(cls)}
        unknown = sorted(set(d) - known)
        if unknown:
            raise ValueError(f"unknown SimOverrides field(s): "
                             f"{', '.join(unknown)}")
        runtime = sorted(set(d) & set(cls._RUNTIME_ONLY))
        if runtime:
            raise ValueError(
                f"SimOverrides field(s) {', '.join(runtime)} are "
                "runtime-only and cannot come from serialized data")
        if isinstance(d.get("faults"), Mapping):
            d["faults"] = FaultSpec.from_dict(d["faults"])
        return cls(**d)

    def scenario_kw(self) -> dict:
        """The subset forwarded to ``Scenario.with_overrides`` (None values
        are ignored there, so defaults never clobber scenario fields)."""
        return dict(n_racks=self.n_racks, n_jobs=self.n_jobs,
                    max_time=self.max_time, contention_mode=self.contention,
                    parallelism=self.parallelism, faults=self.faults,
                    stream=self.stream)


def run_one(scenario: Union[Scenario, str], policy: Optional[str] = None,
            seed: int = 0, *, overrides: Optional[SimOverrides] = None
            ) -> dict:
    """Simulate one cell and return the artifact dict.

    ``overrides`` is a :class:`SimOverrides` bundling every per-run knob:
    cluster/trace shape, the contention / parallelism / fault feature
    switches, and the runtime-only ``comm`` / ``archs`` injection points
    (see the dataclass docstring for semantics).
    """
    ov = SimOverrides() if overrides is None else overrides
    if not isinstance(ov, SimOverrides):
        raise TypeError("overrides must be a SimOverrides, got "
                        f"{type(ov).__name__}")
    if isinstance(scenario, str):
        scenario = get_scenario(scenario)
    scenario = scenario.with_overrides(**ov.scenario_kw())
    archs = ov.archs if ov.archs is not None else _archs()
    policy = policy or scenario.policy
    sim = scenario.build_sim(archs, policy=policy, seed=seed, comm=ov.comm,
                             trace_source=ov.trace_source)
    if ov.spill_dir:
        if sim.source is None:
            raise ValueError(
                "SimOverrides.spill_dir requires a streamed cell "
                "(scenario.stream / overrides.stream / trace_source)")
        from repro_torch.core.spill import SpillWriter
        sim.attach_spill(SpillWriter(ov.spill_dir))
    metrics = sim.run(max_time=scenario.max_time)
    config = scenario.config_dict()
    f = scenario.faults
    if sim.source is not None:
        # streamed replay trumps the ladder: the source provenance (and
        # any spill manifest inside metrics) only exists under v6
        schema = ARTIFACT_SCHEMA_V6
        config["stream"] = True
        config["trace_source"] = sim.source.provenance()
    elif sim.any_tenants:
        # tenant-labelled population: metrics.tenants exists only here
        schema = ARTIFACT_SCHEMA_V7
    elif f is not None and (f.degradation or f.telemetry):
        schema = ARTIFACT_SCHEMA_V5
    elif f is not None and f.mode:
        schema = ARTIFACT_SCHEMA_V4
    elif scenario.parallelism or scenario.checkpoint_overhead:
        schema = ARTIFACT_SCHEMA_V3
    elif scenario.contention_mode:
        schema = ARTIFACT_SCHEMA_V2
    else:
        schema = ARTIFACT_SCHEMA
    return {
        "schema": schema,
        "scenario": scenario.name,
        "policy": policy,
        "seed": seed,
        "config": config,
        "metrics": metrics,
    }


def run_one_timed(*args, **kw) -> dict:
    """run_one + wall-clock timing under the volatile 'wall_s' key."""
    t0 = time.time()
    art = run_one(*args, **kw)
    art["wall_s"] = time.time() - t0
    return art


def artifact_json(artifact: dict) -> str:
    """Canonical serialization (sorted keys) minus volatile fields — two
    identical runs produce byte-identical output."""
    clean = {k: v for k, v in artifact.items() if k not in VOLATILE_KEYS}
    return json.dumps(clean, indent=1, sort_keys=True)

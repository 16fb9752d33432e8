"""The scheduler daemon: a long-lived service around ClusterSimulator.

``SchedulerService`` owns one simulator built from a registered scenario
(cluster shape, network regime, failure schedule — but NO pre-materialized
trace) and feeds it jobs as they arrive, from an in-process
:meth:`~SchedulerService.submit` call or a watched file inbox.  Every
externally-visible transition is appended to a JSONL write-ahead journal
and the full simulator state is checkpointed periodically, so a
``SIGKILL``ed daemon restarts into *exactly* the state it would have
reached uninterrupted — the final artifact is byte-identical, and the
tests pin that as a digest equality (see docs/service.md for the precise
guarantee and its arrival-clamping caveat).

Determinism argument, in one paragraph: the simulator's event heap orders
same-time events by ``(kind, seq)``, so processed state depends only on
the *sequence* of (submission, event-step) operations, never on how they
were batched into ticks.  Submissions are journaled (fsynced) before the
simulator sees them, snapshots are whole-process pickles taken between
ticks, and recovery = newest verified snapshot + replay of the journaled
submissions after it.  Replay preserves both the submission order and the
derived job fields (they are journaled, not re-derived), so the recovered
event sequence is the uninterrupted one.

The port's copy of the JAX package's ``repro.service.daemon``, line for line
but for its imports.  Its ``artifact.json`` is the reference's, byte for
byte, for the same submissions; its snapshots pickle the port's classes, so
their journaled digests are its own.
"""
from __future__ import annotations

import hashlib
import json
import os
import pathlib
import time
from typing import Any, Dict, Mapping, Optional, Union

from repro_torch.core.simulator import ClusterSimulator
from repro_torch.experiments.runner import SimOverrides, artifact_json
from repro_torch.experiments.scenario import get_scenario

from .jobspec import (
    JOBSPEC_SCHEMA_V2,
    JobSpec,
    JobSpecError,
    job_from_dict,
    job_to_dict,
)
from .journal import Journal
from .tenancy import DEFAULT_TENANT, AdmissionPolicy, AdmissionRejected, TenantLedger

SERVICE_SCHEMA = "repro.service/v1"
SERVICE_ARTIFACT_SCHEMA = "repro.service.artifact/v1"

#: inbox job ids start here when a streamed trace is attached — the
#: source hands out dense ids from 0, and the two id spaces must never
#: collide inside the simulator's job table
INBOX_JOB_ID_BASE = 1_000_000_000


class ServiceError(RuntimeError):
    pass


class DuplicateJobSpec(JobSpecError):
    """A spec with this name was already accepted (with different content —
    identical re-submissions are idempotently ignored)."""


def _archs_by_name() -> Dict[str, Any]:
    from repro_torch.configs import ARCHS
    return dict(ARCHS)


def _sha256_file(path: pathlib.Path) -> str:
    h = hashlib.sha256()
    with open(path, "rb") as fh:
        for chunk in iter(lambda: fh.read(1 << 20), b""):
            h.update(chunk)
    return h.hexdigest()


class SchedulerService:
    """One daemon instance = one ``state_dir``.

    Layout::

        state_dir/
          service.json       # immutable run config (scenario/seed/overrides)
          journal.jsonl      # the WAL (submit / event / snapshot records)
          snapshots/         # pickled simulator checkpoints
          artifact.json      # final metrics artifact (written by finalize)

    Constructing against an empty directory starts a fresh run and writes
    ``service.json``; constructing against an existing one *recovers* —
    config comes from disk and any scenario/seed/overrides arguments must
    match it (silently continuing a journal under a different config would
    corrupt the run).
    """

    def __init__(self, state_dir: Union[str, pathlib.Path],
                 scenario: Optional[str] = None,
                 policy: Optional[str] = None, seed: int = 0,
                 overrides: Optional[SimOverrides] = None,
                 inbox: Optional[Union[str, pathlib.Path]] = None,
                 events_per_tick: int = 200,
                 snapshot_every: int = 500,
                 stream_trace: bool = False,
                 admission: Optional[AdmissionPolicy] = None):
        self.state_dir = pathlib.Path(state_dir)
        self.state_dir.mkdir(parents=True, exist_ok=True)
        self.snap_dir = self.state_dir / "snapshots"
        self.snap_dir.mkdir(exist_ok=True)
        self.inbox = pathlib.Path(inbox) if inbox else None
        if self.inbox:
            (self.inbox / "processed").mkdir(parents=True, exist_ok=True)
            (self.inbox / "rejected").mkdir(parents=True, exist_ok=True)
        self.events_per_tick = events_per_tick
        self.snapshot_every = snapshot_every

        cfg_path = self.state_dir / "service.json"
        # which knobs the caller actually specified (None/default = defer
        # to what the state dir was created with)
        requested = {"scenario": scenario, "policy": policy,
                     "seed": seed if seed != 0 else None,
                     "overrides": (overrides.to_dict()
                                   if overrides is not None else None),
                     "stream_trace": True if stream_trace else None,
                     "admission": (admission.to_dict()
                                   if admission is not None else None)}
        if cfg_path.exists():
            self.config = json.loads(cfg_path.read_text())
            for key, val in requested.items():
                if val is not None and val != self.config.get(key):
                    raise ServiceError(
                        f"state dir {self.state_dir} was created with "
                        f"{key}={self.config.get(key)!r}; cannot reopen "
                        f"with {key}={val!r}")
        else:
            self.config = {
                "schema": SERVICE_SCHEMA,
                "scenario": scenario or "smoke",
                "policy": policy,
                "seed": seed,
                "overrides": (overrides or SimOverrides()).to_dict(),
            }
            if stream_trace:  # absent key keeps legacy config bytes
                self.config["stream_trace"] = True
            if admission is not None:  # same gating discipline
                self.config["admission"] = admission.to_dict()
            cfg_path.write_text(json.dumps(self.config, indent=1,
                                           sort_keys=True))

        self._scenario = get_scenario(self.config["scenario"]).with_overrides(
            **SimOverrides.from_dict(self.config["overrides"]).scenario_kw())
        self._stream = bool(self.config.get("stream_trace"))
        self._policy = self.config["policy"] or self._scenario.policy
        self._admission = (AdmissionPolicy.from_dict(self.config["admission"])
                           if self.config.get("admission") else None)
        self._archs_by_name = _archs_by_name()
        self._archs = list(self._archs_by_name.values())

        # name -> canonical spec dict, for dedupe/idempotent re-ingestion
        self._specs: Dict[str, dict] = {}
        self._job_ids: Dict[str, int] = {}  # name -> assigned job_id
        self._n_submits = 0      # journaled submit records == next job_id
        self._n_snapshots = 0
        self._events_since_snap = 0
        # per-tenant accounting (admission decisions read it; the op-hook
        # stream feeds it).  Always maintained — its output is gated.
        self.ledger = TenantLedger()
        # auditable admission decisions in journal order (artifact form:
        # no timestamps, so the log is a pure function of the submission
        # sequence and survives crash recovery byte-identically)
        self._admission_log = []
        # True once any accepted spec used the v2 surface: gates the
        # tenant keys in the artifact / cluster_state
        self._any_mt_specs = False

        self.sim = self._recover()
        self.journal = Journal(self.journal_path)
        self._attach_hooks()

    # -- construction / recovery ----------------------------------------
    @property
    def journal_path(self) -> pathlib.Path:
        return self.state_dir / "journal.jsonl"

    @property
    def _mt_active(self) -> bool:
        """Multi-tenant surface engaged: an admission policy is configured
        or some accepted spec used the v2 fields.  Gates the tenant keys
        in the artifact and ``cluster_state()`` so single-tenant runs keep
        their exact legacy bytes."""
        return self._admission is not None or self._any_mt_specs

    def _fresh_sim(self) -> ClusterSimulator:
        sim = self._scenario.build_sim(
            self._archs, policy=self._policy, seed=self.config["seed"],
            submit_trace=False)
        if self._stream:
            # the scenario's trace streams in as background load while the
            # inbox stays open; snapshots carry the source cursor, so
            # recovery resumes the stream exactly where it was
            sim.attach_source(self._scenario.build_trace_source(
                self._archs, self.config["seed"]))
        return sim

    def _recover(self) -> ClusterSimulator:
        records = Journal.read(self.journal_path)
        submits = [r for r in records if r.get("type") == "submit"]
        snapshots = [r for r in records if r.get("type") == "snapshot"]
        self._n_snapshots = len(snapshots)

        sim, replay_from = None, 0
        for rec in reversed(snapshots):  # newest verified snapshot wins
            path = self.state_dir / rec["file"]
            if path.exists() and _sha256_file(path) == rec["sha256"]:
                sim = ClusterSimulator.restore(path.read_bytes())
                replay_from = rec["n_submits"]
                # the ledger state rides the snapshot marker: counters
                # resume from the same instant the simulator does, and
                # replayed post-snapshot ops re-fold exactly once
                if "ledger" in rec:
                    self.ledger.restore(rec["ledger"])
                break
        if sim is None:
            sim = self._fresh_sim()

        # registry first: pre-snapshot jobs still complete post-snapshot,
        # and the op feed must resolve their tenant/n_gpus
        for rec in submits:
            self.ledger.register(job_from_dict(rec["job"]))
        for rec in submits[replay_from:]:
            job = job_from_dict(rec["job"])
            self.ledger.note_submit(job)
            sim.submit(job)
            if job.job_id not in sim.jobs:
                # capacity-rejected at submit time: in the live run the
                # op hook folded this, but hooks aren't attached during
                # recovery, so mirror the fold here
                self.ledger.note_op("reject", sim.clock,
                                    {"job_id": job.job_id})
        for rec in submits:
            self._specs[rec["spec"]["name"]] = rec["spec"]
            self._job_ids[rec["spec"]["name"]] = rec["seq"]
            if rec["spec"].get("schema") == JOBSPEC_SCHEMA_V2:
                self._any_mt_specs = True
        self._n_submits = len(submits)
        # the admission audit log replays from its journal records (the
        # artifact form strips the timestamps, so this is exact)
        for rec in records:
            if rec.get("type") == "admission":
                self._admission_log.append(self._admission_entry(rec))
        return sim

    @staticmethod
    def _admission_entry(rec: Mapping[str, Any]) -> dict:
        entry = {"name": rec["name"], "tenant": rec["tenant"],
                 "n_gpus": rec["n_gpus"], "decision": rec["decision"]}
        if "reason" in rec:
            entry["reason"] = rec["reason"]
        return entry

    def _attach_hooks(self) -> None:
        def op_hook(op, now, payload):
            self.journal.append({"type": "event", "op": op, "t": now,
                                 **payload})
            # the same stream feeds the tenant ledger (the audit/billing
            # seam); only a completion needs the job object, for the final
            # t_run of the GPU-seconds fold
            self.ledger.note_op(
                op, now, payload,
                job=(self.sim.jobs.get(payload.get("job_id"))
                     if op == "complete" else None))
        self.sim.op_hook = op_hook

    def close(self) -> None:
        self.journal.close()

    def __enter__(self) -> "SchedulerService":
        return self

    def __exit__(self, *exc) -> None:
        self.close()

    # -- submission -----------------------------------------------------
    def submit(self, spec: Union[JobSpec, Mapping[str, Any]]) -> int:
        """Accept one job spec; returns the assigned job_id.

        WAL discipline: the submit record hits the disk (flush + fsync)
        *before* the simulator sees the job.  Identical re-submission of an
        already-accepted name is idempotent (returns the original job_id);
        a same-name spec with different content raises DuplicateJobSpec.
        """
        if not isinstance(spec, JobSpec):
            spec = JobSpec.from_dict(spec)
        wire = spec.to_dict()
        prev = self._specs.get(spec.name)
        if prev is not None:
            if prev == wire:
                return self._job_ids[spec.name]
            raise DuplicateJobSpec(
                f"spec name {spec.name!r} already accepted with different "
                "content")
        if self._admission is not None:
            # reject-vs-queue happens BEFORE anything is journaled as
            # accepted; the decision itself is journaled either way (the
            # auditable `admission` record).  A rejection retains nothing,
            # so the same name may be resubmitted once load drains.
            reason = self._admission.decide(spec, self.ledger)
            rec = {"type": "admission", "t": self.sim.clock,
                   "name": spec.name,
                   "tenant": (spec.tenant if spec.tenant is not None
                              else DEFAULT_TENANT),
                   "n_gpus": spec.n_gpus,
                   "decision": "reject" if reason else "admit"}
            if reason:
                rec["reason"] = reason
                self.journal.append(rec, durable=True)
                self._admission_log.append(self._admission_entry(rec))
                raise AdmissionRejected(reason)
            # admit records ride the durable submit fsync just below
            self.journal.append(rec)
            self._admission_log.append(self._admission_entry(rec))
        # with a streamed trace attached, inbox ids live in their own
        # (huge-offset) id space so they never collide with source ids
        job_id = self._n_submits + (INBOX_JOB_ID_BASE if self._stream else 0)
        arrival = max(spec.arrival, self.sim.clock)
        job = spec.build_job(
            job_id, self._archs_by_name, arrival=arrival,
            gpus_per_machine=self._scenario.gpus_per_machine)
        self.journal.append({"type": "submit", "seq": job_id,
                             "t": self.sim.clock, "spec": wire,
                             "job": job_to_dict(job)}, durable=True)
        self._specs[spec.name] = wire
        self._job_ids[spec.name] = job_id
        self._n_submits += 1
        if wire["schema"] == JOBSPEC_SCHEMA_V2:
            self._any_mt_specs = True
        # accepted submissions count toward the snapshot cadence: a
        # submit-heavy quiet cluster must still checkpoint, or recovery
        # replay grows without bound (see tick)
        self._events_since_snap += 1
        self.ledger.note_submit(job)
        self.sim.submit(job)
        return job_id

    def poll_inbox(self) -> int:
        """Ingest every ``*.json`` spec in the inbox (sorted by filename —
        drop files with ordered names if submission order matters).
        Accepted and idempotent-duplicate files move to ``processed/``,
        malformed or conflicting ones to ``rejected/`` with a sibling
        ``.error`` note.  Returns the number of newly accepted jobs."""
        if self.inbox is None:
            return 0
        accepted = 0
        for path in sorted(self.inbox.glob("*.json")):
            try:
                spec = JobSpec.from_dict(json.loads(path.read_text()))
                before = self._n_submits
                self.submit(spec)
                accepted += self._n_submits - before
                dest = self.inbox / "processed" / path.name
            # quarantine ANY spec-derived failure, not just the validated
            # ones: a type-malformed field that slips past validation
            # surfaces as TypeError (e.g. a string where a number belongs)
            # and must land in rejected/ instead of killing the daemon.
            # JSONDecodeError / JobSpecError / DuplicateJobSpec are
            # ValueError subclasses; infra errors (OSError) still raise.
            except (AdmissionRejected, TypeError, ValueError,
                    OverflowError) as e:
                dest = self.inbox / "rejected" / path.name
                (dest.parent / (path.name + ".error")).write_text(str(e))
            path.replace(dest)
        return accepted

    # -- the daemon loop ------------------------------------------------
    def tick(self, max_events: Optional[int] = None) -> int:
        """One scheduling tick: ingest the inbox, then advance the
        simulator by up to ``max_events`` events (default
        ``events_per_tick``), then batch-flush the journal and checkpoint
        if due.  Returns the amount of activity (events stepped + jobs
        accepted) so callers can idle-detect."""
        self.sim.begin()
        accepted = self.poll_inbox()
        stepped = self.sim.step_events(
            self.events_per_tick if max_events is None else max_events)
        self.journal.flush()
        self._events_since_snap += stepped
        # accepted submissions count too (submit() increments the same
        # counter): a submit-heavy quiet cluster — many journaled jobs,
        # zero stepped events per tick — must still snapshot, or its
        # recovery replay is unbounded.  The counter only moves with
        # activity and snapshot() resets it, so an idle daemon never
        # re-checkpoints.
        if self._events_since_snap >= self.snapshot_every:
            self.snapshot()
        return stepped + accepted

    def serve(self, *, tick_sleep: float = 0.05, throttle: float = 0.0,
              exit_when_idle: bool = False,
              max_ticks: Optional[int] = None) -> Optional[dict]:
        """Run the daemon loop.  ``exit_when_idle`` finalizes and returns
        the artifact once the simulator has drained and the inbox is
        empty; otherwise serve forever (``max_ticks`` bounds it for
        tests).  ``throttle`` sleeps after EVERY tick (not just idle
        ones) — it paces simulated time against real time, and gives the
        crash-recovery smoke a window to SIGKILL a busy daemon."""
        ticks = 0
        while max_ticks is None or ticks < max_ticks:
            active = self.tick()
            ticks += 1
            if throttle:
                time.sleep(throttle)
            if not active:
                if (exit_when_idle and self.sim.idle
                        and not self._inbox_has_specs()):
                    return self.finalize()
                time.sleep(tick_sleep)
        return None

    def _inbox_has_specs(self) -> bool:
        return self.inbox is not None and any(self.inbox.glob("*.json"))

    # -- durability -----------------------------------------------------
    def snapshot(self) -> pathlib.Path:
        """Checkpoint the full simulator state.  Atomic: pickle to a temp
        file, fsync, rename, then journal the (file, sha256, n_submits)
        record — a crash at any point leaves either a complete verified
        snapshot or none."""
        self._n_snapshots += 1
        name = f"snap-{self._n_snapshots:08d}.pkl"
        path = self.snap_dir / name
        data = self.sim.snapshot_bytes()
        tmp = path.with_suffix(".tmp")
        # write + fsync the data, rename, then fsync the directory: the
        # journaled marker below must never point at a snapshot whose
        # pages (or directory entry) could still be lost to a power cut —
        # rename-then-journal alone only orders the *names*, not the data
        with open(tmp, "wb") as fh:
            fh.write(data)
            fh.flush()
            os.fsync(fh.fileno())
        tmp.replace(path)
        dir_fd = os.open(self.snap_dir, os.O_RDONLY)
        try:
            os.fsync(dir_fd)
        finally:
            os.close(dir_fd)
        self.journal.append({
            "type": "snapshot", "t": self.sim.clock,
            "file": str(path.relative_to(self.state_dir)),
            "sha256": hashlib.sha256(data).hexdigest(),
            "n_submits": self._n_submits,
            # ledger counters ride the marker so recovery resumes the
            # accounting from the same instant the simulator does
            "ledger": self.ledger.as_dict(),
        }, durable=True)
        self._events_since_snap = 0
        return path

    def finalize(self) -> dict:
        """Summarize the run into the deterministic final artifact and
        write it (``artifact.json``, canonical bytes).  The digest of this
        file is the crash-recovery byte-identity claim."""
        art = {
            "schema": SERVICE_ARTIFACT_SCHEMA,
            "scenario": self.config["scenario"],
            "policy": self._policy,
            "seed": self.config["seed"],
            "overrides": self.config["overrides"],
            "config": self._scenario.config_dict(),
            "n_submitted": self._n_submits,
            "metrics": self.sim.results(),
        }
        if self.sim.source is not None:  # gated: legacy artifacts keep bytes
            art["stream_trace"] = True
            art["trace_source"] = self.sim.source.provenance()
        if self._mt_active:  # gated for the same reason
            art["tenants"] = self.ledger.as_dict()
        if self._admission is not None:
            n_adm = sum(1 for e in self._admission_log
                        if e["decision"] == "admit")
            art["admission"] = {
                "policy": self._admission.to_dict(),
                "n_admitted": n_adm,
                "n_rejected": len(self._admission_log) - n_adm,
                "log": list(self._admission_log),
            }
        out = self.state_dir / "artifact.json"
        tmp = out.with_suffix(".tmp")
        tmp.write_text(artifact_json(art))
        tmp.replace(out)
        return art

    # -- observability --------------------------------------------------
    def cluster_state(self) -> dict:
        """Live, read-only snapshot of the cluster: per-rack free GPUs,
        running/waiting jobs, failed machines, and the policy's current
        delay timers.  Guaranteed side-effect-free — delay timers go
        through ``AutoTuner.peek_timer``, never the schedule-affecting
        ``get_tuned_timer`` (see its docstring)."""
        sim, cl = self.sim, self.sim.cluster
        now = sim.clock
        job_name = {jid: name for name, jid in self._job_ids.items()}
        state = {
            "t": now,
            "total_gpus": cl.total_gpus,
            "free_gpus": cl.free_gpus(),
            "racks": [{"rack": r, "free_gpus": cl.rack_free(r)}
                      for r in range(cl.n_racks)],
            "failed_machines": cl.failed_machines(),
            "running": [{
                "job_id": j.job_id,
                "name": job_name.get(j.job_id),
                "model": j.model,
                "n_gpus": j.n_gpus,
                "tier": j.placement_tier,
                "iters_done": j.iters_done,
                "total_iters": j.total_iters,
            } for j in sim.running],
            "waiting": [{
                "job_id": j.job_id,
                "name": job_name.get(j.job_id),
                "model": j.model,
                "n_gpus": j.n_gpus,
                "waited_s": now - j.wait_since,
            } for j in sim.waiting],
            "n_finished": len(sim.finished),
            "n_rejected": len(sim.rejected),
        }
        if sim.telemetry is not None:
            # most recent per-machine busy/throughput + per-link effective
            # bandwidth sample (empty dicts before the first ROUND tick)
            state["telemetry"] = sim.telemetry.latest()
        if self._mt_active:
            # the live ledger: running/waiting GPUs and cumulative
            # GPU-seconds per tenant (read-only — plain counter copies)
            state["tenants"] = self.ledger.as_dict()
        tuner = getattr(sim.policy, "tuner", None)
        if tuner is not None:
            demands = sorted({j.n_gpus for j in sim.waiting})
            state["delay_timers"] = {
                str(g): {
                    "machine": (tuner.peek_timer("machine", g, now)
                                if g <= cl.gpus_per_machine else 0.0),
                    "rack": (tuner.peek_timer("rack", g, now)
                             if g <= cl.max_rack_capacity else 0.0),
                } for g in demands}
        return state

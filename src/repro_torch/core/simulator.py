"""Event-driven multi-job DL-cluster simulator (the ArtISt-sim analogue).

Iteration-level fidelity in the Themis sense: a job's progress is tracked in
iterations, and every (re)placement triggers a fresh per-iteration latency
query against the communication model — the dynamic "invoke ASTRA-sim per
placement" behaviour that distinguishes ArtISt-sim from static-penalty
simulators (paper §IV-C, Fig. 6).

Events: job arrival, scheduling round (period `round_period`), job
completion, optional machine-slowdown (straggler) events, and optional
machine FAIL/RECOVER events (hardware failures / maintenance churn).
Preemption saves (iters_done, optimizer state) and restores after
`restore_time` — the paper's checkpoint/resume contract (§IV-B).

A machine failure kills every placement intersecting it: the victims'
whole completed iterations survive (the per-iteration checkpoint), the
in-flight partial iteration since the last checkpoint is lost, and the
jobs re-enqueue with preemption semantics (wait/starvation clocks restart
at the crash instant) to pay `restore_time` + `checkpoint_overhead` when
they next start.  The machine's capacity is masked out of the topology's
O(1) indices while it is down, and surviving cross-rack contenders are
re-priced through the shared fabric (the contending set shrank).

With a shared-fabric model attached (``fabric``), jobs endogenously slow
each other down: whenever the set of cross-rack placements changes
(start / complete / preempt / migrate), every affected running job's
iteration time is re-priced at its new fair-share bandwidth — in-flight
progress at the old rate is folded in, and the job's COMPLETE event is
re-pushed through the existing versioning mechanism.

Service mode (incremental arrivals)
-----------------------------------
``run()`` is the closed-world batch entry: every job is submitted up
front and the loop drains the event heap.  A long-lived scheduler
(``repro_torch.service``) instead drives the same event loop incrementally:
``begin()`` arms the periodic-round chain once, ``submit()`` keeps
accepting jobs at any point (their ARRIVAL events must not lie in the
simulated past), and ``step_events()`` / ``advance_to()`` process the
heap in bounded chunks.  State after processing a given prefix of the
event sequence is *chunk-invariant* — events pop in a total order
``(t, kind, seq)`` that does not depend on how the processing was
batched — which is what makes the service's crash recovery a
byte-identity claim rather than a best-effort one.

``snapshot_bytes()`` / ``restore()`` capture and revive the complete
simulator state (pure-Python containers, exact floats) minus the
process-local hooks; a restored simulator continues bit-for-bit
identically to one that never stopped.  ``op_hook``, when set, receives
every externally-visible scheduling operation (placement, preemption,
crash, completion, machine fail/recover, rejection) — the write-ahead
journal seam, generalizing the per-event ``event_hook`` used by the
invariant test-suite.
"""
from __future__ import annotations

import heapq
import pickle
from bisect import insort
from operator import attrgetter
from time import perf_counter
from typing import Callable, Dict, List, Optional

from .commmodel import CommModel
from .fabric import FairShareFabric
from .job import PRIORITY_CLASSES, Job
from .metrics import Timeline, tenant_summary
from .profile import SimProfile
from .telemetry import Telemetry, link_key
from .topology import ClusterTopology

try:  # optional: the vectorized victim scan falls back to the scalar one
    import numpy as _np
except ImportError:  # pragma: no cover - numpy ships with the toolchain
    _np = None

ARRIVAL, ROUND, COMPLETE, SLOWDOWN, FAIL, RECOVER, DEGRADE = \
    0, 1, 2, 3, 4, 5, 6

_WAIT_KEY = attrgetter("_wait_key")

# below this many running jobs the scalar preemption scan beats numpy's
# array-construction overhead; a pure performance knob — both paths are
# bit-identical (the differential suite forces and compares each)
_VEC_MIN_VICTIMS = 128

# the top priority class: a victim scan gated at this class filters
# nothing, so it is the "no gate" default for legacy callers
_MAX_PRIORITY_CLASS = len(PRIORITY_CLASSES) - 1


class ClusterSimulator:
    def __init__(self, cluster: ClusterTopology, policy, comm: CommModel,
                 *, round_period: float = 300.0, restore_time: float = 30.0,
                 checkpoint_overhead: float = 0.0,
                 preemption_min_runtime: float = 1800.0,
                 max_preemptions_per_round: int = 4,
                 slowdown_events: Optional[List] = None,
                 failure_events: Optional[List] = None,
                 degradation_events: Optional[List] = None,
                 fabric: Optional[FairShareFabric] = None,
                 event_hook: Optional[Callable] = None,
                 profile: bool = False, telemetry: bool = False):
        self.cluster = cluster
        self.policy = policy
        self.comm = comm
        self.round_period = round_period
        self.restore_time = restore_time
        # extra checkpoint/restore cost charged when a preempted/migrated
        # job resumes (paper §IV-B: preemption is not free).  Default 0.0
        # keeps legacy artifacts byte-identical.
        self.checkpoint_overhead = checkpoint_overhead
        self.preemption_min_runtime = preemption_min_runtime
        self.max_preemptions_per_round = max_preemptions_per_round
        self.fabric = fabric
        # event_hook(sim, event_kind) runs after every processed event —
        # a debugging/testing seam (the invariant test-suite's probe); it
        # must not mutate the simulation
        self.event_hook = event_hook
        # op_hook(op, now, payload) observes every externally-visible
        # scheduling operation ("place" / "preempt" / "crash" /
        # "complete" / "machine_fail" / "machine_recover" / "reject") —
        # the service journal seam.  Like event_hook it must not mutate
        # the simulation; None (the default) costs nothing.
        self.op_hook: Optional[Callable] = None
        self._began = False  # begin() called (service-mode round chain)
        self._fabric_dirty = False
        self.n_reprices = 0
        # opt-in per-phase wall-time/call counters (see repro_torch.core.profile):
        # None (the default) keeps the hot loop at one `is None` check per
        # phase and results() byte-identical to the legacy schemas
        self.profile: Optional[SimProfile] = SimProfile() if profile else None
        # set when the run wedged: jobs still waiting but provably nothing
        # can ever run again (see _wedged_now) — surfaced in results()
        self.wedged = False

        self.clock = 0.0
        self.events: List = []
        self._seq = 0
        self.waiting: List[Job] = []
        self._waiting_dirty = False
        # jobs appended (unsorted) while the queue was dirty — preemption
        # victims and same-instant arrivals.  They are contiguous at the
        # tail of `waiting` (appends go to the end, removals keep relative
        # order), so the next round restores sorted order by merging this
        # short tail instead of re-sorting the whole queue
        self._dirty_tail: List[Job] = []
        self.running: List[Job] = []
        # running jobs on a rack-/network-tier placement — the only
        # upgrade/migration candidates; maintained incrementally so the
        # per-round policy scans skip the (large) machine-tier majority
        self.running_scattered: List[Job] = []
        self.finished: List[Job] = []
        self.rejected: List[Job] = []  # demand exceeds cluster capacity
        self.jobs: Dict[int, Job] = {}
        # True once any submitted job carries a parallelism plan: plan-only
        # policy machinery (Dally's rack-slot yielding) can skip its
        # per-round waiting-queue scan entirely on plan-less workloads
        self.any_plans = False
        # True once any submitted job names a tenant: gates the per-tenant
        # summary key in results(), so single-tenant (legacy) artifacts
        # keep their exact bytes
        self.any_tenants = False
        self.timeline = Timeline()
        self.machine_slowdown: Dict[int, float] = {}
        for t, machine, factor in (slowdown_events or []):
            self._push(t, SLOWDOWN, (machine, factor))
        # machine failure/maintenance schedule: (t, "fail"|"recover", m)
        # triples (see repro_torch.core.trace.make_mtbf_failures /
        # make_rolling_maintenance).  `failure_events is not None` — even
        # an empty list — marks the churn subsystem enabled, which gates
        # the failure keys in results() (failure-off artifacts must stay
        # byte-identical to the legacy schemas).
        self._failures_enabled = failure_events is not None
        self.n_machine_failures = 0
        self.n_job_failures = 0
        # machine -> {job_id: running job} victim index, maintained only
        # under a failure schedule: a FAIL event touches exactly its own
        # victims instead of scanning the (datacenter-scale) running set,
        # and failure-off runs pay nothing.  Insertion order is
        # deterministic, and victim order is observationally neutral
        # anyway (crashed jobs re-sort by priority key in the wait queue).
        self._jobs_on_machine: Dict[int, Dict[int, Job]] = {}
        # coalesce the post-churn scheduling round over a same-instant
        # burst (a maintenance batch boundary recovers one batch and
        # fails the next at the identical timestamp): react once, after
        # the last notice, not once per machine
        self._churn_dirty = False
        # pending RECOVER events: while any remain, capacity may still
        # grow, so a starved-but-stuck queue is not yet a wedge
        self._pending_recovers = 0
        for t, kind, machine in (failure_events or []):
            assert kind in ("fail", "recover"), kind
            if kind == "recover":
                self._pending_recovers += 1
            self._push(t, FAIL if kind == "fail" else RECOVER, machine)
        # analog degradation schedule: (t, "machine"|"link", target,
        # factor) tuples (see repro_torch.core.trace.make_straggler_degradations
        # and friends).  Machine events multiply the iteration time of
        # every job touching the machine; link events derate a fabric
        # link's capacity.  As with failures, `degradation_events is not
        # None` — even an empty list — marks the subsystem enabled, which
        # gates the degradation keys in results() (degradation-off
        # artifacts must stay byte-identical to the legacy schemas).
        self._degradation_enabled = degradation_events is not None
        self.machine_degrade: Dict[int, float] = {}
        # jobs owed a straggler re-price, coalesced over same-instant
        # DEGRADE bursts (a job spanning two machines degraded at the same
        # timestamp re-prices once) and drained at the _step tail after
        # any fabric re-price has settled the link loads
        self._degrade_due: Dict[int, Job] = {}
        self.n_degrade_events = 0
        self.n_degrade_reprices = 0
        self.n_straggler_evictions = 0
        for t, dkind, target, factor in (degradation_events or []):
            assert dkind in ("machine", "link"), dkind
            self._push(t, DEGRADE, (dkind, target, factor))
        # the per-machine victim index serves both FAIL (victim scan) and
        # machine-DEGRADE (re-price scan); runs with neither subsystem
        # enabled pay nothing
        self._track_machine_jobs = (self._failures_enabled
                                    or self._degradation_enabled)
        # opt-in Kalos-style per-interval telemetry (see
        # repro_torch.core.telemetry): sampled at every ROUND tick — the
        # Timeline's cadence — so the per-machine busy series sums exactly
        # to the aggregate busy series.  None (the default) keeps the hot
        # loop at one `is None` check and results() byte-identical.
        self.telemetry: Optional[Telemetry] = None
        if telemetry:
            machines = [m for m in range(cluster.n_machines)
                        if cluster.machine_capacity(m) > 0]
            links = ()
            if fabric is not None:
                links = tuple(("uplink", r)
                              for r in range(cluster.n_racks)) \
                    + (cluster.SPINE,)
            self.telemetry = Telemetry(machines,
                                       [link_key(li) for li in links])
            self._telemetry_links = links
            self._telemetry_index = {m: i for i, m in enumerate(machines)}
        self._completion_version: Dict[int, int] = {}
        self._pending_arrivals = 0
        # streaming ingestion (see repro_torch.core.trace_source): when a
        # source is attached, arrivals are pulled lazily — at most ONE
        # source ARRIVAL is in the heap at any time, re-armed as each
        # pops, which is bit-identical to pre-heaping the whole trace
        # (ARRIVAL's kind orders before every same-instant ROUND/COMPLETE
        # regardless of seq, and the source emits in submission order)
        self.source = None
        # constant-memory completion spill (see repro_torch.core.spill): when
        # attached, finished jobs fold into the streaming tally + JSONL
        # shards instead of accumulating in `finished`
        self._spill = None
        self._spill_tally = None
        # rejections are counted separately from the retained list so a
        # spilling run can drop the Job objects; without spill the
        # counter always equals len(self.rejected)
        self.n_rejected = 0

    # ------------------------------------------------------------------
    def _push(self, t, kind, payload):
        self._seq += 1
        heapq.heappush(self.events, (t, kind, self._seq, payload))

    def _op(self, op: str, now: float, **payload):
        if self.op_hook is not None:
            self.op_hook(op, now, payload)

    def submit(self, job: Job):
        assert job.job_id not in self.jobs, f"duplicate job_id {job.job_id}"
        # incremental (service-mode) submissions must not land in the
        # simulated past: the clock only moves forward, and an ARRIVAL
        # behind it would pop immediately with a time below every event
        # already processed.  Batch submissions always satisfy this
        # (clock == 0.0 until run() starts).
        assert job.arrival >= self.clock or not self._began, \
            f"job {job.job_id} arrival {job.arrival} < clock {self.clock}"
        if job.n_gpus > self.cluster.total_gpus:
            # can never be placed: admitting it would wedge the round loop
            # forever (every offer rejected, queue never drains)
            self._reject(job)
            return
        self.jobs[job.job_id] = job
        if job.plan is not None:
            self.any_plans = True
        if job.tenant is not None:
            self.any_tenants = True
        self._pending_arrivals += 1
        self._push(job.arrival, ARRIVAL, job.job_id)

    def _reject(self, job: Job):
        self.n_rejected += 1
        if self._spill is None:
            self.rejected.append(job)
        self._op("reject", self.clock, job_id=job.job_id,
                 n_gpus=job.n_gpus)

    # ------------------------------------------------------------------
    def attach_source(self, source) -> None:
        """Attach a streaming :class:`repro_torch.core.trace_source.TraceSource`
        (job lists are wrapped transparently): the lazy-ingestion
        alternative to submitting a materialized trace up front.  Must be
        attached before the run starts; the source's jobs must not
        overlap ids with anything submitted directly."""
        from .trace_source import as_source
        assert not self._began, "attach_source() before begin()/run()"
        assert self.source is None, "source already attached"
        self.source = as_source(source)
        if self.source.plans:
            # conservative hint (see TraceSource.plans): flipping the
            # fast-path flag early is decision-identical because the
            # plan-gated scans no-op on a queue with no actual plans
            self.any_plans = True
        self._pull_arrival()

    def _pull_arrival(self) -> None:
        """Advance the source cursor: admit the next job and arm its
        ARRIVAL event, skipping (and rejecting) unplaceable jobs exactly
        like batch-mode ``submit`` — which never put them in the heap
        either."""
        src = self.source
        while True:
            job = src.next_job()
            if job is None:
                return
            if job.n_gpus > self.cluster.total_gpus:
                self._reject(job)
                continue
            assert job.job_id not in self.jobs, \
                f"duplicate job_id {job.job_id}"
            self.jobs[job.job_id] = job
            if job.plan is not None:
                self.any_plans = True
            if job.tenant is not None:
                self.any_tenants = True
            self._pending_arrivals += 1
            self._push(job.arrival, ARRIVAL, job.job_id)
            return

    def attach_spill(self, writer) -> None:
        """Attach a :class:`repro_torch.core.spill.SpillWriter`: finished jobs
        stream to JSONL shards and fold into a
        :class:`repro_torch.core.metrics.FinishedTally` instead of accumulating
        in ``self.finished`` — ``results()`` is byte-identical either
        way.  Batch-mode only (``snapshot_bytes`` refuses while a spill
        writer is attached)."""
        from .metrics import FinishedTally
        assert self._spill is None, "spill writer already attached"
        assert not self.finished and not self.rejected, \
            "attach_spill() before any completions"
        self._spill = writer
        self._spill_tally = FinishedTally()

    def _enqueue(self, job: Job, now: float, tail: bool = False):
        """Insert into the wait queue.  When the policy's waiting
        priorities are static (see Policy contract) the priority key is
        computed once here, and a clean (sorted) queue takes the job at
        its sorted position — O(log n) comparisons, identical order to a
        stable re-sort because the key ends in the unique job_id.  A dirty
        queue (a preemption appended mid-round; the victim must stay at
        the tail so same-round re-offers reach it LAST, as they always
        have) just appends — the next round merges the tail back in
        (``_merge_dirty_tail``), order-identical to a full re-sort."""
        job._offer_hold = None  # fresh wait spell: any prior hold is void
        if self.policy.waiting_priority_static:
            job._wait_key = (self.policy.priority(job, now), job.arrival,
                             job.job_id)
            if tail or self._waiting_dirty:
                self._waiting_dirty = True
                self._dirty_tail.append(job)
            else:
                insort(self.waiting, job, key=_WAIT_KEY)
                return
        self.waiting.append(job)

    # ------------------------------------------------------------------
    def _slow_factor(self, placement) -> float:
        f = 1.0
        for m, _ in placement.alloc:
            f = max(f, self.machine_slowdown.get(m, 1.0))
        return f

    def _degrade_factor(self, placement) -> float:
        """Live straggler factor of a placement: the max over its
        currently degraded machines (a synchronous data-parallel step
        moves at the slowest participant's pace), 1.0 when healthy."""
        f = 1.0
        for m, _ in placement.alloc:
            f = max(f, self.machine_degrade.get(m, 1.0))
        return f

    def _start(self, job: Job, level: str, now: float):
        placement = self.cluster.allocate(job.n_gpus, level)
        assert placement is not None, (job.job_id, level)
        tier = placement.tier(self.cluster.machines_per_rack)
        self.policy.record_acceptance(job, tier, now)
        job.t_queue += now - job.wait_since
        job.placement = placement
        job.placement_tier = tier
        it, exposed = self.comm.iteration_time(
            job.model, job.compute_time_per_iter, placement,
            self.cluster.machines_per_rack, self.cluster.gpus_per_machine,
            plan=job.plan)
        # the slowdown factor is pinned at placement time (v1 semantics:
        # SLOWDOWN events only affect newly placed jobs); fabric re-pricing
        # reuses the pinned value so contention on/off stays a clean A/B
        job.slow_factor = self._slow_factor(placement)
        it *= job.slow_factor
        # unlike slow_factor, the degradation factor is LIVE: DEGRADE
        # events re-price running placements (see _reprice_degraded).
        # The separate guarded multiply keeps degradation-off floats
        # bit-identical (no combined product, no unconditional *= 1.0)
        job.degrade_factor = (self._degrade_factor(placement)
                              if self.machine_degrade else 1.0)
        if job.degrade_factor != 1.0:
            it *= job.degrade_factor
        job.iter_time = it
        job.exposed_comm_per_iter = exposed
        job.iters_frac = 0.0  # a fresh placement restarts its iteration
        # a restart after preemption/migration pays the restore delay plus
        # the checkpoint/restore overhead (zero by default)
        restore = (self.restore_time + self.checkpoint_overhead
                   if job.started_once else 0.0)
        job.run_start = now + restore
        job.started_once = True
        job.last_assignment_time = now
        self.wedged = False  # a placement is progress (service re-submits)
        self.running.append(job)
        if self._track_machine_jobs:
            for m, _ in placement.alloc:
                self._jobs_on_machine.setdefault(m, {})[job.job_id] = job
        if tier != "machine":
            self.running_scattered.append(job)
        # only cross-rack placements load fabric links: register with the
        # fabric's incremental membership (a network tier is exactly a
        # multi-rack placement, i.e. non-empty placement_links)
        if self.fabric is not None and tier == "network":
            if self.fabric.add_placement(job):
                self._fabric_dirty = True
        self.policy.note_place(job, self)
        self.waiting.remove(job)
        t_end = job.run_start + job.remaining_iters() * it
        v = self._completion_version.get(job.job_id, 0) + 1
        self._completion_version[job.job_id] = v
        self._push(t_end, COMPLETE, (job.job_id, v))
        self._op("place", now, job_id=job.job_id, tier=tier,
                 machines=[m for m, _ in placement.alloc],
                 restarted=job.preemptions + job.failures > 0)

    def _progress(self, job: Job, now: float):
        """Account the progress of a running job up to `now`.

        The re-price-carried partial iteration (``iters_frac``) counts
        towards the whole-iteration fold exactly as in ``_reprice``: a
        job at frac 0.8 that runs another 0.5 iterations has COMPLETED
        (and checkpointed) one whole iteration, which an eviction must
        not re-do.  Fabric-off runs always have frac == 0.0, so their
        arithmetic — and the pinned golden artifacts — are bit-identical."""
        elapsed = max(now - job.run_start, 0.0)
        done_f = elapsed / max(job.iter_time, 1e-9) + job.iters_frac
        iters = min(int(done_f), job.remaining_iters())
        job.iters_done += iters
        job.t_run += elapsed
        job.comm_time += iters * getattr(job, "exposed_comm_per_iter", 0.0)
        job.iters_frac = done_f - iters if job.remaining_iters() else 0.0
        job.run_start = now

    def _evict(self, job: Job, now: float):
        """Shared teardown of a running job's placement (preemption and
        machine-failure crash): fold progress, free the GPUs, invalidate
        the pending COMPLETE, and re-enqueue at the wait-queue tail."""
        self._progress(job, now)
        self._teardown_placement(job)
        self.cluster.release(job.placement)
        if job.placement_tier != "machine":
            self.running_scattered.remove(job)
        job.placement = None
        job.placement_tier = None
        self._completion_version[job.job_id] += 1  # invalidate completion
        self.running.remove(job)
        job.wait_since = now
        # starvation clock restarts: the job HELD resources until now, so its
        # wait towards the delay timers begins at the eviction instant
        # (otherwise run time would count as starvation and poison Algo 2's
        # wait-time lists)
        job.last_assignment_time = now
        self._enqueue(job, now, tail=True)

    def _teardown_placement(self, job: Job):
        """Shared index/fabric bookkeeping for a placement being torn down
        (while ``job.placement`` is still set): drop the job from the
        per-machine victim index, unregister it from the fabric's
        incremental membership, and notify the policy's candidate
        indices."""
        if self._track_machine_jobs:
            for m, _ in job.placement.alloc:
                del self._jobs_on_machine[m][job.job_id]
        if self.fabric is not None and job.placement_tier == "network":
            if self.fabric.remove_placement(job):
                self._fabric_dirty = True
        self.policy.note_evict(job, self)

    def preempt(self, job: Job, now: float):
        self._evict(job, now)
        job.preemptions += 1
        self._op("preempt", now, job_id=job.job_id)

    def _crash(self, job: Job, now: float):
        """The job's placement intersects a machine that just died.  Same
        resource teardown as preemption, with crash bookkeeping: the
        in-flight *partial* iteration since the last per-iteration
        checkpoint is lost (``_progress`` folds whole iterations only,
        and ``_start`` discards the residual fraction when the job next
        places — for crashes and preemptions alike), the wall time it
        took still counts in ``t_run`` (the GPUs were genuinely busy),
        and the loss is tallied under ``failures`` rather than
        ``preemptions`` — a crash is not a scheduling decision.  The
        restore surcharge (``restore_time + checkpoint_overhead``) is
        charged by ``_start`` when the job next places, exactly like a
        preemption restore."""
        self._evict(job, now)
        job.failures += 1
        self.n_job_failures += 1
        self._op("crash", now, job_id=job.job_id)

    def migrate(self, job: Job, level: str, now: float):
        """Migration = preempt + immediate restart at the given level."""
        self.preempt(job, now)
        self._start(job, level, now)

    def place(self, job: Job, level: str, now: float):
        """Place a WAITING job at the given consolidation level right now —
        the public entry for policies that hand out placements outside the
        offer loop (e.g. Dally's pattern-aware rack yielding).  The caller
        must have verified the level is allocatable."""
        self._start(job, level, now)

    TIER_ORDER = {"machine": 0, "rack": 1, "network": 2}

    def upgrade_level(self, job: Job) -> Optional[str]:
        """Best strictly-better consolidation level reachable for a running
        job using free GPUs + its own (released) allocation; None if none.

        Pure query: instead of the old release -> best_feasible_level ->
        retake round-trip (which re-indexed every machine of the placement
        twice per probe, every round, for every running job), the
        post-release capacity maxima are derived from the live indices —
        releasing a placement can only raise a machine/rack maximum
        through the machines/racks it actually touches."""
        cl = self.cluster
        cur = job.placement_tier
        if cur == "machine":
            return None
        g = job.n_gpus
        placement = job.placement
        alloc = placement.alloc
        free = cl.free
        if g <= cl.gpus_per_machine:
            mf = cl.max_free_on_machine()
            # per-machine walk gated by its necessary condition
            # (free[m] <= mf, so free[m] + c >= g needs mf + max_share
            # >= g): when the gate fails the walk is all-False anyway
            if mf >= g or (mf + placement.max_share >= g
                           and any(free[m] + c >= g for m, c in alloc)):
                return "machine"
        if cur == "network" and g <= cl.max_rack_capacity:
            mfr = cl.max_free_on_rack()
            if mfr >= g:
                return "rack"
            per_rack, max_rack_share = placement.rack_shares(
                cl.machines_per_rack)
            # same necessary-condition gate (rack_free(r) <= mfr)
            if (mfr + max_rack_share >= g
                    and any(cl.rack_free(r) + d >= g
                            for r, d in per_rack.items())):
                return "rack"
        # "network" can always re-host the job's own GPUs — never an upgrade
        return None

    def _preemption_victims(self, now: float, threshold: float, prio,
                            evictor_class: int = _MAX_PRIORITY_CLASS):
        """Running jobs eligible for preemption, worst (highest priority
        value) first.  The vectorized path scores the whole running set
        in one numpy batch (``Policy.priority_many`` — bit-identical
        elementwise IEEE ops) and stable-argsorts the negated scores,
        which reproduces ``sorted(key=lambda j: -prio(j))`` exactly,
        original-order tie-break included.  The scalar scan is retained
        as the no-numpy fallback and as the reference the differential
        suite pins the vector path against.

        ``evictor_class`` is the priority class of the waiting job doing
        the evicting: a running job of a strictly higher class is never a
        victim, regardless of its score (the preemption-class gate).  The
        default is the top class, i.e. no gate — and since every job's
        class defaults to ``DEFAULT_PRIORITY``, all-default populations
        filter identically to the ungated legacy scan."""
        min_rt = self.preemption_min_runtime
        # runtime + class eligibility first — attribute compares, much
        # cheaper than a priority score, and in high-churn regimes they
        # discard most of the running set before anything gets scored
        elig = [j for j in self.running
                if now - j.last_assignment_time > min_rt
                and j.priority <= evictor_class]
        if len(elig) >= _VEC_MIN_VICTIMS:
            prios = self.policy.priority_many(elig, now)
            if prios is not None:
                idx = _np.nonzero(prios > threshold)[0]
                order = idx[_np.argsort(-prios[idx], kind="stable")]
                return [elig[i] for i in order]
        return sorted((j for j in elig if prio(j) > threshold),
                      key=lambda j: -prio(j))

    # ------------------------------------------------------------------
    def _split_dirty_tail(self) -> int:
        """Index of the first dirty-tail job in ``waiting``.  Tail jobs
        are contiguous at the end: every dirty-window insert appended, and
        removals preserve relative order, so no sorted-prefix job can sit
        behind a tail job.  A tail job that was re-placed meanwhile simply
        isn't in the list any more; one preempted *again* re-enters via
        the tail append, never the prefix (insort is bypassed while
        dirty), so membership-by-id is exact."""
        w = self.waiting
        tail_ids = {j.job_id for j in self._dirty_tail}
        i = len(w)
        while i and w[i - 1].job_id in tail_ids:
            i -= 1
        return i

    def _merge_dirty_tail(self):
        """Restore sorted order by insort-merging the short dirty tail
        into the (still sorted) prefix.  Identical final order to
        ``waiting.sort(key=_WAIT_KEY)``: the key ends in the unique
        job_id, so it is a total order with exactly one sorted
        arrangement — but the merge costs O(k log n) comparisons for k
        tail jobs instead of n key extractions, which is what made deep
        dally-cell queues quadratic across preemption-heavy stretches."""
        w = self.waiting
        i = self._split_dirty_tail()
        tail = w[i:]
        del w[i:]
        tail.sort(key=_WAIT_KEY)
        for job in tail:
            insort(w, job, key=_WAIT_KEY)
        self._dirty_tail.clear()
        self._waiting_dirty = False

    def _dirty_top(self) -> Job:
        """``min(waiting, key=_WAIT_KEY)`` for a dirty queue without
        scanning the deep sorted prefix: the prefix minimum is its head,
        so only the short tail needs inspection.  Keys are unique, so
        min's first-minimum tie rule cannot diverge."""
        w = self.waiting
        i = self._split_dirty_tail()
        best = None
        for job in w[i:]:
            if best is None or job._wait_key < best._wait_key:
                best = job
        if i and (best is None or w[0]._wait_key < best._wait_key):
            best = w[0]
        return best

    # ------------------------------------------------------------------
    def _scheduling_round(self, now: float):
        prof = self.profile
        t_round = perf_counter() if prof is not None else 0.0
        self.policy.on_round(self, now)
        # priority(job, now) is stable within a round (fixed `now`; preempting
        # a job folds its in-flight progress into t_run, leaving the value at
        # `now` unchanged), so compute it at most once per job per round
        # instead of per sort-compare / min / victim scan
        prio_cache: Dict[int, float] = {}

        def prio(j):
            v = prio_cache.get(j.job_id)
            if v is None:
                v = self.policy.priority(j, now)
                prio_cache[j.job_id] = v
            return v

        # offers in increasing priority value; with static waiting
        # priorities _enqueue keeps the queue sorted through arrivals and
        # removals, so a sort only runs after a preemption appended to the
        # tail (C-level key extraction: keys live on the jobs)
        if self.policy.waiting_priority_static:
            if self._waiting_dirty:
                self._merge_dirty_tail()
        else:
            self.waiting.sort(key=lambda j: (prio(j), j.arrival, j.job_id))
        made_progress = True
        preempted = 0
        while made_progress:
            made_progress = False
            # single pass per iteration; placements only shrink the free
            # pool, so jobs whose demand exceeds it are skipped with an O(1)
            # check instead of a full policy/availability probe — and a
            # fully busy cluster (free == 0, the steady state of every
            # congested regime) skips the whole pass, which is what keeps
            # rounds sublinear in queue depth at datacenter scale.  Anything
            # that frees or re-prices resources (preemption below, delay-
            # timer updates from acceptances) re-arms the outer loop.
            free = self.cluster.free_gpus()
            if free > 0:
                t_offer = perf_counter() if prof is not None else 0.0
                # offer-hold fast path: a job whose last timer rejection
                # is provably still in force is skipped without the full
                # on_offer probe.  This is the INLINED twin of the
                # reference predicate Policy.offer_held (the hold tuple
                # is standardized there) — at datacenter scale it runs
                # millions of times per simulation and the call frames
                # alone (offer_held -> starvation -> max) were ~30% of
                # the pass, so the checks live in the loop body.  Any
                # change here must mirror Policy.offer_held exactly.
                cl = self.cluster
                rack_cap = cl.max_rack_capacity
                on_offer = self.policy.on_offer
                # capacity maxima only move when an allocation does —
                # i.e. at _start below — so they are loop constants
                # between placements, not per-job queries
                mm = cl.max_free_on_machine()
                mr = cl.max_free_on_rack()
                for job in list(self.waiting):
                    g = job.n_gpus
                    if g > free:
                        continue  # cannot fit at any tier: skip the probe
                    hold = job._offer_hold
                    if hold is not None:
                        (vu, dep), limit, is_rack = hold
                        if (now <= vu
                                and (dep is None
                                     or dep[0].get(dep[1], 0) == dep[2])
                                and mm < g
                                and (not is_rack
                                     or (mr < g and g <= rack_cap))):
                            ref = job.last_assignment_time
                            if ref is None:
                                ref = job.arrival
                            # starvation(now) < limit, frames elided:
                            # max(x, 0.0) and this compare agree for
                            # every x (limit > 0 whenever a hold exists)
                            if now - ref < limit:
                                continue  # rejection provably stands
                    level = on_offer(job, self, now)
                    if level is not None:
                        self._start(job, level, now)
                        free = self.cluster.free_gpus()
                        mm = cl.max_free_on_machine()
                        mr = cl.max_free_on_rack()
                        made_progress = True
                if prof is not None:
                    prof.add("offer_pass", perf_counter() - t_offer)
            # network-sensitive preemption: if the most-starved waiting job
            # cannot be placed at all, evict running jobs whose priority
            # value exceeds the waiting job's by a margin (hysteresis against
            # preemption thrash), oldest-runtime-eligible, worst-first
            if (self.waiting and self.policy.preemption_enabled
                    and preempted < self.max_preemptions_per_round):
                if (self.policy.waiting_priority_static
                        and not self._waiting_dirty):
                    top = self.waiting[0]  # sorted; removals keep order
                elif self.policy.waiting_priority_static:
                    # dirty only within a round that already preempted
                    top = self._dirty_top()
                else:
                    top = min(self.waiting,
                              key=lambda j: (prio(j), j.arrival, j.job_id))
                if self.cluster.free_gpus() < top.n_gpus:
                    t_scan = perf_counter() if prof is not None else 0.0
                    top_p = prio(top)
                    # eligibility anchors on when the job was ASSIGNED its
                    # resources, not on run_start: _progress/_reprice reset
                    # run_start at every fold, so under shared-fabric
                    # contention a re-priced job's clock restarted forever
                    # and preemption never tripped — exactly the congested
                    # regime it exists for
                    victims = self._preemption_victims(
                        now, top_p + self.policy.preemption_margin, prio,
                        evictor_class=top.priority)
                    if prof is not None:
                        prof.add("preemption_scan", perf_counter() - t_scan)
                    freed = self.cluster.free_gpus()
                    for v in victims:
                        if (freed >= top.n_gpus or
                                preempted >= self.max_preemptions_per_round):
                            break
                        self.preempt(v, now)
                        preempted += 1
                        freed += v.n_gpus
                        made_progress = True
        if prof is not None:
            prof.add("scheduling_round", perf_counter() - t_round)

    # ------------------------------------------------------------------
    def _reprice(self, now: float):
        """Shared-fabric re-pricing: the cross-rack contending set changed,
        so recompute every running job's fair-share bandwidth and re-push
        the COMPLETE event of each job whose iteration time changed.

        Progress at the old rate is folded in exactly: the in-flight
        *partial* iteration is carried in ``iters_frac`` and scales over to
        the new rate (a repriced job never stopped running, so unlike
        preemption it must not re-do its current iteration).  A job
        mid-restore keeps its future ``run_start`` (its restore delay must
        survive re-pricing) and simply resumes at the new rate.  The
        machine-slowdown factor pinned at placement time is reused — v1
        semantics apply SLOWDOWN events only to new placements, and fabric
        churn must not retroactively change that.

        Incremental: the fabric's membership indices (updated at every
        place/teardown) yield exactly the jobs whose share may have
        changed — the members of the links the churn touched — so one
        placement change re-prices its own contention neighbourhood, not
        the whole network-tier fleet.  A job absent from the affected set
        has an unchanged share, hence an unchanged (memoized) iteration
        time, hence would have hit the ``it == job.iter_time`` skip below
        anyway: skipping it up front is decision-identical (and keeps
        ``n_reprices`` exact).  ``FairShareFabric.fair_shares`` remains
        the reference recompute path; the differential suite pins
        ``share_of`` bit-identical to it after every event."""
        prof = self.profile
        t0 = perf_counter() if prof is not None else 0.0
        fabric = self.fabric
        affected = fabric.take_affected()
        for job in self.running_scattered:
            # running_scattered preserves running order, minus the
            # machine-tier majority that made every reprice O(running)
            if job.placement_tier != "network":
                continue
            if job.job_id not in affected:
                continue
            it, exposed = self.comm.iteration_time(
                job.model, job.compute_time_per_iter, job.placement,
                self.cluster.machines_per_rack,
                self.cluster.gpus_per_machine,
                internode_bw=fabric.share_of(job.job_id),
                plan=job.plan)
            it *= job.slow_factor
            if job.degrade_factor != 1.0:
                it *= job.degrade_factor
            if it == job.iter_time:
                continue
            if now > job.run_start:
                # the guard matters: a job mid-restore has run_start in
                # the future, and folding would erase its restore delay
                self._progress(job, now)
            job.iter_time = it
            job.exposed_comm_per_iter = exposed
            v = self._completion_version[job.job_id] + 1
            self._completion_version[job.job_id] = v
            remaining = max(job.remaining_iters() - job.iters_frac, 0.0)
            self._push(max(job.run_start, now) + remaining * it,
                       COMPLETE, (job.job_id, v))
            self.n_reprices += 1
        if prof is not None:
            prof.add("reprice", perf_counter() - t0)

    def _reprice_degraded(self, now: float):
        """Straggler re-pricing: machine degradation factors changed, so
        re-price exactly the jobs placed on the touched machines (queued
        in ``_degrade_due`` by the DEGRADE handler via the per-machine
        index — never a scan of the running set).  Mirrors ``_reprice``'s
        exact-fold contract: in-flight partial iterations carry over in
        ``iters_frac``, a job mid-restore keeps its future ``run_start``,
        and an unchanged iteration time is skipped without touching the
        event heap.  Runs at the ``_step`` tail AFTER any fabric re-price
        has settled the link loads, so a degraded cross-rack job is
        priced at its current fair share and its current straggler factor
        in one pass."""
        prof = self.profile
        t0 = perf_counter() if prof is not None else 0.0
        due = self._degrade_due
        self._degrade_due = {}
        for job in due.values():
            if job.placement is None:
                continue  # evicted or completed since it was queued
            factor = self._degrade_factor(job.placement)
            if factor == job.degrade_factor:
                continue
            job.degrade_factor = factor
            if self.fabric is not None and job.placement_tier == "network":
                it, exposed = self.comm.iteration_time(
                    job.model, job.compute_time_per_iter, job.placement,
                    self.cluster.machines_per_rack,
                    self.cluster.gpus_per_machine,
                    internode_bw=self.fabric.share_of(job.job_id),
                    plan=job.plan)
            else:
                it, exposed = self.comm.iteration_time(
                    job.model, job.compute_time_per_iter, job.placement,
                    self.cluster.machines_per_rack,
                    self.cluster.gpus_per_machine, plan=job.plan)
            it *= job.slow_factor
            if factor != 1.0:
                it *= factor
            if it == job.iter_time:
                continue
            if now > job.run_start:
                self._progress(job, now)
            job.iter_time = it
            job.exposed_comm_per_iter = exposed
            v = self._completion_version[job.job_id] + 1
            self._completion_version[job.job_id] = v
            remaining = max(job.remaining_iters() - job.iters_frac, 0.0)
            self._push(max(job.run_start, now) + remaining * it,
                       COMPLETE, (job.job_id, v))
            self.n_degrade_reprices += 1
        if prof is not None:
            prof.add("reprice_degraded", perf_counter() - t0)

    def _record_telemetry(self, t: float):
        """Sample the per-machine/per-link series (telemetry enabled
        only).  Busy GPUs are derived from the running jobs' allocations,
        which sum exactly to the Timeline's aggregate busy count (busy =
        total - free - failed, and failed machines hold no allocations);
        each job's iteration throughput is split across its machines by
        GPU share."""
        tel = self.telemetry
        idx = self._telemetry_index
        busy = [0] * len(tel.machines)
        rate = [0.0] * len(tel.machines)
        for job in self.running:
            it = job.iter_time
            for m, c in job.placement.alloc:
                i = idx[m]
                busy[i] += c
                if it > 0.0:
                    rate[i] += (c / job.n_gpus) / it
        link_bw = {}
        if self.fabric is not None:
            for link in self._telemetry_links:
                link_bw[link_key(link)] = \
                    self.fabric.effective_bandwidth(link)
        tel.record(t, busy, rate, link_bw)

    # ------------------------------------------------------------------
    def run(self, max_time: float = float("inf")) -> Dict:
        """Closed-world batch run: drain the event heap (or stop at the
        ``max_time`` horizon, folding in-flight progress) and summarize."""
        self.begin()
        while self.events:
            if self.events[0][0] > max_time:
                # truncated run: account in-flight jobs' progress up to the
                # horizon, else their t_run/comm_time are silently dropped
                # from results()
                self.clock = max(self.clock, min(max_time, self.events[0][0]))
                for job in self.running:
                    self._progress(job, self.clock)
                # ... and record the horizon Timeline sample: without it the
                # timeline (and avg_utilization) of a truncated cell ended at
                # the last ROUND tick, under-reporting the final stretch.
                # Skip only if a sample already exists at this exact instant
                # (max_time landing on a processed ROUND tick).
                if not self.timeline.t or self.timeline.t[-1] < self.clock:
                    self.timeline.record(
                        self.clock,
                        self.cluster.total_gpus - self.cluster.free_gpus()
                        - self.cluster.failed_gpus(),
                        self.cluster.total_gpus,
                        len(self.waiting) + len(self.running))
                    if self.telemetry is not None:
                        # the telemetry horizon sample mirrors (and is
                        # gated exactly like) the Timeline's, keeping the
                        # two series aligned sample-for-sample
                        self._record_telemetry(self.clock)
                break
            self._step()
        return self.results()

    def begin(self) -> None:
        """Arm the periodic-round chain (idempotent).  ``run()`` calls it;
        a service loop calls it once and then drives ``step_events()`` /
        ``advance_to()`` with ``submit()`` interleaved."""
        if not self._began:
            self._began = True
            self._push(self.clock, ROUND, None)

    def step_events(self, n: int) -> int:
        """Process up to ``n`` events; returns how many were processed.
        The resulting state depends only on the *prefix* of the event
        sequence processed so far, never on the chunking."""
        done = 0
        while done < n and self.events:
            self._step()
            done += 1
        return done

    def advance_to(self, t: float) -> int:
        """Process every event with timestamp strictly BEFORE ``t``, then
        move the clock to ``t`` (so a service can clamp incoming arrivals
        against a monotone notion of "now" even across quiet stretches).
        Events AT ``t`` stay pending deliberately: a submission arriving
        exactly at ``t`` must still order against them by event *kind* in
        the heap — processing them here would let a same-time ROUND jump
        ahead of the ARRIVAL, which batch mode orders the other way.
        Returns the number of events processed."""
        done = 0
        while self.events and self.events[0][0] < t:
            self._step()
            done += 1
        self.clock = max(self.clock, t)
        return done

    @property
    def idle(self) -> bool:
        """True when nothing is left to simulate: no queued events (the
        round chain dies when no work remains) and no live jobs."""
        return not self.events and not self.waiting and not self.running \
            and not self._pending_arrivals

    def _step(self):
        """Pop and process exactly one event (the body of the batch loop,
        shared verbatim by the incremental service entries)."""
        t, kind, _, payload = heapq.heappop(self.events)
        self.clock = t
        if kind == ARRIVAL:
            job = self.jobs[payload]
            job.wait_since = t
            self._pending_arrivals -= 1
            if self.source is not None:
                # re-arm the single in-flight source arrival BEFORE the
                # round runs: its timestamp is >= t (sources emit in
                # submission order), so it cannot affect this round, and
                # the heap again holds exactly one source ARRIVAL
                self._pull_arrival()
            self._enqueue(job, t)
            self._scheduling_round(t)
        elif kind == ROUND:
            # running jobs alone are enough to owe a round: the
            # policy's per-round consolidation upgrades and rack
            # yields (§VI-3) must not stall on a quiet cluster until
            # the next arrival or completion
            if self.waiting or self.running:
                self._scheduling_round(t)
            # busy = total - free - failed: a dead machine's masked
            # GPUs are neither free nor doing work, so counting them
            # busy would inflate utilization for every churn cell
            # (failed == 0 on churn-free clusters: bytes unchanged)
            self.timeline.record(
                t, self.cluster.total_gpus - self.cluster.free_gpus()
                - self.cluster.failed_gpus(),
                self.cluster.total_gpus,
                len(self.waiting) + len(self.running))
            # re-arm only while work exists or is still due: pending
            # SLOWDOWN events alone (e.g. a long contention schedule)
            # must not keep the clock — and the idle-sample timeline —
            # running after the last job finished
            if self.waiting or self.running or self._pending_arrivals:
                if self._wedged_now():
                    self.wedged = True
                else:
                    self._push(t + self.round_period, ROUND, None)
        elif kind == COMPLETE:
            job_id, version = payload
            if self._completion_version.get(job_id) != version:
                # stale (job was preempted since): drop it without firing
                # the event_hook or the empty-heap round re-arm — exactly
                # the `continue` of the original batch loop
                return
            job = self.jobs[job_id]
            self._progress(job, t)
            job.iters_done = job.total_iters
            job.finish_time = t
            self._teardown_placement(job)
            self.cluster.release(job.placement)
            if job.placement_tier != "machine":
                self.running_scattered.remove(job)
            job.placement = None
            job.placement_tier = None
            self.running.remove(job)
            if self._spill is None:
                self.finished.append(job)
            else:
                # constant-memory path: fold the completion into the
                # streaming tally, spill the full record, and drop the
                # Job.  Deleting the jobs-table entry is safe: a stale
                # COMPLETE for this id fails the version check (.get on
                # a missing key) before it ever touches self.jobs.
                from .spill import finished_record
                self._spill_tally.add(job)
                self._spill.write(finished_record(job))
                del self.jobs[job_id]
                del self._completion_version[job_id]
            self._op("complete", t, job_id=job.job_id,
                     jct=t - job.arrival)
            self._scheduling_round(t)
        elif kind == SLOWDOWN:
            machine, factor = payload
            self.machine_slowdown[machine] = factor
        elif kind == FAIL:
            # idempotent: a duplicate failure notice for an already-
            # dead machine is dropped (arbitrary schedule interleavings
            # — overlapping maintenance + hardware faults — stay safe)
            if not self.cluster.is_failed(payload):
                self.n_machine_failures += 1
                victims = list(
                    self._jobs_on_machine.get(payload, {}).values())
                self._op("machine_fail", t, machine=payload,
                         n_victims=len(victims))
                for job in victims:
                    self._crash(job, t)
                self.cluster.fail_machine(payload)
                self._churn_dirty = True
        elif kind == RECOVER:
            self._pending_recovers -= 1
            if self.cluster.is_failed(payload):
                self.cluster.recover_machine(payload)
                self._op("machine_recover", t, machine=payload)
                self._churn_dirty = True
        elif kind == DEGRADE:
            dkind, target, factor = payload
            self.n_degrade_events += 1
            if dkind == "machine":
                if factor == 1.0:
                    self.machine_degrade.pop(target, None)
                else:
                    self.machine_degrade[target] = factor
                # queue the machine's current residents for a re-price
                # (drained at the tail, coalesced over same-instant
                # bursts); recoveries queue too — the factor must come
                # back DOWN for jobs riding out the episode
                for job in self._jobs_on_machine.get(target, {}).values():
                    self._degrade_due[job.job_id] = job
            elif self.fabric is not None:
                # link derating composes with fair-share contention
                # inside the fabric's _capacity seam; affected members
                # re-price through the ordinary fabric path below.
                # Without a fabric there is no link to derate — the
                # scenario layer rejects that combination up front.
                if self.fabric.set_derate(target, factor):
                    self._fabric_dirty = True
        if self._churn_dirty and not (
                self.events and self.events[0][0] == t
                and self.events[0][1] in (FAIL, RECOVER)):
            # capacity changed: victims re-place (elsewhere) right
            # away if anything fits, waiting jobs and consolidation
            # upgrades claim fresh capacity, and the shrunk cluster
            # may demand preemptions — without stalling until the
            # next round tick.  The round runs ONCE per same-instant
            # churn burst (after its last event): a zero-gap
            # maintenance handoff recovers one batch and fails the
            # next at the identical timestamp, and reacting mid-burst
            # would schedule against the transiently doubled outage.
            self._churn_dirty = False
            if self.waiting or self.running:
                self._scheduling_round(t)
        if self._fabric_dirty:
            self._fabric_dirty = False
            self._reprice(t)
        if self._degrade_due and not (
                self.events and self.events[0][0] == t
                and self.events[0][1] == DEGRADE):
            # straggler re-price once per same-instant DEGRADE burst,
            # after the fabric re-price settled the link loads
            self._reprice_degraded(t)
        if self.telemetry is not None and kind == ROUND:
            # sampled at the tail so the tick's re-prices are reflected;
            # occupancy hasn't changed since the Timeline sample above,
            # so the per-machine busy rows sum exactly to it
            self._record_telemetry(t)
        if self.profile is not None:
            # live-depth gauges (max-keeping): the constant-memory claim
            # is exactly "these stay bounded while the trace grows"
            prof = self.profile
            prof.gauge("event_queue_depth", len(self.events))
            prof.gauge("wait_queue_depth", len(self.waiting))
            prof.gauge("running_jobs", len(self.running))
        if self.event_hook is not None:
            self.event_hook(self, kind)
        if not self.events and (self.waiting or self.running):
            if self._wedged_now():
                self.wedged = True
            else:
                self._push(self.clock + self.round_period, ROUND, None)

    def _wedged_now(self) -> bool:
        """True when the simulation can provably never make progress
        again: jobs wait, nothing runs, no arrivals or machine recoveries
        are pending, and no waiting job's demand fits the surviving free
        capacity.  Every future round is then a no-op (offers need
        ``free >= n_gpus``; preemption and migrations need running
        victims; pending FAIL/SLOWDOWN events can only shrink capacity or
        tag future placements), so re-arming the ROUND chain would spin
        forever — the hang a failure schedule whose tail leaves machines
        dead used to cause.  Conservative by design: any state from which
        the old loop eventually terminated returns False, so terminating
        schedules are untouched."""
        if self.running or not self.waiting or self._pending_arrivals \
                or self._pending_recovers:
            return False
        free = self.cluster.free_gpus()
        return all(j.n_gpus > free for j in self.waiting)

    # ------------------------------------------------------------------
    def snapshot_bytes(self) -> bytes:
        """Serialize the complete simulator state (exact floats, preserved
        container orders — a restored simulator continues bit-for-bit).
        The process-local hooks are excluded: a journal/probe closure
        belongs to the process, not the state.  A streaming trace source
        rides along — its cursor state is plain picklable data — so a
        restored service-mode simulator keeps pulling from exactly where
        it stopped.  A spill writer does NOT (open handles, rolling
        hashes): spilling is batch-only and refused here."""
        if self._spill is not None:
            raise RuntimeError(
                "snapshot_bytes() with a spill writer attached: spilling "
                "is a batch-mode feature (open shard handles and rolling "
                "hashes have no snapshot semantics)")
        event_hook, op_hook = self.event_hook, self.op_hook
        self.event_hook = self.op_hook = None
        try:
            # fixed protocol: snapshot bytes must not depend on the Python
            # version's default (they are digest-checked on recovery)
            return pickle.dumps(self, protocol=4)
        finally:
            self.event_hook, self.op_hook = event_hook, op_hook

    @classmethod
    def restore(cls, data: bytes, *, event_hook: Optional[Callable] = None,
                op_hook: Optional[Callable] = None) -> "ClusterSimulator":
        """Revive a simulator from ``snapshot_bytes()`` output and re-attach
        the (process-local) hooks."""
        sim = pickle.loads(data)
        assert isinstance(sim, ClusterSimulator), type(sim)
        sim.event_hook = event_hook
        sim.op_hook = op_hook
        return sim

    # ------------------------------------------------------------------
    def results(self) -> Dict:
        from .metrics import summarize
        if self._spill is not None:
            # streaming aggregation: the tally folded every completion in
            # the same order `finished` would have appended, so this dict
            # is byte-identical to the materialized branch below
            out = self._spill_tally.summarize(
                self.timeline, unfinished=self.running + self.waiting)
            out["spill"] = self._spill.manifest()
        else:
            out = summarize(self.finished, self.timeline,
                            unfinished=self.running + self.waiting)
        out["n_rejected"] = self.n_rejected
        if self.any_tenants and self._spill is None:
            # only when some job actually named a tenant: single-tenant
            # (legacy) artifacts keep their exact bytes.  Spill runs drop
            # finished jobs from memory, so the per-tenant fold is a
            # materialized-mode surface (as is the ledger in the service).
            out["tenants"] = tenant_summary(self.jobs.values())
        if self.fabric is not None:
            # only under a shared fabric: adding the key unconditionally
            # would break v1 artifact byte-compatibility
            out["n_reprices"] = self.n_reprices
        if self._failures_enabled:
            # only under a failure schedule, for the same reason
            out["n_machine_failures"] = self.n_machine_failures
            out["n_job_failures"] = self.n_job_failures
        if self._degradation_enabled:
            # only under a degradation schedule, for the same reason
            out["n_degrade_events"] = self.n_degrade_events
            out["n_degrade_reprices"] = self.n_degrade_reprices
            out["n_straggler_evictions"] = self.n_straggler_evictions
        if self.telemetry is not None:
            # opt-in Kalos-style per-interval series (schema-stamped wire
            # form; see repro_torch.core.telemetry)
            out["telemetry"] = self.telemetry.as_dict()
        if self.wedged:
            # the run terminated with jobs that can provably never place
            # again (failure-schedule tail left the capacity short); only
            # emitted when it happened, so terminating artifacts keep
            # their legacy bytes
            out["wedged"] = True
        if self.profile is not None:
            # opt-in (see repro_torch.core.profile): wall-clock values — callers
            # that need deterministic artifacts must treat it as volatile
            try:
                import resource
                self.profile.gauge(
                    "peak_rss_kb",
                    resource.getrusage(resource.RUSAGE_SELF).ru_maxrss)
            except ImportError:  # pragma: no cover - non-POSIX
                pass
            out["profile"] = self.profile.as_dict()
            if self.profile.gauges:
                out["profile_gauges"] = dict(
                    sorted(self.profile.gauges.items()))
        return out

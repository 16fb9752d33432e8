"""Streaming trace sources: constant-memory job ingestion.

Every trace maker in :mod:`trace` returns a materialized ``List[Job]`` —
fine at 500 jobs, hopeless at the million-job scale of real public
traces (Alibaba PAI GPU-2020 ships ~1.2M task instances).  A
``TraceSource`` is the streaming alternative: an ordered cursor over
jobs in submission order (arrival ascending, ``job_id`` breaking ties)
that the simulator pulls from lazily as simulated time advances, so at
any instant only the jobs currently *inside* the cluster are alive in
memory.

The contract:

* ``peek_arrival()`` — arrival time of the next job without consuming
  it (``None`` when exhausted).  Implemented with a one-job lookahead
  buffer so single-rng generators (whose next arrival is only known by
  sampling the whole job) stay O(1) memory.
* ``next_job()`` — pop the next job (``None`` when exhausted).
* iteration — ``for job in source`` drains the cursor.
* ``len(source)`` — total job count, when knowable.
* ``plans`` — hint that jobs may carry a ``ParallelPlan``; feeds the
  simulator's ``any_plans`` fast path.  May be conservatively ``True``
  (the dally rack-yield scan no-ops on a plan-less queue), never
  falsely ``False``.
* ``provenance()`` — a JSON-safe dict recorded in schema-v6 artifacts.

All sources pickle (explicit ``random.Random`` objects and compact
``array`` state, no live generators or file handles), so a simulator
snapshot carries its source cursor and service crash recovery replays
byte-identically.

The synthetic ``Streaming*Trace`` twins reproduce their materialized
maker's seeded output *byte-identically* (pinned against the
reference's by ``tests/test_torch_trace_source.py``): the arrival process and the per-job
draws either use independent rng instances (batch/poisson/philly) or
interleave in the maker's exact draw order (mixed).  ``bursty`` has no
streaming twin — its flash crowds require a whole-trace sort — and is
wrapped via :class:`MaterializedTrace` instead.

The port's copy of the JAX package's ``repro.core.trace_source``, line for
line but for its imports and the default hardware profile of the makers
and adapters: ``NVIDIA_PAPER``, as in :mod:`trace` (the port holds no TPU
profile).
"""
from __future__ import annotations

import csv
import hashlib
import math
import random
from array import array
from typing import Iterator, List, Optional, Sequence

from repro_torch.types import NVIDIA_PAPER, HardwareProfile

from .job import Job
from .trace import (
    GPU_DEMAND_PMF,
    PHILLY_GPU_PMF,
    _cached_skew,
    _check_parallelism,
    _col,
    _filter_archs,
    _job_from_row,
    _parse_time,
    _sample_job,
    _sample_mixed_job,
    compute_time_per_iter,
)


class TraceSource:
    """Base class: subclasses implement ``_next() -> Optional[Job]`` and
    hold explicit (picklable) cursor state; the base provides the
    one-job lookahead buffer behind ``peek_arrival``/``next_job``."""

    #: may any job carry a ParallelPlan?  Conservative-True is allowed.
    plans: bool = False

    def __init__(self):
        self._buf: Optional[Job] = None
        self._primed = False

    # -- subclass surface ---------------------------------------------------
    def _next(self) -> Optional[Job]:
        raise NotImplementedError

    def provenance(self) -> dict:
        """JSON-safe source description, recorded in v6 artifacts."""
        return {"kind": type(self).__name__}

    # -- cursor -------------------------------------------------------------
    def _prime(self) -> None:
        if not self._primed:
            self._buf = self._next()
            self._primed = True

    def peek_arrival(self) -> Optional[float]:
        self._prime()
        return None if self._buf is None else self._buf.arrival

    def next_job(self) -> Optional[Job]:
        self._prime()
        job, self._buf = self._buf, None
        if job is not None:
            self._buf = self._next()
        return job

    def __iter__(self) -> Iterator[Job]:
        while True:
            job = self.next_job()
            if job is None:
                return
            yield job


class MaterializedTrace(TraceSource):
    """A ``List[Job]`` wrapped as a source.  Jobs are emitted in heap
    pop order of the materialized path — arrival ascending, insertion
    order breaking ties (a stable sort, the identity permutation for
    every trace maker's already-ordered output) — so lazy ingestion is
    bit-identical to pre-heaping all ARRIVALs."""

    def __init__(self, jobs: Sequence[Job]):
        super().__init__()
        self.jobs: List[Job] = sorted(jobs, key=lambda j: j.arrival)
        self._pos = 0
        self.plans = any(j.plan is not None for j in self.jobs)

    def _next(self) -> Optional[Job]:
        if self._pos >= len(self.jobs):
            return None
        job = self.jobs[self._pos]
        self._pos += 1
        return job

    def __len__(self) -> int:
        return len(self.jobs)

    def provenance(self) -> dict:
        return {"kind": "materialized", "n_jobs": len(self.jobs)}


def as_source(trace) -> TraceSource:
    """Wrap a job list transparently; pass sources through unchanged."""
    if isinstance(trace, TraceSource):
        return trace
    return MaterializedTrace(trace)


# ---------------------------------------------------------------------------
# Streaming twins of the synthetic makers
# ---------------------------------------------------------------------------

class _SyntheticSource(TraceSource):
    """Shared scaffolding: arch filtering, job counter, provenance."""

    kind = "synthetic"

    def __init__(self, archs: Sequence, n_jobs: int, seed: int,
                 parallelism=None, families=None):
        super().__init__()
        _check_parallelism(parallelism)
        self.n_jobs = int(n_jobs)
        self.seed = int(seed)
        self._arch_list = _filter_archs(archs, families)
        self._parallelism = parallelism
        self._i = 0
        # plan_for() may return None for every job in a trace (small
        # demands never get plans), so this hint can be conservatively
        # True under "auto"; the rack-yield scan it gates is a no-op
        # when no waiting job actually carries a plan.
        self.plans = parallelism is not None

    def __len__(self) -> int:
        return self.n_jobs

    def provenance(self) -> dict:
        return {"kind": self.kind, "n_jobs": self.n_jobs, "seed": self.seed}


class StreamingBatchTrace(_SyntheticSource):
    """Streaming twin of ``make_batch_trace`` (all arrivals at t=0)."""

    kind = "batch-stream"

    def __init__(self, archs: Sequence, n_jobs: int = 500, seed: int = 0,
                 median_gpu_hours: float = 2.0, sigma: float = 1.2,
                 profile: HardwareProfile = NVIDIA_PAPER,
                 parallelism=None, families=None,
                 demand_pmf=None, gpus_per_machine: int = 8):
        super().__init__(archs, n_jobs, seed, parallelism, families)
        self._rng = random.Random(seed)
        self._pmf = GPU_DEMAND_PMF if demand_pmf is None else list(demand_pmf)
        self._median = median_gpu_hours
        self._sigma = sigma
        self._profile = profile
        self._gpm = gpus_per_machine

    def _arrival(self) -> float:
        return 0.0

    def _next(self) -> Optional[Job]:
        if self._i >= self.n_jobs:
            return None
        i = self._i
        self._i += 1
        return _sample_job(self._rng, i, self._arrival(), self._arch_list,
                           self._pmf, self._median, self._sigma,
                           self._profile, self._parallelism, self._gpm)


class StreamingPoissonTrace(StreamingBatchTrace):
    """Streaming twin of ``make_poisson_trace``.  The arrival process
    uses its own independent rng (``Random(seed + 10_000)``), exactly as
    the maker draws all arrivals up front from a separate instance —
    interleaving per-job pulls from two independent streams yields the
    same values as the batch draw order."""

    kind = "poisson-stream"
    _ARRIVAL_SEED_OFFSET = 10_000

    def __init__(self, archs: Sequence, n_jobs: int = 400, seed: int = 0,
                 mean_interarrival: float = 120.0, **kw):
        super().__init__(archs, n_jobs, seed, **kw)
        self.mean_interarrival = mean_interarrival
        self._arr_rng = random.Random(seed + self._ARRIVAL_SEED_OFFSET)
        self._t = 0.0

    def _arrival(self) -> float:
        self._t += self._arr_rng.expovariate(1.0 / self.mean_interarrival)
        return self._t

    def provenance(self) -> dict:
        return {**super().provenance(),
                "mean_interarrival": self.mean_interarrival}


class StreamingPhillyTrace(StreamingPoissonTrace):
    """Streaming twin of ``make_philly_trace`` (Philly demand skew,
    short-median/long-tail runtimes, arrival rng at seed + 50_000)."""

    kind = "philly-stream"
    _ARRIVAL_SEED_OFFSET = 50_000

    def __init__(self, archs: Sequence, n_jobs: int = 10_000, seed: int = 0,
                 mean_interarrival: float = 60.0,
                 median_gpu_hours: float = 0.25, sigma: float = 1.8, **kw):
        kw.setdefault("demand_pmf", PHILLY_GPU_PMF)
        super().__init__(archs, n_jobs, seed,
                         mean_interarrival=mean_interarrival,
                         median_gpu_hours=median_gpu_hours, sigma=sigma,
                         **kw)


class StreamingMixedTrace(_SyntheticSource):
    """Streaming twin of ``make_mixed_trace``: a SINGLE rng drives both
    arrivals and job bodies, so the twin replays the maker's exact
    per-job draw order (t, large, g, cfg, tokens, gpu_hours)."""

    kind = "mixed-stream"

    def __init__(self, archs: Sequence, n_jobs: int = 400, seed: int = 0,
                 large_fraction: float = 0.15,
                 mean_interarrival: float = 120.0,
                 small_median_gpu_hours: float = 1.0,
                 large_median_gpu_hours: float = 24.0,
                 sigma: float = 1.2,
                 profile: HardwareProfile = NVIDIA_PAPER,
                 parallelism=None, families=None,
                 gpus_per_machine: int = 8):
        super().__init__(archs, n_jobs, seed, parallelism, families)
        self._rng = random.Random(seed + 30_000)
        self.mean_interarrival = mean_interarrival
        self._large_fraction = large_fraction
        self._small_median = small_median_gpu_hours
        self._large_median = large_median_gpu_hours
        self._sigma = sigma
        self._profile = profile
        self._gpm = gpus_per_machine
        self._t = 0.0

    def _next(self) -> Optional[Job]:
        if self._i >= self.n_jobs:
            return None
        i = self._i
        self._i += 1
        self._t += self._rng.expovariate(1.0 / self.mean_interarrival)
        return _sample_mixed_job(self._rng, i, self._t, self._arch_list,
                                 self._large_fraction, self._small_median,
                                 self._large_median, self._sigma,
                                 self._profile, self._parallelism, self._gpm)

    def provenance(self) -> dict:
        return {**super().provenance(),
                "mean_interarrival": self.mean_interarrival}


#: trace kind -> streaming twin, same (archs, n_jobs=, seed=, **kw)
#: signature as the materialized maker.  "bursty" is absent on purpose
#: (whole-trace sort); scenario.build_trace_source falls back to a
#: MaterializedTrace wrapper for it.
STREAMING_MAKERS = {
    "batch": StreamingBatchTrace,
    "poisson": StreamingPoissonTrace,
    "philly": StreamingPhillyTrace,
    "mixed": StreamingMixedTrace,
}


# ---------------------------------------------------------------------------
# Public-trace CSV adapters
# ---------------------------------------------------------------------------

class HeliosCsvTrace(TraceSource):
    """Streaming adapter for Helios/Philly-style flat CSV traces —
    generalizes ``load_csv_trace`` to constant-memory replay.

    Two passes over the file:

    1. a scan pass records, per row, only the byte offset plus the two
       sort-key fields (arrival seconds, parsed job id) into compact
       ``array`` columns (~24 bytes/row), computes the whole-file
       sha256, detects the datetime origin shift and id collisions;
    2. emission seeks to each row's offset in submission order —
       ``sorted by (arrival, job_id)``, stable on file row order — and
       builds the ``Job`` through the same ``_job_from_row`` parser the
       materialized loader uses, applying the origin shift and (on
       collision) dense renumbering in final order.

    The emitted stream is element-wise identical to
    ``load_csv_trace(path, archs)`` (pinned by the round-trip suite).
    Rows with embedded newlines inside quoted fields are not supported.
    """

    def __init__(self, path, archs: Optional[Sequence] = None,
                 profile: HardwareProfile = NVIDIA_PAPER,
                 tokens_per_iter: int = 1024):
        super().__init__()
        self.path = str(path)
        self._archs = list(archs or [])
        self._arch_by_name = {cfg.name: cfg for cfg in self._archs}
        self._profile = profile
        self._tokens_per_iter = tokens_per_iter
        self._fh = None
        self._pos = 0
        self._scan()
        self.plans = "plan" in self._fieldnames

    def _scan(self) -> None:
        h = hashlib.sha256()
        arrivals = array("d")
        ids = array("q")
        offsets = array("q")
        saw_datetime = False
        with open(self.path, "rb") as f:
            header = f.readline()
            h.update(header)
            self._fieldnames = next(csv.reader([header.decode("utf-8")]))
            off = len(header)
            i = 0
            for line in f:
                h.update(line)
                text = line.decode("utf-8")
                if text.strip():
                    row = dict(zip(self._fieldnames,
                                   next(csv.reader([text]))))
                    arrival, was_dt = _parse_time(_col(row, "arrival") or 0.0)
                    saw_datetime = saw_datetime or was_dt
                    raw_id = _col(row, "job_id")
                    try:  # same fallback semantics as _job_from_row
                        jid = int(float(raw_id)) if raw_id is not None else i
                    except ValueError:
                        jid = i
                    offsets.append(off)
                    arrivals.append(arrival)
                    ids.append(jid)
                    i += 1
                off += len(line)
        self._offsets = offsets
        self._arrivals = arrivals
        self._ids = ids
        self._t0 = min(arrivals) if (saw_datetime and arrivals) else 0.0
        # submission order == load_csv_trace's (arrival, job_id) stable sort
        self._order = array("q", sorted(
            range(len(ids)), key=lambda r: (arrivals[r], ids[r])))
        self._renumber = len(set(ids)) != len(ids)
        self._sha256 = h.hexdigest()

    def _next(self) -> Optional[Job]:
        if self._pos >= len(self._order):
            if self._fh is not None:
                self._fh.close()
                self._fh = None
            return None
        r = self._order[self._pos]
        if self._fh is None:
            self._fh = open(self.path, "rb")
        self._fh.seek(self._offsets[r])
        text = self._fh.readline().decode("utf-8")
        row = dict(zip(self._fieldnames, next(csv.reader([text]))))
        job, _ = _job_from_row(r, row, self._arch_by_name, self._archs,
                               self._profile, self._tokens_per_iter)
        job.arrival = self._arrivals[r] - self._t0
        if self._renumber:
            job.job_id = self._pos  # dense, in final submission order
        self._pos += 1
        return job

    def __len__(self) -> int:
        return len(self._order)

    def __getstate__(self):
        state = self.__dict__.copy()
        state["_fh"] = None  # reopened lazily after restore
        return state

    def provenance(self) -> dict:
        return {"kind": "helios-csv", "path": self.path,
                "sha256": self._sha256, "n_jobs": len(self._order),
                "t0_shift": self._t0, "renumbered": self._renumber}


# Alibaba PAI GPU-2020 task-table columns (the public
# cluster-trace-gpu-v2020 release): one row per task, ``inst_num``
# instances each requesting ``plan_gpu`` *percent* of a GPU.
_PAI_STATUS_OK = ("Terminated",)


class AlibabaPaiTrace(TraceSource):
    """Streaming adapter for the Alibaba PAI GPU-2020 job/task/instance
    CSV hierarchy (``pai_task_table``-style rows: job_name, task_name,
    inst_num, status, start_time, end_time, plan_cpu, plan_mem,
    plan_gpu, gpu_type).

    One scan pass aggregates the task rows of each job into compact
    per-job arrays — arrival = earliest task start, duration = latest
    task end − arrival, GPU demand = ceil(Σ inst_num · plan_gpu / 100)
    — keeping only O(#jobs) numeric state plus the transient
    name→index map.  Rows outside ``status_filter`` (default
    "Terminated"), with non-positive timestamps, or with zero GPU
    demand (CPU-only jobs) are skipped and counted.  Jobs then emit in
    arrival order with dense ids; iteration structure is derived from a
    deterministically assigned architecture exactly like
    ``load_csv_trace`` does for model-less rows, scaled so the ideal
    runtime equals the recorded duration.  Arrivals always shift so the
    first submission is t=0 (PAI stamps are epoch-like seconds)."""

    def __init__(self, path, archs: Sequence,
                 profile: HardwareProfile = NVIDIA_PAPER,
                 tokens_per_iter: int = 1024,
                 status_filter: Sequence[str] = _PAI_STATUS_OK):
        super().__init__()
        if not archs:
            raise ValueError(
                "AlibabaPaiTrace needs archs: PAI rows carry no model "
                "names to derive an iteration structure from")
        self.path = str(path)
        self._archs = list(archs)
        self._profile = profile
        self._tokens_per_iter = tokens_per_iter
        self._status_filter = tuple(status_filter)
        self._pos = 0
        self._scan()

    def _scan(self) -> None:
        h = hashlib.sha256()
        starts = array("d")
        ends = array("d")
        gpus = array("d")
        name_to_idx: dict = {}
        n_rows = n_skipped = 0
        with open(self.path, "rb") as f:
            header = f.readline()
            h.update(header)
            fieldnames = next(csv.reader([header.decode("utf-8")]))
            for line in f:
                h.update(line)
                text = line.decode("utf-8")
                if not text.strip():
                    continue
                row = dict(zip(fieldnames, next(csv.reader([text]))))
                n_rows += 1
                if row.get("status") not in self._status_filter:
                    n_skipped += 1
                    continue
                try:
                    start = float(row.get("start_time") or 0.0)
                    end = float(row.get("end_time") or 0.0)
                    inst = float(row.get("inst_num") or 1.0)
                    plan_gpu = float(row.get("plan_gpu") or 0.0)
                except ValueError:
                    n_skipped += 1
                    continue
                if start <= 0.0 or end <= start:
                    n_skipped += 1
                    continue
                name = row.get("job_name") or ""
                idx = name_to_idx.get(name)
                if idx is None:
                    name_to_idx[name] = len(starts)
                    starts.append(start)
                    ends.append(end)
                    gpus.append(inst * plan_gpu / 100.0)
                else:
                    starts[idx] = min(starts[idx], start)
                    ends[idx] = max(ends[idx], end)
                    gpus[idx] += inst * plan_gpu / 100.0
        del name_to_idx  # the only O(#jobs) string state; drop it
        keep = [r for r in range(len(starts)) if gpus[r] > 0.0]
        n_cpu_only = len(starts) - len(keep)
        self._starts = array("d", (starts[r] for r in keep))
        self._ends = array("d", (ends[r] for r in keep))
        self._gpus = array("d", (gpus[r] for r in keep))
        self._t0 = min(self._starts) if self._starts else 0.0
        self._order = array("q", sorted(
            range(len(self._starts)), key=lambda r: self._starts[r]))
        self._sha256 = h.hexdigest()
        self._n_rows = n_rows
        self._n_skipped = n_skipped
        self._n_cpu_only = n_cpu_only

    def _next(self) -> Optional[Job]:
        if self._pos >= len(self._order):
            return None
        r = self._order[self._pos]
        cfg = self._archs[r % len(self._archs)]
        duration = self._ends[r] - self._starts[r]
        t_iter = compute_time_per_iter(cfg.n_active_params(),
                                       self._tokens_per_iter, self._profile)
        job = Job(
            job_id=self._pos,  # dense ids in submission order
            model=cfg.name,
            n_gpus=max(1, int(math.ceil(self._gpus[r] - 1e-9))),
            total_iters=max(int(duration / t_iter), 10),
            compute_time_per_iter=t_iter,
            arrival=self._starts[r] - self._t0,
            skew=_cached_skew(cfg),
        )
        self._pos += 1
        return job

    def __len__(self) -> int:
        return len(self._order)

    def provenance(self) -> dict:
        return {"kind": "pai-csv", "path": self.path,
                "sha256": self._sha256, "n_jobs": len(self._order),
                "n_rows": self._n_rows, "n_skipped": self._n_skipped,
                "n_cpu_only": self._n_cpu_only, "t0_shift": self._t0}

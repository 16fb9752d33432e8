"""Workload trace generation (SenseTime/Helios-like statistics).

The paper replays 500 jobs (batch) / ~400 jobs (Poisson) sampled from the
SenseTime trace [53].  The trace files are not redistributable, so we
generate seeded synthetic traces matched to the published statistics:

* GPU demand: heavily skewed to small jobs, powers of two
  (Helios: >50% single-GPU; few 32/64-GPU jobs)
* durations: lognormal GPU-time (median ~ 1h, long tail to days)
* models: drawn from the architecture zoo; each job's compute time per
  iteration is derived from the arch's active-param FLOPs at a standard
  per-GPU micro-batch, at 40% MFU on the hardware profile
* arrivals: all-at-0 (batch) or exponential inter-arrival (Poisson), both
  sized to exceed cluster capacity (the paper's congested regime)
"""
from __future__ import annotations

import csv
import dataclasses
import json
import math
import random
from typing import List, Optional, Sequence

from repro_torch.types import NVIDIA_PAPER, HardwareProfile

from .job import PRIORITY_CLASSES, Job
from .parallelism import ParallelPlan, plan_for

PARALLELISM_MODES = (None, "auto")

GPU_DEMAND_PMF = [(1, 0.15), (2, 0.10), (4, 0.15), (8, 0.25),
                  (16, 0.15), (32, 0.12), (64, 0.08)]

# Datacenter-mix classes (Helios/PAI-style): the bulk of jobs are small
# debugging/1-8 GPU runs, a thin tail of production jobs wants 16-128 GPUs
# and runs for much longer (Hu et al., "Characterization and Prediction of
# Deep Learning Workloads in Large-Scale GPU Datacenters").
SMALL_JOB_PMF = [(1, 0.45), (2, 0.25), (4, 0.20), (8, 0.10)]
LARGE_JOB_PMF = [(16, 0.35), (32, 0.30), (64, 0.25), (128, 0.10)]

# Per-GPU work per iteration: sampled per job (log-uniform over powers of
# two).  Small micro-batches => communication up to several x compute (the
# congested regime of the paper [13][15]); large ones => network-tolerant.
# This per-job spread is what produces the wide Table-I-style range of
# network sensitivities (7%..19592% in the paper) that delay scheduling
# exploits: tolerant jobs should take network placements immediately while
# sensitive jobs are worth waiting for.
TOKENS_PER_GPU_ITER_CHOICES = (512, 1024, 2048, 4096, 8192)
MFU = 0.4
MAX_JOB_HOURS = 72.0


def compute_time_per_iter(n_active_params: float,
                          tokens_per_iter: int = 1024,
                          profile: HardwareProfile = NVIDIA_PAPER) -> float:
    flops = 6.0 * n_active_params * tokens_per_iter
    return flops / (profile.peak_flops * MFU)


def model_skew(cfg) -> float:
    """Tiresias's skew: largest tensor / total params (from real schemas)."""
    from repro_torch.models.schema import model_schema, Param
    from repro_torch.tree import leaves as tree_leaves
    leaves = tree_leaves(model_schema(cfg),
                         is_leaf=lambda x: isinstance(x, Param))
    sizes = [math.prod(p.shape) for p in leaves]
    return max(sizes) / max(sum(sizes), 1)


# skew is a pure function of the (immutable) arch config, but walking the
# schema tree costs ~0.1 ms per call — per-job recomputation dominated
# trace generation at datacenter scale (10k-50k jobs), so memoize per
# config object.  Keyed on id() with the config kept alive in the value:
# two distinct configs sharing a name stay distinct, and a live reference
# pins the id against reuse.
_SKEW_CACHE: dict = {}


def _cached_skew(cfg) -> float:
    hit = _SKEW_CACHE.get(id(cfg))
    if hit is None or hit[0] is not cfg:
        hit = _SKEW_CACHE[id(cfg)] = (cfg, model_skew(cfg))
    return hit[1]


def _sample_demand(rng: random.Random, pmf=GPU_DEMAND_PMF) -> int:
    r = rng.random()
    acc = 0.0
    for g, p in pmf:
        acc += p
        if r <= acc:
            return g
    return pmf[-1][0]


def _check_parallelism(parallelism):
    if parallelism not in PARALLELISM_MODES:
        raise ValueError(
            f"unknown parallelism mode {parallelism!r}; known: "
            f"{', '.join(str(m) for m in PARALLELISM_MODES)}")


def _job_plan(parallelism, cfg, g, tokens, gpus_per_machine):
    """Plan assignment for one job.  ``parallelism`` gates it: None (the
    default) assigns no plans — the bit-for-bit legacy workload; "auto"
    (validated by the trace maker) derives a deterministic DP/TP/PP/EP
    plan from the model family and demand (MoE -> expert parallel, large
    dense -> TP/PP splits), sized against the cluster's actual machine
    width so TP groups can fit one machine.  The derivation draws nothing
    from the rng, so a trace generated with plans differs from its
    plan-less twin ONLY by the plan fields."""
    if parallelism is None:
        return None
    return plan_for(cfg, g, tokens_per_gpu_iter=tokens,
                    gpus_per_machine=gpus_per_machine)


def _filter_archs(archs, families) -> List:
    arch_list = [cfg for cfg in archs
                 if families is None or cfg.family in families]
    if not arch_list:
        raise ValueError(f"no architectures match families={families!r}")
    return arch_list


def _sample_job(rng: random.Random, job_id: int, arrival: float,
                arch_list, pmf, median_gpu_hours, sigma,
                profile: HardwareProfile, parallelism,
                gpus_per_machine) -> Job:
    """One job drawn from ``rng`` — the exact per-job draw order
    (cfg, g, tokens, gpu_hours) of the ``_make_jobs`` loop body, shared
    with the streaming twins in ``trace_source`` so a lazily-generated
    job stream is byte-identical to the materialized list."""
    cfg = rng.choice(arch_list)
    g = _sample_demand(rng, pmf)
    tokens = rng.choice(TOKENS_PER_GPU_ITER_CHOICES)
    t_iter = compute_time_per_iter(cfg.n_active_params(), tokens, profile)
    gpu_hours = min(rng.lognormvariate(math.log(median_gpu_hours), sigma),
                    MAX_JOB_HOURS)
    runtime = gpu_hours * 3600.0  # wall-clock ideal runtime
    iters = max(int(runtime / t_iter), 10)
    return Job(
        job_id=job_id,
        model=cfg.name,
        n_gpus=g,
        total_iters=iters,
        compute_time_per_iter=t_iter,
        arrival=arrival,
        skew=_cached_skew(cfg),
        plan=_job_plan(parallelism, cfg, g, tokens, gpus_per_machine),
    )


def _make_jobs(n_jobs, arrivals, archs, seed,
               median_gpu_hours=2.0, sigma=1.2,
               profile: HardwareProfile = NVIDIA_PAPER,
               parallelism=None, families=None,
               demand_pmf=None, gpus_per_machine=8) -> List[Job]:
    _check_parallelism(parallelism)
    rng = random.Random(seed)
    arch_list = _filter_archs(archs, families)
    pmf = GPU_DEMAND_PMF if demand_pmf is None else list(demand_pmf)
    return [_sample_job(rng, i, arrivals[i], arch_list, pmf,
                        median_gpu_hours, sigma, profile, parallelism,
                        gpus_per_machine)
            for i in range(n_jobs)]


def make_batch_trace(archs: Sequence, n_jobs: int = 500, seed: int = 0,
                     **kw) -> List[Job]:
    """All jobs submitted at t=0 (the paper's batch-arrival workload)."""
    return _make_jobs(n_jobs, [0.0] * n_jobs, archs, seed, **kw)


def make_poisson_trace(archs: Sequence, n_jobs: int = 400, seed: int = 0,
                       mean_interarrival: float = 120.0, **kw) -> List[Job]:
    """Poisson arrivals sized for a congested (peak-usage) regime."""
    rng = random.Random(seed + 10_000)
    t = 0.0
    arrivals = []
    for _ in range(n_jobs):
        t += rng.expovariate(1.0 / mean_interarrival)
        arrivals.append(t)
    return _make_jobs(n_jobs, arrivals, archs, seed, **kw)


def make_bursty_trace(archs: Sequence, n_jobs: int = 400, seed: int = 0,
                      mean_interarrival: float = 240.0,
                      period: float = 86_400.0,
                      peak_to_trough: float = 4.0,
                      flash_crowds: int = 2,
                      flash_fraction: float = 0.2,
                      flash_window: float = 600.0, **kw) -> List[Job]:
    """Bursty arrivals: a diurnal (sinusoidal-rate) Poisson process plus
    optional flash crowds — tight bursts of submissions within a few
    minutes (conference deadline / incident-retry behaviour).

    The diurnal component is an inhomogeneous Poisson process sampled by
    thinning at the peak rate; ``peak_to_trough`` sets the day/night rate
    ratio.  ``flash_crowds`` bursts together hold ``flash_fraction`` of all
    jobs, each burst spread uniformly over ``flash_window`` seconds.
    """
    rng = random.Random(seed + 20_000)
    n_flash = int(n_jobs * flash_fraction) if flash_crowds > 0 else 0
    n_diurnal = n_jobs - n_flash
    lam_avg = 1.0 / mean_interarrival
    a = (peak_to_trough - 1.0) / (peak_to_trough + 1.0)
    lam_peak = lam_avg * (1.0 + a)
    t, arrivals = 0.0, []
    while len(arrivals) < n_diurnal:
        t += rng.expovariate(lam_peak)
        rate = lam_avg * (1.0 + a * math.sin(2.0 * math.pi * t / period))
        if rng.random() < rate / lam_peak:
            arrivals.append(t)
    horizon = arrivals[-1] if arrivals else period
    for k in range(flash_crowds):
        center = rng.uniform(0.0, horizon)
        size = n_flash // flash_crowds + (1 if k < n_flash % flash_crowds
                                          else 0)
        arrivals.extend(center + rng.uniform(0.0, flash_window)
                        for _ in range(size))
    arrivals.sort()
    return _make_jobs(n_jobs, arrivals, archs, seed, **kw)


def make_mixed_trace(archs: Sequence, n_jobs: int = 400, seed: int = 0,
                     large_fraction: float = 0.15,
                     mean_interarrival: float = 120.0,
                     small_median_gpu_hours: float = 1.0,
                     large_median_gpu_hours: float = 24.0,
                     sigma: float = 1.2,
                     profile: HardwareProfile = NVIDIA_PAPER,
                     parallelism=None, families=None,
                     gpus_per_machine=8) -> List[Job]:
    """Datacenter mix: mostly small (1-8 GPU, short) jobs with a tail of
    large (16-128 GPU, long-running) production jobs, Poisson arrivals.
    128-GPU jobs exceed one rack on the default topology, exercising the
    network tier end-to-end."""
    _check_parallelism(parallelism)
    rng = random.Random(seed + 30_000)
    arch_list = _filter_archs(archs, families)
    t = 0.0
    jobs = []
    for i in range(n_jobs):
        t += rng.expovariate(1.0 / mean_interarrival)
        jobs.append(_sample_mixed_job(
            rng, i, t, arch_list, large_fraction, small_median_gpu_hours,
            large_median_gpu_hours, sigma, profile, parallelism,
            gpus_per_machine))
    return jobs


def _sample_mixed_job(rng: random.Random, job_id: int, arrival: float,
                      arch_list, large_fraction, small_median_gpu_hours,
                      large_median_gpu_hours, sigma,
                      profile: HardwareProfile, parallelism,
                      gpus_per_machine) -> Job:
    """The mixed-trace per-job draw order (large, g, cfg, tokens,
    gpu_hours) — NOTE it differs from ``_sample_job``'s; shared with the
    streaming twin, which advances the arrival clock from the same rng
    before each call exactly like ``make_mixed_trace``'s loop."""
    large = rng.random() < large_fraction
    g = _sample_demand(rng, LARGE_JOB_PMF if large else SMALL_JOB_PMF)
    cfg = rng.choice(arch_list)
    tokens = rng.choice(TOKENS_PER_GPU_ITER_CHOICES)
    t_iter = compute_time_per_iter(cfg.n_active_params(), tokens, profile)
    median = large_median_gpu_hours if large else small_median_gpu_hours
    gpu_hours = min(rng.lognormvariate(math.log(median), sigma),
                    MAX_JOB_HOURS)
    iters = max(int(gpu_hours * 3600.0 / t_iter), 10)
    return Job(job_id=job_id, model=cfg.name, n_gpus=g,
               total_iters=iters, compute_time_per_iter=t_iter,
               arrival=arrival, skew=_cached_skew(cfg),
               plan=_job_plan(parallelism, cfg, g, tokens,
                              gpus_per_machine))


# Philly-style statistics (Jeon et al., "Analysis of Large-Scale Multi-
# Tenant GPU Clusters for DNN Training Workloads", ATC '19): single-GPU
# jobs dominate, demands stay small (the trace's largest jobs are 64
# GPUs), and runtimes are short-median with a very long tail.
PHILLY_GPU_PMF = [(1, 0.50), (2, 0.17), (4, 0.13), (8, 0.12),
                  (16, 0.05), (32, 0.02), (64, 0.01)]


def make_philly_trace(archs: Sequence, n_jobs: int = 10_000, seed: int = 0,
                      mean_interarrival: float = 60.0,
                      median_gpu_hours: float = 0.25, sigma: float = 1.8,
                      **kw) -> List[Job]:
    """Philly-replay-style workload: Poisson arrivals with the published
    Philly demand skew and short-median/long-tail runtimes — the
    datacenter-scale regime (tens of thousands of mostly tiny jobs) that
    exercises deep wait queues rather than per-job network pressure.

    The real Philly CSV is replayed through ``load_csv_trace``; this
    generator produces a seeded synthetic stand-in matched to its
    statistics for scenarios that must not depend on external files."""
    rng = random.Random(seed + 50_000)
    t = 0.0
    arrivals = []
    for _ in range(n_jobs):
        t += rng.expovariate(1.0 / mean_interarrival)
        arrivals.append(t)
    kw.setdefault("demand_pmf", PHILLY_GPU_PMF)
    return _make_jobs(n_jobs, arrivals, archs, seed,
                      median_gpu_hours=median_gpu_hours, sigma=sigma, **kw)


# Helios-style tenancy skew (Hu et al., arXiv 2109.01313): a handful of
# tenants dominate GPU-hours while the long tail submits small jobs.  The
# default shares and priority mix below encode that shape at CI scale.
DEFAULT_TENANTS = (("prod", 0.40), ("research", 0.30),
                   ("mlops", 0.20), ("interns", 0.10))
DEFAULT_PRIORITY_PMF = (("low", 0.30), ("normal", 0.55), ("high", 0.15))


def make_multi_tenant_trace(archs: Sequence, n_jobs: int = 400,
                            seed: int = 0,
                            tenants=DEFAULT_TENANTS,
                            priority_pmf=DEFAULT_PRIORITY_PMF,
                            **kw) -> List[Job]:
    """The datacenter mix with per-job tenant + priority-class labels.

    The underlying jobs are EXACTLY ``make_mixed_trace``'s (same seed
    offset, same draw order); tenant and priority assignment draws from a
    separate rng stream (seed + 90_000), so the labelled trace differs
    from its unlabelled twin only by the label fields — the scheduling of
    an all-default-priority assignment would be decision-identical."""
    jobs = make_mixed_trace(archs, n_jobs=n_jobs, seed=seed, **kw)
    rng = random.Random(seed + 90_000)
    for job in jobs:
        job.tenant = _weighted_choice(rng, tenants)
        job.priority = PRIORITY_CLASSES.index(
            _weighted_choice(rng, priority_pmf))
    return jobs


def _weighted_choice(rng: random.Random, pmf):
    """One draw from a ((value, weight), ...) pmf — the cumulative-scan
    idiom `_sample_demand` uses, kept separate because values here are
    labels, not GPU counts."""
    r = rng.random()
    acc = 0.0
    for v, p in pmf:
        acc += p
        if r <= acc:
            return v
    return pmf[-1][0]


# ---------------------------------------------------------------------------
# Machine failure / maintenance schedules
# ---------------------------------------------------------------------------
# Hardware failures and maintenance churn are a first-order effect on
# JCT/makespan in real GPU datacenters (Hu et al., "Characterization and
# Prediction of Deep Learning Workloads in Large-Scale GPU Datacenters"):
# capacity comes and goes while the scheduler runs.  A failure schedule is
# a sorted list of (t, "fail"|"recover", machine_id) events consumed by
# ``ClusterSimulator(failure_events=)``.  Every failure ALWAYS carries its
# matching recovery (recoveries may land past the horizon): a machine that
# never came back could strand waiting jobs whose demand exceeds the
# surviving capacity, wedging the round loop forever.

FAILURE_MODES = (None, "mtbf", "maintenance")

# default knobs per mode, resolved (and recorded) by the experiment layer
MTBF_DEFAULTS = dict(
    mtbf=24 * 3600.0,        # mean time between failures, per machine
    mttr=3600.0,             # mean time to repair
    horizon=7 * 24 * 3600.0,  # no new failures after this
    scope=1.0,               # fraction of machines that ever fail
)
MAINTENANCE_DEFAULTS = dict(
    start=6 * 3600.0,        # first batch goes down at this time
    window=3600.0,           # per-batch downtime
    batch_size=1,            # machines down simultaneously
    gap=0.0,                 # idle time between consecutive batches
    rounds=1,                # full passes over the machine list
)


def resolve_failure_kw(mode: str, kw: Optional[dict] = None) -> dict:
    """Mode defaults merged with overrides; unknown keys are an error (a
    typo'd knob silently falling back to its default would corrupt the
    artifact provenance that records the resolved values)."""
    defaults = {"mtbf": MTBF_DEFAULTS,
                "maintenance": MAINTENANCE_DEFAULTS}.get(mode)
    if defaults is None:
        raise ValueError(
            f"unknown failure mode {mode!r}; known: "
            f"{', '.join(str(m) for m in FAILURE_MODES)}")
    kw = dict(kw or {})
    unknown = set(kw) - set(defaults)
    if unknown:
        raise ValueError(
            f"unknown failure_kw keys for mode {mode!r}: "
            f"{', '.join(sorted(unknown))}; known: "
            f"{', '.join(sorted(defaults))}")
    return {**defaults, **kw}


def _events_from_windows(windows: list) -> list:
    """[(start, end, machine)] downtime windows -> the sorted
    (t, "fail"|"recover", machine) event stream.

    A machine's windows that touch or overlap merge into one continuous
    downtime first: emitting a recover that coincides with the same
    machine's next fail would make the simulator drop the same-instant
    fail as a duplicate notice (FAIL orders before RECOVER at equal t)
    and silently annihilate the second window — e.g. back-to-back
    whole-cluster maintenance passes.  Cross-machine same-instant ties
    (a zero-gap handoff recovering batch i while failing batch i+1)
    remain, and the simulator coalesces its scheduling reaction over
    such bursts."""
    by_machine: dict = {}
    for s, e, m in windows:
        by_machine.setdefault(m, []).append((s, e))
    events = []
    for m, ws in by_machine.items():
        ws.sort()
        cur_s, cur_e = ws[0]
        merged = []
        for s, e in ws[1:]:
            if s <= cur_e:
                cur_e = max(cur_e, e)
            else:
                merged.append((cur_s, cur_e))
                cur_s, cur_e = s, e
        merged.append((cur_s, cur_e))
        for s, e in merged:
            events.append((s, "fail", m))
            events.append((e, "recover", m))
    events.sort(key=lambda e: (e[0], e[2], e[1]))
    return events


def make_mtbf_failures(machine_ids: Sequence[int], seed: int = 0,
                       **kw) -> list:
    """Seeded stochastic failure/repair process: each machine alternates
    exponential up-times (mean ``mtbf``) and exponential down-times (mean
    ``mttr``) until ``horizon``; ``scope`` < 1 restricts churn to a seeded
    subset of machines (flaky-hardware hotspots).  Same seed (and machine
    list) -> byte-identical schedule."""
    p = resolve_failure_kw("mtbf", kw)
    rng = random.Random(seed + 60_000)
    machine_ids = list(machine_ids)
    if p["scope"] < 1.0:
        k = max(1, int(p["scope"] * len(machine_ids)))
        machine_ids = sorted(rng.sample(machine_ids, k))
    windows = []
    for m in machine_ids:
        t = rng.expovariate(1.0 / p["mtbf"])
        while t < p["horizon"]:
            down = rng.expovariate(1.0 / p["mttr"])
            windows.append((t, t + down, m))
            t += down + rng.expovariate(1.0 / p["mtbf"])
    return _events_from_windows(windows)


def make_rolling_maintenance(machine_ids: Sequence[int], **kw) -> list:
    """Deterministic rolling maintenance: machines go down in consecutive
    batches of ``batch_size`` for ``window`` seconds each, ``gap`` seconds
    apart, starting at ``start``; ``rounds`` full passes.  Draws nothing
    from any rng — the schedule is a pure function of the machine list.
    A machine whose consecutive windows touch (e.g. whole-cluster batches
    with ``gap=0``) gets one merged continuous downtime."""
    p = resolve_failure_kw("maintenance", kw)
    machine_ids = list(machine_ids)
    windows = []
    t = p["start"]
    for _ in range(int(p["rounds"])):
        for i in range(0, len(machine_ids), int(p["batch_size"])):
            for m in machine_ids[i:i + int(p["batch_size"])]:
                windows.append((t, t + p["window"], m))
            t += p["window"] + p["gap"]
    return _events_from_windows(windows)


# ---------------------------------------------------------------------------
# Analog degradation schedules (stragglers, slow NICs, flapping uplinks)
# ---------------------------------------------------------------------------
# Binary dead/alive churn misses how real clusters mostly hurt you: analog
# performance faults.  Large-scale trace studies (Hu et al., 2021) document
# straggler GPUs and thermally-throttled machines that run slow rather than
# die, and degraded/flapping links that shrink effective bandwidth without
# ever dropping.  A degradation schedule is a sorted list of
# (t, "machine"|"link", target, factor) events consumed by
# ``ClusterSimulator(degradation_events=)``:
#
# * "machine" events multiply the iteration time of every job touching the
#   machine by ``factor`` (>= 1.0); factor 1.0 is the recovery.
# * "link" events derate a fabric link's capacity to ``factor`` (<= 1.0)
#   of nominal; factor 1.0 restores it.  Targets use the topology's link
#   keys (("uplink", rack) — the spine never degrades here).
#
# Every degradation ALWAYS carries its matching recovery (possibly past the
# horizon), mirroring the failure-schedule invariant above, and the same
# seed (and target list) yields a byte-identical schedule.

DEGRADATION_MODES = (None, "stragglers", "slow-nics", "flapping-uplinks",
                     "mixed")

STRAGGLER_DEFAULTS = dict(
    mtbd=12 * 3600.0,        # mean healthy time between episodes, per machine
    duration=2 * 3600.0,     # mean episode length
    factor_min=1.3,          # sampled iteration-time multiplier range
    factor_max=2.5,
    horizon=7 * 24 * 3600.0,  # no new episodes after this
    scope=0.25,              # fraction of machines that ever straggle
)
SLOW_NIC_DEFAULTS = dict(
    start=0.0,               # derating begins here
    derate=0.5,              # fraction of nominal uplink bandwidth retained
    scope=0.25,              # fraction of racks with slow uplinks
    horizon=7 * 24 * 3600.0,  # recovery (back to nominal) lands here
)
FLAPPING_DEFAULTS = dict(
    mtbf=4 * 3600.0,         # mean healthy time per uplink
    mttr=1800.0,             # mean degraded time per flap
    derate=0.25,             # bandwidth fraction retained while degraded
    scope=0.25,              # fraction of racks that ever flap
    horizon=7 * 24 * 3600.0,
)
MIXED_DEFAULTS = dict(
    machine_scope=0.25,      # straggler scope (machine axis)
    link_scope=0.25,         # flapping-uplink scope (link axis)
    horizon=7 * 24 * 3600.0,
)


def resolve_degradation_kw(mode: str, kw: Optional[dict] = None) -> dict:
    """Mode defaults merged with overrides; unknown keys are an error —
    same contract as ``resolve_failure_kw`` (a typo'd knob silently
    falling back to its default would corrupt artifact provenance)."""
    defaults = {"stragglers": STRAGGLER_DEFAULTS,
                "slow-nics": SLOW_NIC_DEFAULTS,
                "flapping-uplinks": FLAPPING_DEFAULTS,
                "mixed": MIXED_DEFAULTS}.get(mode)
    if defaults is None:
        raise ValueError(
            f"unknown degradation mode {mode!r}; known: "
            f"{', '.join(str(m) for m in DEGRADATION_MODES)}")
    kw = dict(kw or {})
    unknown = set(kw) - set(defaults)
    if unknown:
        raise ValueError(
            f"unknown degradation_kw keys for mode {mode!r}: "
            f"{', '.join(sorted(unknown))}; known: "
            f"{', '.join(sorted(defaults))}")
    return {**defaults, **kw}


def _degradation_events(windows: list) -> list:
    """[(start, end, dkind, target, factor)] -> the sorted
    (t, dkind, target, factor) event stream, recovery (factor 1.0)
    emitted at each window's end.

    Per-target windows that touch or overlap merge into one continuous
    episode (keeping the harsher factor) for the same reason
    ``_events_from_windows`` merges: a recovery coinciding with the same
    target's next onset must not annihilate the second episode."""
    by_target: dict = {}
    for s, e, dkind, target, factor in windows:
        by_target.setdefault((dkind, target), []).append((s, e, factor))
    events = []
    for (dkind, target), ws in by_target.items():
        ws.sort()
        cur_s, cur_e, cur_f = ws[0]
        merged = []
        for s, e, f in ws[1:]:
            if s <= cur_e:
                cur_e = max(cur_e, e)
                # harsher = further from 1.0 on either side of it
                cur_f = f if abs(f - 1.0) > abs(cur_f - 1.0) else cur_f
            else:
                merged.append((cur_s, cur_e, cur_f))
                cur_s, cur_e, cur_f = s, e, f
        merged.append((cur_s, cur_e, cur_f))
        for s, e, f in merged:
            events.append((s, dkind, target, f))
            events.append((e, dkind, target, 1.0))
    events.sort(key=lambda ev: (ev[0], ev[1], str(ev[2]), ev[3]))
    return events


def make_straggler_degradations(machine_ids: Sequence[int], seed: int = 0,
                                **kw) -> list:
    """Seeded straggler/throttling process: each in-scope machine
    alternates exponential healthy times (mean ``mtbd``) and exponential
    degraded episodes (mean ``duration``) until ``horizon``; each episode
    samples its compute-slowdown factor uniformly from
    [``factor_min``, ``factor_max``].  Same seed -> byte-identical."""
    p = resolve_degradation_kw("stragglers", kw)
    rng = random.Random(seed + 70_000)
    machine_ids = list(machine_ids)
    if p["scope"] < 1.0:
        k = max(1, int(p["scope"] * len(machine_ids)))
        machine_ids = sorted(rng.sample(machine_ids, k))
    windows = []
    for m in machine_ids:
        t = rng.expovariate(1.0 / p["mtbd"])
        while t < p["horizon"]:
            dur = rng.expovariate(1.0 / p["duration"])
            factor = rng.uniform(p["factor_min"], p["factor_max"])
            windows.append((t, t + dur, "machine", m, factor))
            t += dur + rng.expovariate(1.0 / p["mtbd"])
    return _degradation_events(windows)


def make_slow_nic_degradations(rack_ids: Sequence[int], seed: int = 0,
                               **kw) -> list:
    """Seeded slow-NIC derating: a seeded ``scope`` subset of rack
    uplinks runs at ``derate`` x nominal bandwidth from ``start`` until
    ``horizon`` (one long window per afflicted uplink — the chronic
    hardware-lemon case, not a transient)."""
    p = resolve_degradation_kw("slow-nics", kw)
    rng = random.Random(seed + 75_000)
    rack_ids = list(rack_ids)
    if p["scope"] < 1.0:
        k = max(1, int(p["scope"] * len(rack_ids)))
        rack_ids = sorted(rng.sample(rack_ids, k))
    windows = [(p["start"], p["horizon"], "link", ("uplink", r), p["derate"])
               for r in rack_ids]
    return _degradation_events(windows)


def make_flapping_uplink_degradations(rack_ids: Sequence[int], seed: int = 0,
                                      **kw) -> list:
    """Seeded flapping uplinks: each in-scope rack uplink alternates
    exponential healthy times (mean ``mtbf``) and exponential degraded
    windows (mean ``mttr``) at ``derate`` x nominal bandwidth, until
    ``horizon``."""
    p = resolve_degradation_kw("flapping-uplinks", kw)
    rng = random.Random(seed + 80_000)
    rack_ids = list(rack_ids)
    if p["scope"] < 1.0:
        k = max(1, int(p["scope"] * len(rack_ids)))
        rack_ids = sorted(rng.sample(rack_ids, k))
    windows = []
    for r in rack_ids:
        t = rng.expovariate(1.0 / p["mtbf"])
        while t < p["horizon"]:
            down = rng.expovariate(1.0 / p["mttr"])
            windows.append((t, t + down, "link", ("uplink", r), p["derate"]))
            t += down + rng.expovariate(1.0 / p["mtbf"])
    return _degradation_events(windows)


def make_mixed_degradations(machine_ids: Sequence[int],
                            rack_ids: Sequence[int], seed: int = 0,
                            **kw) -> list:
    """Stragglers + flapping uplinks together (the fig16 churn regime).
    Composes the two single-axis makers at their own seed offsets, so a
    mixed schedule's machine axis is byte-identical to the stand-alone
    straggler schedule at the same seed and scope."""
    p = resolve_degradation_kw("mixed", kw)
    events = make_straggler_degradations(
        machine_ids, seed, scope=p["machine_scope"], horizon=p["horizon"])
    events += make_flapping_uplink_degradations(
        rack_ids, seed, scope=p["link_scope"], horizon=p["horizon"])
    events.sort(key=lambda ev: (ev[0], ev[1], str(ev[2]), ev[3]))
    return events


# ---------------------------------------------------------------------------
# CSV trace replay (Philly / Helios-style)
# ---------------------------------------------------------------------------

CSV_FIELDS = ("job_id", "model", "n_gpus", "total_iters",
              "compute_time_per_iter", "arrival", "skew")

# accepted aliases for externally-produced traces
_ALIASES = {
    "job_id": ("job_id", "jobid", "job"),
    "arrival": ("arrival", "submit_time", "submitted_time", "submission_time"),
    "n_gpus": ("n_gpus", "gpus", "num_gpus", "gpu_num", "worker_gpu"),
    "duration": ("duration", "runtime", "run_time"),
    "model": ("model", "model_name", "arch"),
    "total_iters": ("total_iters", "iters", "iterations"),
    "compute_time_per_iter": ("compute_time_per_iter", "iter_time"),
    "skew": ("skew",),
}


def _col(row: dict, field: str):
    for alias in _ALIASES[field]:
        if alias in row and row[alias] not in ("", None):
            return row[alias]
    return None


def _parse_time(value):
    """-> (seconds, was_datetime).  Accepts plain seconds or a datetime
    string ('2017-10-03 05:51:56', as in real Philly/Helios traces)."""
    try:
        return float(value), False
    except ValueError:
        from datetime import datetime
        return datetime.fromisoformat(str(value).strip()).timestamp(), True


def _plan_to_cell(plan: Optional[ParallelPlan]) -> str:
    return "" if plan is None else json.dumps(dataclasses.asdict(plan),
                                              sort_keys=True)


def _plan_from_cell(raw) -> Optional[ParallelPlan]:
    if raw in (None, ""):
        return None
    return ParallelPlan(**json.loads(raw))


def save_csv_trace(jobs: Sequence[Job], path) -> None:
    """Write a trace in the canonical CSV schema (round-trips exactly
    through load_csv_trace).  Plan-bearing jobs (parallelism="auto") get
    an extra ``plan`` column holding the JSON-encoded ``ParallelPlan``
    fields; plan-less traces keep the byte-identical 7-column layout."""
    jobs = list(jobs)
    with_plans = any(j.plan is not None for j in jobs)
    with open(path, "w", newline="") as f:
        w = csv.writer(f)
        w.writerow(CSV_FIELDS + ("plan",) if with_plans else CSV_FIELDS)
        for j in jobs:
            row = [j.job_id, j.model, j.n_gpus, j.total_iters,
                   repr(j.compute_time_per_iter), repr(j.arrival),
                   repr(j.skew)]
            if with_plans:
                row.append(_plan_to_cell(j.plan))
            w.writerow(row)


def _job_from_row(i: int, row: dict, arch_by_name: dict, arch_list,
                  profile: HardwareProfile, tokens_per_iter: int):
    """One CSV row -> ``(Job, was_datetime)``.  ``arrival`` and
    ``job_id`` are the RAW per-row values: callers apply the whole-trace
    datetime-origin shift and id-collision renumbering (``load_csv_trace``
    materialized, ``HeliosCsvTrace`` from its first streaming pass)."""
    arrival, was_dt = _parse_time(_col(row, "arrival") or 0.0)
    g = int(float(_col(row, "n_gpus") or 1))
    model = _col(row, "model")
    cfg = arch_by_name.get(model)
    if cfg is None and arch_list:
        # unknown or missing model name: deterministically assign one of
        # ours and RENAME the job to it — a foreign name (e.g. resnet50)
        # would KeyError later inside CommModel.allreduce_time
        cfg = arch_list[i % len(arch_list)]
        model = cfg.name
    t_iter = _col(row, "compute_time_per_iter")
    iters = _col(row, "total_iters")
    if t_iter is not None and iters is not None:
        t_iter, iters = float(t_iter), int(float(iters))
    else:
        if cfg is None:
            raise ValueError(
                f"row {i}: no iteration structure in the CSV and no "
                "archs given to derive one from")
        duration = float(_col(row, "duration") or 3600.0)
        t_iter = compute_time_per_iter(cfg.n_active_params(),
                                       tokens_per_iter, profile)
        iters = max(int(duration / t_iter), 10)
    skew = _col(row, "skew")
    if skew is not None:
        skew = float(skew)
    else:
        skew = _cached_skew(cfg) if cfg is not None else 0.0
    raw_id = _col(row, "job_id")
    try:  # Philly ids like 'application_1506638472019_10258' -> row index
        job_id = int(float(raw_id)) if raw_id is not None else i
    except ValueError:
        job_id = i
    return Job(job_id=job_id, model=model or "unknown", n_gpus=g,
               total_iters=iters, compute_time_per_iter=t_iter,
               arrival=arrival, skew=skew,
               plan=_plan_from_cell(row.get("plan"))), was_dt


def load_csv_trace(path, archs: Optional[Sequence] = None,
                   profile: HardwareProfile = NVIDIA_PAPER,
                   tokens_per_iter: int = 1024) -> List[Job]:
    """Load a trace from CSV.  Accepts the canonical schema written by
    save_csv_trace, or minimal Philly/Helios-style columns
    (submit_time/num_gpus/duration [+ model]): jobs without an explicit
    iteration structure get one derived from the named (or deterministically
    assigned) architecture at the standard micro-batch, scaled so the
    ideal runtime equals the recorded duration."""
    with open(path, newline="") as f:
        rows = list(csv.DictReader(f))
    arch_by_name = {cfg.name: cfg for cfg in (archs or [])}
    arch_list = list(archs or [])
    jobs = []
    saw_datetime = False
    for i, row in enumerate(rows):
        job, was_dt = _job_from_row(i, row, arch_by_name, arch_list,
                                    profile, tokens_per_iter)
        saw_datetime = saw_datetime or was_dt
        jobs.append(job)
    # datetime-stamped traces: shift so the first submission is t=0
    # (numeric arrivals pass through untouched — exact round-trip)
    if saw_datetime and jobs:
        t0 = min(j.arrival for j in jobs)
        for j in jobs:
            j.arrival -= t0
    # submission order: arrivals ascending, ids break ties (stable on the
    # file's row order for equal (arrival, id) pairs)
    jobs.sort(key=lambda j: (j.arrival, j.job_id))
    # colliding ids (duplicates in the file, or row-index fallbacks hitting
    # a real numeric id) would corrupt the simulator's job table — renumber
    # densely in the FINAL sorted order, so the numbering is deterministic
    # w.r.t. submission order rather than raw file order (the ascending ids
    # leave the (arrival, job_id) sort unchanged)
    if len({j.job_id for j in jobs}) != len(jobs):
        for i, j in enumerate(jobs):
            j.job_id = i
    return jobs

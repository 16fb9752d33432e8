"""Declarative experiment scenarios.

A ``Scenario`` is one simulated workload regime: cluster shape (possibly
heterogeneous racks), network regime (hardware profile, per-tier contention,
machine-slowdown schedules, endogenous shared-fabric contention), trace kind
+ parameters, and default policy / simulator knobs.  Scenarios are pure data — the same (scenario, policy,
seed) triple always builds the same simulation, which is what makes the
parallel sweep runner deterministic.

Named scenarios live in ``SCENARIOS``; add one with ``register`` (see
docs/experiments.md).

The port's copy of the JAX package's ``repro.experiments.scenario``, line
for line but for its imports and ``Scenario.profile``'s default,
``"nvidia_paper"`` (the port holds no TPU profile); every registered
scenario keeps its numbers.  Where a description names a link's capacity
against the NIC rate, it is restated for the paper's 100e9 B/s network tier
(the reference sized those numbers against its TPU's 25e9 B/s), since
descriptions are no part of an artifact.  The reference's deprecated
``failure_mode``/``failure_kw`` fields (folded into ``faults`` with a
DeprecationWarning) and its ``naive_topology`` switch of ``build_cluster``
and ``build_sim`` are left out: nothing in the port used them.  As in the reference, a scenario's profile
prices its network (``build_comm``, the fabric's capacities) but not its
jobs: ``build_trace`` and ``build_trace_source`` call the makers and the
CSV adapters without a profile, so a job's compute time comes from their
own default, here ``NVIDIA_PAPER``.
"""
from __future__ import annotations

import dataclasses
import math
from dataclasses import dataclass, field
from typing import Any, Dict, Mapping, Optional, Tuple

from repro_torch.core import (
    ClusterSimulator,
    ClusterTopology,
    CommModel,
    FairShareFabric,
    load_csv_trace,
    make_batch_trace,
    make_bursty_trace,
    make_mixed_trace,
    make_multi_tenant_trace,
    make_philly_trace,
    make_poisson_trace,
)
from repro_torch.core.fabric import DEFAULT_SPINE_X, DEFAULT_UPLINK_X
from repro_torch.core.policies import make_policy
from repro_torch.core.trace_source import (
    STREAMING_MAKERS,
    AlibabaPaiTrace,
    HeliosCsvTrace,
    MaterializedTrace,
    TraceSource,
)
from repro_torch.core.trace import (
    FAILURE_MODES,
    PARALLELISM_MODES,
    make_flapping_uplink_degradations,
    make_mixed_degradations,
    make_mtbf_failures,
    make_rolling_maintenance,
    make_slow_nic_degradations,
    make_straggler_degradations,
    resolve_degradation_kw,
    resolve_failure_kw,
)
from repro_torch.types import PROFILES

from .faults import FaultSpec

CONTENTION_MODES = (None, "fair-share")

TRACE_MAKERS = {
    "batch": make_batch_trace,
    "poisson": make_poisson_trace,
    "bursty": make_bursty_trace,
    "mixed": make_mixed_trace,
    "philly": make_philly_trace,
    "multi-tenant": make_multi_tenant_trace,
}


@dataclass(frozen=True)
class ContentionSchedule:
    """Recurring background network contention: every ``period`` seconds a
    random ``scope`` fraction of machines slows down by ``factor`` for
    ``duty * period`` seconds (co-located inference traffic, maintenance
    mirrors, bulk transfers...).  Expanded deterministically from the run
    seed into the simulator's machine-slowdown events."""
    period: float = 6 * 3600.0
    duty: float = 0.25
    factor: float = 2.0
    scope: float = 0.25
    horizon: float = 14 * 24 * 3600.0

    def events(self, machine_ids, seed: int):
        """machine_ids: ids of machines that actually hold GPUs (excludes
        the empty stride slots of heterogeneous topologies, which would
        silently shrink the effective contention scope)."""
        import random
        machine_ids = list(machine_ids)
        rng = random.Random(seed + 40_000)
        out = []
        t = 0.0
        while t < self.horizon:
            k = max(1, int(self.scope * len(machine_ids)))
            for m in rng.sample(machine_ids, k):
                out.append((t, m, self.factor))
                out.append((t + self.duty * self.period, m, 1.0))
            t += self.period
        return out


@dataclass(frozen=True)
class Scenario:
    name: str
    description: str = ""
    # cluster shape
    n_racks: int = 8
    machines_per_rack: int = 8
    gpus_per_machine: int = 8
    rack_sizes: Optional[Tuple[int, ...]] = None  # heterogeneous racks
    # network regime
    profile: str = "nvidia_paper"
    bandwidth_scale: Mapping[str, float] = field(default_factory=dict)
    overlap_frac: float = 0.25
    slowdown_events: Tuple[Tuple[float, int, float], ...] = ()
    contention: Optional[ContentionSchedule] = None
    # endogenous cross-job contention: None (empty fabric, v1-identical) or
    # "fair-share" (co-running cross-rack jobs split uplink/spine capacity)
    contention_mode: Optional[str] = None
    rack_uplink_bw: Optional[float] = None  # bytes/s; None = 4x NIC rate
    spine_bw: Optional[float] = None        # bytes/s; None = 8x NIC rate
    # workload
    # batch | poisson | bursty | mixed | philly | csv | helios-csv | pai-csv
    trace: str = "batch"
    n_jobs: int = 500
    trace_kw: Mapping[str, Any] = field(default_factory=dict)
    csv_path: Optional[str] = None
    # streamed replay: pull arrivals lazily from a TraceSource cursor
    # instead of pre-heaping the whole trace (constant-memory; schema v6).
    # The event sequence is bit-identical either way — streaming changes
    # provenance and memory, never the simulated schedule.
    stream: bool = False
    # hybrid-parallelism plans: None (pure DP, v1-identical) or "auto"
    # (per-job DP/TP/PP/EP plans derived from model family and demand)
    parallelism: Optional[str] = None
    # every way the cluster hurts: binary machine churn (mode/knobs),
    # analog degradation (stragglers / slow NICs / flapping uplinks) and
    # opt-in telemetry — see repro_torch.experiments.faults.FaultSpec.  None =
    # nothing ever goes wrong (legacy-identical).
    faults: Optional[FaultSpec] = None
    # defaults for the simulation
    policy: str = "dally"
    round_period: float = 300.0
    max_time: float = math.inf
    # checkpoint/restore overhead charged when preempted jobs resume
    # (0.0 keeps legacy artifacts byte-identical)
    checkpoint_overhead: float = 0.0

    # -- builders -------------------------------------------------------
    def with_overrides(self, **kw) -> "Scenario":
        """A copy with the given fields replaced (None values ignored).
        An explicit n_racks override wins over heterogeneous rack_sizes —
        the result is a uniform cluster of that many racks (otherwise the
        override would be silently ignored while still being recorded in
        the artifact's provenance).  A ``faults`` override merges axis-
        wise over the scenario's own spec (``FaultSpec.merged_over``): a
        mode switch drops the scenario's knobs — they belong to the other
        mode's schema, and the documented "--failures overrides every
        scenario" sweep must not abort on a scenario that tunes its own
        churn."""
        kw = {k: v for k, v in kw.items() if v is not None}
        if kw.get("n_racks") is not None and self.rack_sizes is not None:
            kw.setdefault("rack_sizes", None)
        if kw.get("faults") is not None:
            kw["faults"] = kw["faults"].merged_over(self.faults)
        return dataclasses.replace(self, **kw) if kw else self

    def build_cluster(self) -> ClusterTopology:
        fabric_kw = dict(rack_uplink_bw=self.rack_uplink_bw,
                         spine_bw=self.spine_bw)
        if self.rack_sizes is not None:
            return ClusterTopology(machines_per_rack=self.machines_per_rack,
                                   gpus_per_machine=self.gpus_per_machine,
                                   rack_sizes=self.rack_sizes, **fabric_kw)
        return ClusterTopology(n_racks=self.n_racks,
                               machines_per_rack=self.machines_per_rack,
                               gpus_per_machine=self.gpus_per_machine,
                               **fabric_kw)

    def _effective_nic_bw(self) -> float:
        """Per-participant network-tier bandwidth after bandwidth_scale —
        mirrors build_comm's profile scaling, from scenario data alone."""
        bw = PROFILES[self.profile].tier("network").bandwidth
        return bw * self.bandwidth_scale.get("network", 1.0)

    def _fabric_capacities(self, nic_bw: float) -> Tuple[float, float]:
        """(rack_uplink_bw, spine_bw) with the uncontended defaults
        resolved — the single source for both the simulated fabric and
        the artifact provenance."""
        uplink = (self.rack_uplink_bw if self.rack_uplink_bw is not None
                  else DEFAULT_UPLINK_X * nic_bw)
        spine = (self.spine_bw if self.spine_bw is not None
                 else DEFAULT_SPINE_X * nic_bw)
        return uplink, spine

    def build_fabric(self, cluster: ClusterTopology,
                     comm: CommModel) -> Optional[FairShareFabric]:
        if self.contention_mode is None:
            return None
        if self.contention_mode not in CONTENTION_MODES:
            raise ValueError(
                f"scenario {self.name!r}: unknown contention_mode "
                f"{self.contention_mode!r}; known: "
                f"{', '.join(str(m) for m in CONTENTION_MODES)}")
        nic_bw = comm.profile.tier("network").bandwidth
        uplink, spine = self._fabric_capacities(nic_bw)
        return FairShareFabric(cluster, nic_bw=nic_bw,
                               rack_uplink_bw=uplink, spine_bw=spine)

    def build_comm(self, archs, calibration=None) -> CommModel:
        profile = PROFILES[self.profile]
        if self.bandwidth_scale:
            # contended network regime: scale per-tier usable bandwidth
            tiers = tuple(
                dataclasses.replace(
                    t, bandwidth=t.bandwidth * self.bandwidth_scale.get(t.name, 1.0))
                for t in profile.tiers)
            profile = dataclasses.replace(profile, tiers=tiers)
        return CommModel.from_configs(archs, profile=profile,
                                      overlap_frac=self.overlap_frac,
                                      calibration=calibration)

    def build_failures(self, machine_ids, seed: int):
        """The cell's failure schedule, or None when churn is off.
        ``machine_ids`` must be the machines that actually hold GPUs
        (failing a ghost stride slot of a heterogeneous topology would
        silently dilute the effective churn)."""
        mode = self.faults.mode if self.faults is not None else None
        if mode is None:
            return None
        if mode not in FAILURE_MODES:
            raise ValueError(
                f"scenario {self.name!r}: unknown failure mode {mode!r}; "
                f"known: {', '.join(str(m) for m in FAILURE_MODES)}")
        kw = dict(self.faults.knobs)
        if mode == "mtbf":
            return make_mtbf_failures(machine_ids, seed=seed, **kw)
        # "maintenance" draws nothing from the seed: the schedule is a
        # pure function of the machine list (rolling windows)
        return make_rolling_maintenance(machine_ids, **kw)

    def build_degradations(self, machine_ids, rack_ids, seed: int):
        """The cell's analog degradation schedule, or None when off.
        Same ``machine_ids`` contract as :meth:`build_failures`;
        ``rack_ids`` are the racks whose uplinks may derate."""
        mode = self.faults.degradation if self.faults is not None else None
        if mode is None:
            return None
        kw = dict(self.faults.degradation_kw)
        if mode == "stragglers":
            return make_straggler_degradations(machine_ids, seed=seed, **kw)
        if mode == "slow-nics":
            return make_slow_nic_degradations(rack_ids, seed=seed, **kw)
        if mode == "flapping-uplinks":
            return make_flapping_uplink_degradations(rack_ids, seed=seed,
                                                     **kw)
        if mode == "mixed":
            return make_mixed_degradations(machine_ids, rack_ids,
                                           seed=seed, **kw)
        raise ValueError(  # FaultSpec validates; direct field poking lands here
            f"scenario {self.name!r}: unknown degradation mode {mode!r}")

    def _check_trace_kinds(self):
        if self.parallelism not in PARALLELISM_MODES:
            raise ValueError(
                f"scenario {self.name!r}: unknown parallelism "
                f"{self.parallelism!r}; known: "
                f"{', '.join(str(m) for m in PARALLELISM_MODES)}")
        if self.trace in ("csv", "helios-csv", "pai-csv"):
            if not self.csv_path:
                raise ValueError(
                    f"scenario {self.name!r} replays a CSV trace; set "
                    "csv_path (e.g. Scenario.with_overrides(csv_path=...) "
                    "or sweep --csv)")
            if self.parallelism is not None:
                # refusing beats silently emitting v3 provenance for a
                # feature the CSV trace cannot carry (plan columns, when
                # present, ride in on the jobs themselves)
                raise ValueError(
                    f"scenario {self.name!r}: parallelism="
                    f"{self.parallelism!r} is not supported for CSV "
                    "replays (the trace carries no derivable plans)")

    def build_trace(self, archs, seed: int):
        self._check_trace_kinds()
        if self.trace == "csv":
            return load_csv_trace(self.csv_path, archs, **dict(self.trace_kw))
        if self.trace in ("helios-csv", "pai-csv"):
            # the adapters are streaming-native; materialize by draining
            return list(self.build_trace_source(archs, seed))
        kw = dict(self.trace_kw)
        if self.parallelism is not None:
            kw["parallelism"] = self.parallelism
            # plans size TP groups against the cluster's real machine width
            kw.setdefault("gpus_per_machine", self.gpus_per_machine)
        maker = TRACE_MAKERS[self.trace]
        return maker(archs, n_jobs=self.n_jobs, seed=seed, **kw)

    def build_trace_source(self, archs, seed: int) -> TraceSource:
        """The cell's streaming :class:`TraceSource` — the lazy twin of
        :meth:`build_trace`, emitting the SAME jobs in the same
        submission order.  Synthetic kinds with a streaming twin
        (batch / poisson / philly / mixed) and the CSV adapters emit
        one job at a time in O(1)/O(#rows·24B) memory; kinds whose
        construction is inherently whole-trace (bursty's flash-crowd
        sort, the legacy ``csv`` loader) fall back to a
        :class:`MaterializedTrace` wrapper — same jobs, not
        constant-memory."""
        self._check_trace_kinds()
        if self.trace == "helios-csv":
            return HeliosCsvTrace(self.csv_path, archs,
                                  **dict(self.trace_kw))
        if self.trace == "pai-csv":
            return AlibabaPaiTrace(self.csv_path, archs,
                                   **dict(self.trace_kw))
        maker = STREAMING_MAKERS.get(self.trace)
        if maker is None:
            return MaterializedTrace(self.build_trace(archs, seed))
        kw = dict(self.trace_kw)
        if self.parallelism is not None:
            kw["parallelism"] = self.parallelism
            kw.setdefault("gpus_per_machine", self.gpus_per_machine)
        return maker(archs, n_jobs=self.n_jobs, seed=seed, **kw)

    def build_sim(self, archs, policy: Optional[str] = None, seed: int = 0,
                  comm: Optional[CommModel] = None,
                  submit_trace: bool = True,
                  trace_source: Optional[TraceSource] = None
                  ) -> ClusterSimulator:
        """Build the cell's simulator.  ``submit_trace=False`` builds the
        cluster/network/failure regime but submits no jobs — the service
        daemon's open-world mode, where arrivals come from the inbox.

        When ``self.stream`` is set (or an explicit ``trace_source`` is
        injected), the trace is attached as a lazy source cursor instead
        of being submitted up front: identical event sequence, constant
        memory."""
        cluster = self.build_cluster()
        # machines that actually hold GPUs (pre-allocation: full capacity),
        # excluding the empty stride slots of heterogeneous topologies
        real = [m for m in range(cluster.n_machines)
                if cluster.free[m] > 0]
        rack_ids = sorted({m // cluster.machines_per_rack for m in real})
        events = list(self.slowdown_events)
        if self.contention is not None:
            events += self.contention.events(real, seed)
        comm = comm or self.build_comm(archs)
        fabric = self.build_fabric(cluster, comm)
        degradations = self.build_degradations(real, rack_ids, seed)
        if degradations is not None and fabric is None \
                and any(d[1] == "link" for d in degradations):
            raise ValueError(
                f"scenario {self.name!r}: link-derating degradation "
                f"({self.faults.degradation!r}) requires "
                "contention_mode='fair-share' — without a shared fabric "
                "there is no link bandwidth to derate")
        telemetry = bool(self.faults.telemetry) if self.faults else False
        sim = ClusterSimulator(cluster,
                               make_policy(policy or self.policy),
                               comm,
                               round_period=self.round_period,
                               checkpoint_overhead=self.checkpoint_overhead,
                               slowdown_events=events or None,
                               failure_events=self.build_failures(real, seed),
                               degradation_events=degradations,
                               fabric=fabric,
                               telemetry=telemetry)
        if submit_trace:
            if trace_source is not None:
                sim.attach_source(trace_source)
            elif self.stream:
                sim.attach_source(self.build_trace_source(archs, seed))
            else:
                for job in self.build_trace(archs, seed):
                    sim.submit(job)
        return sim

    def config_dict(self) -> Dict[str, Any]:
        """JSON-serializable scenario description (artifact provenance).

        The shared-fabric keys appear only when ``contention_mode`` is set:
        a disabled-contention artifact stays byte-identical to schema v1.
        """
        out = {
            "n_racks": self.n_racks,
            "machines_per_rack": self.machines_per_rack,
            "gpus_per_machine": self.gpus_per_machine,
            "rack_sizes": list(self.rack_sizes) if self.rack_sizes else None,
            "profile": self.profile,
            "bandwidth_scale": dict(self.bandwidth_scale),
            "overlap_frac": self.overlap_frac,
            "n_slowdown_events": len(self.slowdown_events),
            "contention": (dataclasses.asdict(self.contention)
                           if self.contention else None),
            "trace": self.trace,
            "n_jobs": self.n_jobs,
            "trace_kw": dict(self.trace_kw),
            "csv_path": self.csv_path,
            "policy": self.policy,
            "round_period": self.round_period,
            "max_time": (None if math.isinf(self.max_time)
                         else self.max_time),
        }
        if self.contention_mode is not None:
            # record the EFFECTIVE capacities (defaults resolved against the
            # scenario's scaled profile), not the raw None fields — the
            # artifact must pin the simulation inputs even if the default
            # multipliers or profiles change later
            uplink, spine = self._fabric_capacities(self._effective_nic_bw())
            out["contention_mode"] = self.contention_mode
            out["rack_uplink_bw"] = uplink
            out["spine_bw"] = spine
        # schema-v3 keys, emitted only when the features are on: legacy
        # scenarios' artifacts must stay byte-identical to v1/v2
        if self.parallelism is not None:
            out["parallelism"] = self.parallelism
        if self.checkpoint_overhead:
            out["checkpoint_overhead"] = self.checkpoint_overhead
        # schema-v4 keys: like the fabric capacities, the RESOLVED failure
        # knobs are recorded (defaults merged), so the artifact pins the
        # simulated churn even if the mode's defaults change later.  The
        # key NAMES predate FaultSpec and stay — v4 artifacts must remain
        # byte-identical.
        f = self.faults
        if f is not None and f.mode is not None:
            out["failure_mode"] = f.mode
            out["failure_kw"] = resolve_failure_kw(f.mode, dict(f.knobs))
        # schema-v5 keys (analog degradation + telemetry), same contract:
        # resolved knobs, emitted only when the features are on
        if f is not None and f.degradation is not None:
            out["degradation"] = f.degradation
            out["degradation_kw"] = resolve_degradation_kw(
                f.degradation, dict(f.degradation_kw))
        if f is not None and f.telemetry:
            out["telemetry"] = True
        # schema-v6 key (streamed replay), same contract: emitted only
        # when streaming is on, so every materialized cell keeps its
        # v1-v5 bytes
        if self.stream:
            out["stream"] = True
        return out


# ---------------------------------------------------------------------------
# Registry
# ---------------------------------------------------------------------------

SCENARIOS: Dict[str, Scenario] = {}


def register(scenario: Scenario) -> Scenario:
    SCENARIOS[scenario.name] = scenario
    return scenario


def get_scenario(name: str) -> Scenario:
    try:
        return SCENARIOS[name]
    except KeyError:
        raise KeyError(f"unknown scenario {name!r}; known: "
                       f"{', '.join(sorted(SCENARIOS))}") from None


def scenario_from_csv(path: str, name: str = "csv-replay", **kw) -> Scenario:
    return Scenario(name=name, trace="csv", csv_path=path,
                    description=f"replay of {path}", **kw)


# -- the paper's regimes (§V-A) ---------------------------------------------
register(Scenario(
    "paper-batch",
    description="500 jobs, all at t=0, congested cluster (Figs. 7-9)",
    trace="batch", n_jobs=500))
register(Scenario(
    "paper-poisson",
    description="400 jobs, Poisson arrivals at peak load (Fig. 10, Tbl III)",
    trace="poisson", n_jobs=400))
register(Scenario(
    "demo",
    description="examples/cluster_scheduling.py scale: 200 jobs, 4 racks",
    n_racks=4, trace="batch", n_jobs=200))
register(Scenario(
    "smoke",
    description="CI-sized: 60 jobs on 2 racks, finishes in <1s per policy",
    n_racks=2, trace="batch", n_jobs=60))

# -- beyond the paper --------------------------------------------------------
register(Scenario(
    "hetero-racks",
    description="heterogeneous rack sizes (8/8/6/4/2/2 machines): "
    "consolidation targets differ per rack",
    rack_sizes=(8, 8, 6, 4, 2, 2), trace="batch", n_jobs=400))
register(Scenario(
    "contended-network",
    description="rack/network bandwidth halved/quartered by background "
    "traffic + recurring per-machine contention windows",
    bandwidth_scale={"rack": 0.5, "network": 0.25},
    contention=ContentionSchedule(),
    trace="batch", n_jobs=400))
register(Scenario(
    "bursty-diurnal",
    description="diurnal arrival rate (4x day/night swing), no flash crowds",
    trace="bursty", n_jobs=400,
    trace_kw={"flash_crowds": 0, "peak_to_trough": 4.0}))
register(Scenario(
    "flash-crowd",
    description="diurnal base + 40% of jobs in 3 ten-minute flash crowds",
    trace="bursty", n_jobs=400,
    trace_kw={"flash_crowds": 3, "flash_fraction": 0.4}))
register(Scenario(
    "datacenter-mix",
    description="Helios-style mix: many small short jobs + a 15% tail of "
    "16-128 GPU production jobs (128 > one rack)",
    trace="mixed", n_jobs=400))
register(Scenario(
    "multi-tenant",
    description="the datacenter mix with Helios-style tenant skew and "
    "priority classes (low/normal/high): priority-scaled scoring + the "
    "preemption-class gate, per-tenant metrics in the artifact (schema v7)",
    trace="multi-tenant", n_jobs=400))
register(Scenario(
    "straggler",
    description="paper-batch with 3x slowdown on four machines from t=0 "
    "(straggler tolerance)",
    trace="batch", n_jobs=400,
    slowdown_events=((0.0, 0, 3.0), (0.0, 1, 3.0),
                     (0.0, 2, 3.0), (0.0, 3, 3.0))))
register(Scenario(
    "csv-replay",
    description="replay an external Philly/Helios-style CSV (needs "
    "csv_path override / sweep --csv)",
    trace="csv", n_jobs=0))

# -- endogenous cross-job contention (shared fabric, schema v2) ---------------
# The reference sized these on its TPU v5e profile, whose NIC rate is 25e9 B/s
# per participant: spine_bw=50e9 saturates at two full-rate cross-rack jobs and
# rack_uplink_bw=25e9 at one per rack.  The numbers stay; on the paper's
# cluster (a 100e9 B/s network tier) one cross-rack job already exceeds both,
# so the descriptions below state the regime these numbers set here.
register(Scenario(
    "congested-spine",
    description="fair-share fabric with a spine at half the NIC rate "
    "(50e9 of 100e9 B/s): even a lone cross-rack job runs at half rate, "
    "and scattered placements throttle each other further",
    contention_mode="fair-share", spine_bw=50e9,
    trace="batch", n_jobs=400))
register(Scenario(
    "oversubscribed-uplinks",
    description="fair-share fabric, rack uplinks at a quarter of the NIC "
    "rate (25e9 of 100e9 B/s; heavy oversubscription): a lone cross-rack "
    "job runs at quarter rate, every extra one on a rack halves both",
    contention_mode="fair-share", rack_uplink_bw=25e9,
    trace="batch", n_jobs=400))
register(Scenario(
    "consolidate-vs-scatter",
    description="A/B regime for the contention benchmark: run with a "
    "consolidating policy (dally) vs a scatter baseline (gandiva) on a "
    "spine at a quarter of the NIC rate (25e9 of 100e9 B/s), which one "
    "cross-rack job already saturates",
    contention_mode="fair-share", spine_bw=25e9,
    n_racks=4, trace="batch", n_jobs=150))

# -- hybrid parallelism (per-job DP/TP/PP/EP plans, schema v3) ----------------
register(Scenario(
    "mixed-parallelism",
    description="datacenter mix with auto-derived DP/TP/PP/EP plans: MoE "
    "jobs run expert-parallel, large dense jobs split TP x PP",
    parallelism="auto", trace="mixed", n_jobs=400))
register(Scenario(
    "moe-heavy",
    description="all-hybrid congested mix (MoE expert-parallel + TP/PP "
    "vlm jobs, 8-64 GPUs) on a spine at a quarter of the NIC rate: expert all-to-all is hyper-sensitive to "
    "cross-rack placement, pipeline stages tolerate it — the regime where "
    "pattern-aware consolidation (dally) beats pattern-blind (dally-blind)",
    parallelism="auto", contention_mode="fair-share", spine_bw=25e9,
    trace="batch", n_jobs=300,
    trace_kw={"families": ("moe", "vlm"),
              "demand_pmf": ((8, 0.35), (16, 0.30), (32, 0.20),
                             (64, 0.15))}))
register(Scenario(
    "pipeline-tolerant",
    description="large dense jobs split TP x PP on a congested fabric "
    "(a spine at half the NIC rate): "
    "pipeline stages tolerate cross-rack placement, yielding rack-local "
    "slots to placement-sensitive jobs",
    parallelism="auto", contention_mode="fair-share", spine_bw=50e9,
    trace="batch", n_jobs=300,
    trace_kw={"families": ("dense", "vlm", "moe"),
              "demand_pmf": ((8, 0.25), (16, 0.35), (32, 0.25),
                             (64, 0.15))}))

# -- datacenter scale (Hu et al. 2021: thousands of machines, 10k+ jobs) ------
# Arrival rates scale with cluster size (constant offered load per GPU), so
# the family traces one workload regime across 256/512/1024 machines.  These
# are the cells the O(1) topology indexing exists for: a deep wait queue
# probing capacity every round on a 1000+-machine cell.
register(Scenario(
    "dc-256",
    description="256 machines (32 racks), 10k-job Poisson at peak load: "
    "the smallest datacenter-scale cell (fig14 speedup reference)",
    n_racks=32, trace="poisson", n_jobs=10_000,
    trace_kw={"mean_interarrival": 120.0}))
register(Scenario(
    "dc-256-contended",
    description="dc-256 on a fair-share fabric (default uplink/spine "
    "capacities): datacenter scale with endogenous contention",
    n_racks=32, contention_mode="fair-share",
    trace="poisson", n_jobs=10_000,
    trace_kw={"mean_interarrival": 120.0}))
register(Scenario(
    "dc-512",
    description="512 machines (64 racks), 20k-job Poisson at the same "
    "per-GPU load as dc-256",
    n_racks=64, trace="poisson", n_jobs=20_000,
    trace_kw={"mean_interarrival": 60.0}))
register(Scenario(
    "dc-1024",
    description="1024 machines (128 racks), 50k-job Poisson at the same "
    "per-GPU load as dc-256: the first four-digit-machine cell",
    n_racks=128, trace="poisson", n_jobs=50_000,
    trace_kw={"mean_interarrival": 30.0}))
register(Scenario(
    "dc-256-philly",
    description="256 machines replaying a synthetic Philly-style trace "
    "(single-GPU-dominated, short-median/long-tail runtimes, 10k jobs)",
    n_racks=32, trace="philly", n_jobs=10_000,
    trace_kw={"mean_interarrival": 20.0}))
register(Scenario(
    "dc-1024-philly",
    description="1024 machines, 50k-job synthetic Philly-style trace: "
    "the deep-queue small-job regime at full datacenter scale",
    n_racks=128, trace="philly", n_jobs=50_000,
    trace_kw={"mean_interarrival": 5.0}))

# -- failures & churn (machine fail/recover, schema v4) -----------------------
# Hardware failures and maintenance churn are a first-order effect on real
# GPU datacenters (Hu et al. 2021); these cells stress re-placement as
# capacity comes and goes.  Consolidated placements intersect fewer
# machines, so each failure kills fewer jobs — the regime the JAX package's
# fig15 measures.
register(Scenario(
    "failure-prone",
    description="paper-batch under seeded MTBF/MTTR machine churn (24h "
    "MTBF, 2h MTTR per machine: one failure somewhere every ~20 min) with "
    "a 2-minute checkpoint-restore surcharge per lost placement",
    faults=FaultSpec(mode="mtbf",
                     knobs={"mtbf": 24 * 3600.0, "mttr": 2 * 3600.0}),
    checkpoint_overhead=120.0,
    trace="batch", n_jobs=400))
register(Scenario(
    "rolling-maintenance",
    description="deterministic rolling maintenance: half-rack batches of "
    "4 machines down for 1h each, back to back, two full passes",
    faults=FaultSpec(mode="maintenance",
                     knobs={"start": 4 * 3600.0, "window": 3600.0,
                            "batch_size": 4, "rounds": 2}),
    trace="batch", n_jobs=400))
register(Scenario(
    "hotspot-flaky",
    description="a flaky 25% of machines on a short 8h-MTBF/30min-MTTR "
    "cycle, on a congested fair-share spine: churn and endogenous "
    "contention compound",
    contention_mode="fair-share", spine_bw=50e9,
    faults=FaultSpec(mode="mtbf",
                     knobs={"mtbf": 8 * 3600.0, "mttr": 1800.0,
                            "scope": 0.25}),
    checkpoint_overhead=120.0,
    trace="batch", n_jobs=300))

# -- analog degradation (stragglers / slow NICs / flapping links, schema v5) --
# Real clusters mostly hurt you analog (Hu et al. 2021): machines that run
# slow rather than die, links that shrink rather than drop.  These cells
# stress the continuous performance-fault subsystem — straggler re-pricing,
# link derating composed with fair-share contention, and dally's
# evict-or-tolerate reaction.  The JAX package's fig16 measures the mixed
# regime.
register(Scenario(
    "straggler-degradation",
    description="paper-batch under seeded straggler/throttling episodes: "
    "a quarter of the machines intermittently run 1.3-2.5x slow (12h "
    "mean healthy time, 2h mean episode)",
    faults=FaultSpec(degradation="stragglers"),
    trace="batch", n_jobs=400))
register(Scenario(
    "slow-nics",
    description="chronic hardware lemons on a fair-share fabric: a seeded "
    "quarter of the rack uplinks run at half bandwidth for the whole run",
    contention_mode="fair-share", spine_bw=50e9,
    faults=FaultSpec(degradation="slow-nics"),
    trace="batch", n_jobs=400))
register(Scenario(
    "flapping-uplinks",
    description="flapping rack uplinks on a fair-share fabric: a seeded "
    "quarter of the uplinks intermittently derate to 25% bandwidth "
    "(4h mean healthy time, 30min mean flap)",
    contention_mode="fair-share", spine_bw=50e9,
    faults=FaultSpec(degradation="flapping-uplinks"),
    trace="batch", n_jobs=400))
register(Scenario(
    "degraded-cluster",
    description="the fig16 regime: stragglers + flapping uplinks together "
    "on a congested fair-share spine — analog churn on both the compute "
    "and the network axis",
    contention_mode="fair-share", spine_bw=50e9,
    faults=FaultSpec(degradation="mixed"),
    trace="batch", n_jobs=300))

# -- streamed replay (constant-memory trace sources, schema v6) ---------------
# Million-job cells from public GPU-cluster traces (Weng et al. 2022's PAI
# GPU-2020 task table ships ~1.2M tasks): the trace streams through a lazy
# source cursor and finished jobs spill to JSONL shards, so peak RSS stays
# flat as the trace grows.  The JAX package's benchmarks/fig17_replay.py
# measures exactly that and checks simulated utilization against the trace's recorded utilization.
register(Scenario(
    "million-replay",
    description="1024 machines streaming a 1M-job synthetic Philly-style "
    "trace through the lazy source cursor — the constant-memory cell "
    "fig17 replays (peak RSS stays flat as the trace grows)",
    n_racks=128, trace="philly", stream=True, n_jobs=1_000_000,
    trace_kw={"mean_interarrival": 8.0}))
register(Scenario(
    "pai-replay",
    description="streamed replay of an Alibaba PAI GPU-2020 task table "
    "(cluster-trace-gpu-v2020 schema; needs csv_path override / sweep "
    "--csv): task rows aggregate per job on a single scan pass",
    n_racks=32, trace="pai-csv", stream=True, n_jobs=0))
register(Scenario(
    "helios-replay",
    description="csv-replay's constant-memory twin: stream an external "
    "Philly/Helios-style CSV off the file without materializing it "
    "(needs csv_path override / sweep --csv)",
    trace="helios-csv", stream=True, n_jobs=0))

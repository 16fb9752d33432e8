"""Dally: network-placement sensitive cluster scheduling (the paper's core).

The port's copy of the JAX package's ``repro.core``: plain Python and numpy
on the host, line for line the reference but for its imports, ``model_skew``
(which walks the port's parameter schema) and the default hardware profile
(``NVIDIA_PAPER``).  It has the reference's streaming trace sources
(``trace_source``) and completion spill (``spill``), and the retained
linear-scan ``NaiveClusterTopology``, which the tests hold the indexed
topology to.

Components (paper §IV):
  topology    — hierarchical cluster (machine / rack / network tiers)
  commmodel   — per-placement communication latency (ASTRA-sim analogue,
                calibrated against this repo's compiled dry-run collectives)
  parallelism — per-job hybrid DP/TP/PP/EP plans: per-pattern collective
                traffic (ring / all-gather / point-to-point / all-to-all)
  fabric      — shared rack-uplink/spine fabric: cross-job fair-share
                bandwidth (endogenous contention), weighted by each plan's
                actual link usage
  simulator   — event-driven multi-job cluster simulator (ArtISt-sim analogue)
  autotuner   — delay-timer auto-tuning from starvation-time history (Algo 2)
  policies    — Dally (Algo 1 + Nw_sens preemption), Tiresias, Gandiva,
                Dally-manual / -noWait / -fullyConsolidated
  trace       — batch + Poisson workload generators (SenseTime-like stats)
                + machine failure/maintenance schedules (MTBF/MTTR churn)
  trace_source— streaming TraceSource cursors: constant-memory twins of
                the synthetic makers + Helios/PAI public-trace adapters
  spill       — incremental JSONL spill of finished-job records with
                per-shard content digests (constant-memory replay)
  metrics     — makespan / JCT / queueing delay / communication latency
  profile     — opt-in per-phase wall-clock counters for the scheduling
                hot loop (``sim.profile = SimProfile()``); never affects
                a schedule
"""
from .autotuner import AutoTuner  # noqa: F401
from .commmodel import CommModel  # noqa: F401
from .fabric import FairShareFabric  # noqa: F401
from .job import Job  # noqa: F401
from .metrics import FinishedTally, summarize  # noqa: F401
from .parallelism import ParallelPlan, plan_for, pure_dp_plan  # noqa: F401
from .profile import SimProfile  # noqa: F401
from .simulator import ClusterSimulator  # noqa: F401
from .spill import SpillWriter, read_spilled, verify_manifest  # noqa: F401
from .telemetry import Telemetry  # noqa: F401
from .topology import (  # noqa: F401
    ClusterTopology,
    NaiveClusterTopology,
    Placement,
)
from .trace import (  # noqa: F401
    load_csv_trace,
    make_batch_trace,
    make_bursty_trace,
    make_flapping_uplink_degradations,
    make_mixed_degradations,
    make_mixed_trace,
    make_mtbf_failures,
    make_multi_tenant_trace,
    make_philly_trace,
    make_poisson_trace,
    make_rolling_maintenance,
    make_slow_nic_degradations,
    make_straggler_degradations,
    resolve_degradation_kw,
    save_csv_trace,
)
from .trace_source import (  # noqa: F401
    STREAMING_MAKERS,
    AlibabaPaiTrace,
    HeliosCsvTrace,
    MaterializedTrace,
    TraceSource,
    as_source,
)

"""Parallel experiment sweep runner.

Fans (scenario x policy x seed) cells across worker processes and writes one
deterministic JSON artifact per cell plus a sweep index:

    python -m repro_torch.experiments.sweep \
        --scenarios paper-batch,paper-poisson \
        --policies dally,tiresias,gandiva --seeds 3 --workers 4

Determinism: each cell is rebuilt from (scenario, policy, seed) alone inside
its worker, and artifacts exclude wall-clock timing, so per-cell files are
byte-identical whatever the worker count or scheduling order.  Timing lives
in the index (``sweep.json``).

The port's copy of the JAX package's ``repro.experiments.sweep``, line for
line but for its imports and two exceptions.  Its default ``--out`` is
``runs/sweep``, not the reference's ``benchmarks/artifacts/sweep``: the two
packages write files of the same names but price them on different
profiles, so one must not overwrite the other's.  It has no
``--naive-topology`` (``SimOverrides`` has no such field in the port).
"""
from __future__ import annotations

import argparse
import json
import multiprocessing as mp
import pathlib
import time
from concurrent.futures import ProcessPoolExecutor
from typing import List, Optional, Sequence, Tuple

from .faults import FaultSpec
from .runner import SimOverrides, artifact_json, run_one
from .scenario import SCENARIOS, get_scenario, scenario_from_csv

DEFAULT_OUT = pathlib.Path("runs") / "sweep"

# scenario, csv, policy, seed, SimOverrides.to_dict() wire form (tasks cross
# a process boundary, so the overrides travel serialized and are rebuilt
# with SimOverrides.from_dict inside the worker)
Task = Tuple[str, Optional[str], str, int, dict]


def _cell_name(scenario: str, policy: str, seed: int) -> str:
    return f"{scenario}__{policy}__seed{seed}.json"


def _peak_rss_mb() -> Optional[float]:
    """This process's lifetime peak RSS in MB (None off-POSIX).  With
    pooled workers a cell's row reports the worker's max-so-far — an
    upper bound, monotone within a worker — which is exactly the signal
    the streamed-replay cells exist to keep flat."""
    try:
        import resource
    except ImportError:  # pragma: no cover - non-POSIX
        return None
    return resource.getrusage(resource.RUSAGE_SELF).ru_maxrss / 1024.0


def _run_cell(task: Task, out_dir: str) -> dict:
    """Worker entry: simulate one cell, write its artifact, return a summary
    row for the index (artifacts stay on disk; only headlines travel back)."""
    scenario_name, csv_path, policy, seed, overrides = task
    t0 = time.time()
    if csv_path:
        scenario = get_scenario(scenario_name) \
            if scenario_name in SCENARIOS else None
        if scenario is not None and scenario.trace in ("helios-csv",
                                                       "pai-csv"):
            # the streamed adapters keep their registered scenario; only
            # the file path is filled in
            scenario = scenario.with_overrides(csv_path=csv_path)
        else:
            scenario = scenario_from_csv(csv_path, name=scenario_name)
    else:
        scenario = get_scenario(scenario_name)
    art = run_one(scenario, policy=policy, seed=seed,
                  overrides=SimOverrides.from_dict(overrides))
    path = pathlib.Path(out_dir) / _cell_name(scenario_name, policy, seed)
    path.write_text(artifact_json(art))
    m = art["metrics"]
    row = {
        "file": path.name,
        "scenario": scenario_name,
        "policy": policy,
        "seed": seed,
        "makespan": m["makespan"],
        "avg_jct": m["jct"]["avg"],
        "p99_jct": m["jct"]["p99"],
        "avg_utilization": m["avg_utilization"],
        "n_finished": m["n_finished"],
        "wedged": bool(m.get("wedged", False)),
        "peak_rss_mb": _peak_rss_mb(),
        "wall_s": time.time() - t0,
    }
    if "spill" in m:
        row["spilled_jobs"] = m["spill"]["n_jobs"]
    return row


def sweep(scenarios: Sequence[str], policies: Sequence[str],
          seeds: Sequence[int], *, workers: int = 1,
          out_dir=DEFAULT_OUT, csv: Optional[str] = None,
          n_jobs: Optional[int] = None, n_racks: Optional[int] = None,
          max_time: Optional[float] = None,
          contention: Optional[str] = None,
          parallelism: Optional[str] = None,
          failures: Optional[str] = None,
          degradation: Optional[str] = None,
          telemetry: bool = False,
          stream: bool = False, spill: bool = False) -> dict:
    """Run the full cross product and return the index dict."""
    out_dir = pathlib.Path(out_dir)
    out_dir.mkdir(parents=True, exist_ok=True)
    faults = (FaultSpec(mode=failures, degradation=degradation,
                        telemetry=telemetry)
              if (failures or degradation or telemetry) else None)
    overrides = SimOverrides(n_jobs=n_jobs, n_racks=n_racks,
                             max_time=max_time, contention=contention,
                             parallelism=parallelism, faults=faults,
                             stream=True if stream else None).to_dict()

    def _task(sc: str, pol: str, seed: int) -> Task:
        csv_kinds = ("csv", "helios-csv", "pai-csv")
        task_csv = csv if (csv and get_scenario(sc).trace in csv_kinds) \
            else None
        ov = dict(overrides)
        if spill:  # per-cell spill directory under the sweep output
            ov["spill_dir"] = str(
                out_dir / "spill" / f"{sc}__{pol}__seed{seed}")
        return (sc, task_csv, pol, seed, ov)

    tasks: List[Task] = [_task(sc, pol, seed)
                         for sc in scenarios for pol in policies
                         for seed in seeds]
    t0 = time.time()
    if workers > 1:
        # spawn: workers re-import cleanly (no forked JAX/threading state),
        # which also guarantees identical artifacts at any worker count
        ctx = mp.get_context("spawn")
        with ProcessPoolExecutor(max_workers=workers, mp_context=ctx) as ex:
            rows = list(ex.map(_run_cell, tasks,
                               [str(out_dir)] * len(tasks)))
    else:
        rows = [_run_cell(t, str(out_dir)) for t in tasks]
    index = {
        "schema": "repro.experiments.sweep/v1",
        "scenarios": list(scenarios),
        "policies": list(policies),
        "seeds": list(seeds),
        "overrides": overrides,  # SimOverrides wire form (non-defaults only)
        "runs": rows,
        "total_wall_s": time.time() - t0,
        "workers": workers,
    }
    (out_dir / "sweep.json").write_text(json.dumps(index, indent=1))
    return index


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(
        description="Parallel (scenario x policy x seed) experiment sweep")
    ap.add_argument("--scenarios", default="paper-batch",
                    help="comma-separated scenario names (see --list)")
    ap.add_argument("--policies", default="dally,tiresias,gandiva")
    ap.add_argument("--seeds", type=int, default=1,
                    help="number of seeds (0..N-1)")
    ap.add_argument("--seed-list", default=None,
                    help="explicit comma-separated seeds (overrides --seeds)")
    ap.add_argument("--workers", type=int, default=1)
    ap.add_argument("--out", default=str(DEFAULT_OUT))
    ap.add_argument("--csv", default=None,
                    help="CSV trace path for csv-replay scenarios")
    ap.add_argument("--n-jobs", type=int, default=None,
                    help="override every scenario's job count")
    ap.add_argument("--racks", type=int, default=None,
                    help="override every scenario's rack count")
    ap.add_argument("--max-time", type=float, default=None,
                    help="truncate runs at this simulated time (seconds)")
    ap.add_argument("--contention", default=None, choices=["fair-share"],
                    help="enable endogenous shared-fabric contention for "
                    "every scenario (schema v2 artifacts)")
    ap.add_argument("--parallelism", default=None, choices=["auto"],
                    help="enable hybrid DP/TP/PP/EP plan assignment for "
                    "every scenario's trace (schema v3 artifacts)")
    ap.add_argument("--failures", default=None,
                    choices=["mtbf", "maintenance"],
                    help="enable machine failure/maintenance churn for "
                    "every scenario (schema v4 artifacts)")
    ap.add_argument("--degradation", default=None,
                    choices=["stragglers", "slow-nics", "flapping-uplinks",
                             "mixed"],
                    help="enable analog degradation faults for every "
                    "scenario (schema v5 artifacts)")
    ap.add_argument("--telemetry", action="store_true",
                    help="record the Kalos-style per-interval telemetry "
                    "time-series in every artifact (schema v5)")
    ap.add_argument("--stream", action="store_true",
                    help="pull every scenario's trace lazily through a "
                    "TraceSource cursor instead of pre-heaping it "
                    "(identical artifacts modulo v6 provenance; constant "
                    "arrival memory)")
    ap.add_argument("--spill", action="store_true",
                    help="spill finished-job records to JSONL shards under "
                    "<out>/spill/<cell>/ instead of retaining them "
                    "(requires a streamed cell; schema v6 artifacts record "
                    "the shard digests)")
    ap.add_argument("--list", action="store_true",
                    help="list registered scenarios and exit")
    args = ap.parse_args(argv)

    if args.list:
        width = max(len(n) for n in SCENARIOS)
        for name in sorted(SCENARIOS):
            print(f"{name:{width}s}  {SCENARIOS[name].description}")
        return

    seeds = ([int(s) for s in args.seed_list.split(",")]
             if args.seed_list else list(range(args.seeds)))
    index = sweep(
        [s for s in args.scenarios.split(",") if s],
        [p for p in args.policies.split(",") if p],
        seeds, workers=args.workers, out_dir=args.out, csv=args.csv,
        n_jobs=args.n_jobs, n_racks=args.racks, max_time=args.max_time,
        contention=args.contention, parallelism=args.parallelism,
        failures=args.failures, degradation=args.degradation,
        telemetry=args.telemetry,
        stream=args.stream, spill=args.spill)
    for r in index["runs"]:
        print(f"{r['scenario']:>18s} {r['policy']:>22s} seed{r['seed']} "
              f"makespan={r['makespan']/3600:8.1f}h "
              f"avg_jct={r['avg_jct']/3600:7.2f}h "
              f"util={r['avg_utilization']:4.2f} wall={r['wall_s']:5.1f}s"
              + (" WEDGED" if r.get("wedged") else ""))
    print(f"sweep.total_wall_seconds,{index['total_wall_s']:.1f},"
          f"workers={index['workers']} cells={len(index['runs'])}")


if __name__ == "__main__":
    main()

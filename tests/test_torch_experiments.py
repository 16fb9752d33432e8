"""The port's experiments (``repro_torch.experiments``) against the JAX
package's: every registered scenario's artifact, the reference's deprecated
spellings that the port leaves out, the ``SimOverrides`` and ``FaultSpec``
wire forms, the linear-scan topology against the indexed one, the sweep's
CLI and the public ``api``.

The reference prices its jobs on its default profile, ``TPU_V5E``: its
``Scenario.profile`` defaults to ``"tpu_v5e"``, and its ``build_trace``,
``build_trace_source`` and CSV adapters call the makers without a profile,
so the makers' own default applies.  The port holds no TPU profile and
prices both on ``NVIDIA_PAPER``.  ``reference_on_the_paper_cluster`` puts
the reference on the paper's cluster for the length of a ``with`` block, and
edits no file of it: if it missed a default, the byte comparisons below
would fail.
"""
from __future__ import annotations

import contextlib
import csv
import dataclasses
import functools
import json
import os
import random
import subprocess
import sys
from pathlib import Path

import pytest

import repro.api
import repro.core as rc
import repro.core.trace_source as r_trace_source
import repro.experiments as rx
import repro.experiments.scenario as r_scenario
import repro.service.jobspec as r_jobspec
import repro.types as r_types
import repro_torch.api
import repro_torch.experiments as px
from repro.configs import ARCHS as R_ARCHS
from repro_torch.configs import ARCHS as P_ARCHS
import repro_torch.core.trace as p_trace
from repro_torch.core import ClusterTopology, NaiveClusterTopology, verify_manifest

ROOT = Path(__file__).resolve().parent.parent
CSV_KINDS = ("csv", "helios-csv", "pai-csv")
# Each registered scenario runs under dally and under one other policy, the
# others taken in turn over the sorted names.
OTHER_POLICIES = ("tiresias", "gandiva", "dally-manual", "dally-nowait",
                  "dally-fullyconsolidated", "dally-blind", "scatter")
# The cut every synthetic cell runs at here: its own racks where it names
# each rack's size, else N_RACKS racks; N_JOBS jobs.
N_RACKS, N_JOBS = 2, 40


@contextlib.contextmanager
def reference_on_the_paper_cluster():
    """The JAX package priced on NVIDIA_PAPER inside the block: every
    registered scenario's profile is "nvidia_paper", and every trace maker,
    streaming maker, CSV loader and adapter, and the job spec's
    compute_time_per_iter take profile=NVIDIA_PAPER.  Restores them all on
    exit."""
    paper = r_types.NVIDIA_PAPER
    with pytest.MonkeyPatch.context() as mp:
        for name, scenario in list(r_scenario.SCENARIOS.items()):
            mp.setitem(r_scenario.SCENARIOS, name,
                       dataclasses.replace(scenario, profile="nvidia_paper"))
        for makers in (r_scenario.TRACE_MAKERS, r_trace_source.STREAMING_MAKERS):
            for kind, maker in list(makers.items()):
                mp.setitem(makers, kind, functools.partial(maker, profile=paper))
        for name in ("load_csv_trace", "HeliosCsvTrace", "AlibabaPaiTrace"):
            mp.setattr(r_scenario, name,
                       functools.partial(getattr(r_scenario, name), profile=paper))
        mp.setattr(r_jobspec, "compute_time_per_iter",
                   functools.partial(r_jobspec.compute_time_per_iter, profile=paper))
        yield


@pytest.fixture(scope="module")
def paper():
    with reference_on_the_paper_cluster():
        yield


def cut(scenario, **kw):
    """The SimOverrides of a cell cut to N_RACKS racks and N_JOBS jobs."""
    if scenario.rack_sizes is None:
        kw.setdefault("n_racks", N_RACKS)
    return dict(n_jobs=N_JOBS, **kw)


def same(got, want):
    """got == want for two artifacts' bytes; where they differ, an assertion
    that names the first line that does (pytest's own diff of two long
    strings takes minutes)."""
    if got == want:
        return
    got_lines, want_lines = got.splitlines(), want.splitlines()
    for i, (a, b) in enumerate(zip(got_lines, want_lines)):
        if a != b:
            raise AssertionError(f"line {i + 1} differs: {a!r} against {b!r}")
    raise AssertionError(f"{len(got_lines)} lines against {len(want_lines)}")


def both(scenario, policy, seed=0, **kw):
    """(reference's, port's) artifact_json of a cell."""
    ref = rx.artifact_json(rx.run_one(scenario, policy, seed,
                                      overrides=rx.SimOverrides(**kw)))
    port = px.artifact_json(px.run_one(scenario, policy, seed,
                                       overrides=px.SimOverrides(**kw)))
    return ref, port


# -- the fixture -----------------------------------------------------------------

def test_fixture_prices_the_reference_on_the_paper_cluster_and_restores_it():
    scenarios = dict(r_scenario.SCENARIOS)
    makers = dict(r_scenario.TRACE_MAKERS), dict(r_trace_source.STREAMING_MAKERS)
    loaders = [getattr(r_scenario, n) for n in ("load_csv_trace", "HeliosCsvTrace",
                                                 "AlibabaPaiTrace")]
    ctpi = r_jobspec.compute_time_per_iter
    assert {s.profile for s in scenarios.values()} == {"tpu_v5e"}
    with reference_on_the_paper_cluster():
        assert {s.profile for s in r_scenario.SCENARIOS.values()} == {"nvidia_paper"}
        for maker in [*r_scenario.TRACE_MAKERS.values(),
                      *r_trace_source.STREAMING_MAKERS.values(),
                      r_scenario.load_csv_trace, r_jobspec.compute_time_per_iter]:
            assert maker.keywords == {"profile": r_types.NVIDIA_PAPER}
        assert r_jobspec.compute_time_per_iter(1e9) == p_trace.compute_time_per_iter(1e9)
    assert r_scenario.SCENARIOS == scenarios
    assert (r_scenario.TRACE_MAKERS, r_trace_source.STREAMING_MAKERS) == makers
    assert [getattr(r_scenario, n) for n in ("load_csv_trace", "HeliosCsvTrace",
                                             "AlibabaPaiTrace")] == loaders
    assert r_jobspec.compute_time_per_iter is ctpi


def test_fixture_is_needed():
    """Outside the block the reference prices its jobs on its TPU profile,
    and the bytes differ."""
    ref, port = both("smoke", "dally", n_jobs=10)
    assert ref != port


# -- the registry ------------------------------------------------------------------

def test_registry_order_is_the_references():
    """The trace makers draw rng.choice over ARCHS.values(): the order is
    part of every trace."""
    assert list(P_ARCHS) == list(R_ARCHS)


def plain(value):
    """A field's value with each dataclass in it (ContentionSchedule,
    FaultSpec: one class in each package) as its class name and fields."""
    if dataclasses.is_dataclass(value):
        return type(value).__name__, plain(dataclasses.asdict(value))
    if isinstance(value, dict):
        return {k: plain(v) for k, v in value.items()}
    return value


# The reference's deprecated fields, folded into ``faults`` at construction
# and unset after it; the port has no such fields.
DEPRECATED_FIELDS = ("failure_mode", "failure_kw")
# Scenarios whose description names a link's capacity against the NIC rate:
# the port restates it for the paper's network tier.
RESTATED = ("congested-spine", "oversubscribed-uplinks", "consolidate-vs-scatter",
            "moe-heavy", "pipeline-tolerant")


def test_scenario_registry_equals_the_references(paper):
    """The same names, each scenario equal field by field but for the
    profile's default, the reference's deprecated fields and the restated
    descriptions, and the same trace kinds."""
    assert sorted(px.SCENARIOS) == sorted(rx.SCENARIOS)
    assert sorted(px.scenario.TRACE_MAKERS) == sorted(r_scenario.TRACE_MAKERS)
    assert [f.name for f in dataclasses.fields(px.Scenario)] == [
        f.name for f in dataclasses.fields(rx.Scenario) if f.name not in DEPRECATED_FIELDS]
    for name, ref in rx.SCENARIOS.items():
        port = px.SCENARIOS[name]
        assert port.profile == "nvidia_paper"
        assert (ref.failure_mode, dict(ref.failure_kw)) == (None, {})
        for f in dataclasses.fields(px.Scenario):
            if f.name == "description" and name in RESTATED:
                assert port.description != ref.description
                assert "NIC rate" in port.description, name
                continue
            assert plain(getattr(port, f.name)) == plain(getattr(ref, f.name)), (name, f.name)
    assert px.Scenario.__dataclass_fields__["profile"].default == "nvidia_paper"
    assert rx.Scenario.__dataclass_fields__["profile"].default == "tpu_v5e"


# (link, its capacity over the NIC rate on the paper's cluster) of each
# restated scenario.
RESTATED_LINKS = {"congested-spine": ("spine", 0.5), "oversubscribed-uplinks": ("uplink", 0.25),
                  "consolidate-vs-scatter": ("spine", 0.25), "moe-heavy": ("spine", 0.25),
                  "pipeline-tolerant": ("spine", 0.5)}


@pytest.mark.parametrize("name", RESTATED)
def test_restated_description_names_the_regime_on_the_paper_cluster(paper, name):
    """The restated description names the capacity the scenario's fabric
    has against the paper's NIC rate; on the reference's TPU NIC the same
    link carries one or two full-rate jobs."""
    link, ratio = RESTATED_LINKS[name]
    port, ref = px.SCENARIOS[name], rx.SCENARIOS[name]
    nic = port._effective_nic_bw()
    uplink, spine = port._fabric_capacities(nic)
    assert (spine if link == "spine" else uplink) / nic == ratio
    assert {0.5: "half the NIC", 0.25: "a quarter of the NIC"}[ratio] in port.description
    tpu_nic = 25e9
    tpu_uplink, tpu_spine = ref._fabric_capacities(tpu_nic)
    assert (tpu_spine if link == "spine" else tpu_uplink) / tpu_nic in (1.0, 2.0)


SYNTHETIC = sorted(n for n, s in r_scenario.SCENARIOS.items() if s.trace not in CSV_KINDS)
CELLS = [(name, policy) for i, name in enumerate(SYNTHETIC)
         for policy in ("dally", OTHER_POLICIES[i % len(OTHER_POLICIES)])]


@pytest.mark.parametrize("name,policy", CELLS, ids=[f"{n}-{p}" for n, p in CELLS])
def test_registered_scenario_artifact_equals_the_references(paper, name, policy):
    ref, port = both(name, policy, **cut(rx.SCENARIOS[name]))
    same(port, ref)
    art = json.loads(port)
    assert art["metrics"]["n_finished"] > 0
    assert art["config"]["profile"] == "nvidia_paper"


def test_every_schema_is_reached(paper):
    """The cells above write every artifact schema, v1 to v7."""
    schemas = {json.loads(both(n, "dally", **cut(rx.SCENARIOS[n]))[1])["schema"]
               for n in ("smoke", "congested-spine", "mixed-parallelism", "failure-prone",
                         "degraded-cluster", "million-replay", "multi-tenant")}
    names = [f"ARTIFACT_SCHEMA{s}" for s in ("", "_V2", "_V3", "_V4", "_V5", "_V6", "_V7")]
    assert schemas == {getattr(px.runner, n) for n in names}
    assert [getattr(px.runner, n) for n in names] == [getattr(rx.runner, n) for n in names]


# -- CSV replays ----------------------------------------------------------------------

def write_helios_csv(path, n_jobs, seed):
    """A Philly/Helios-style CSV: string ids, datetime stamps out of file
    order, foreign and missing model names."""
    rng = random.Random(seed)
    rows = []
    for i in range(n_jobs):
        model = rng.choice(["yi-9b", "resnet50", "", "qwen3-1.7b", "vgg16"])
        rows.append([f"application_1506638472019_{10000 + i}", model,
                     rng.choice([1, 2, 4, 8, 16]),
                     f"2017-10-03 {rng.randrange(24):02d}:{rng.randrange(60):02d}:00",
                     rng.randrange(300, 30000)])
    with open(path, "w", newline="") as fh:
        w = csv.writer(fh)
        w.writerow(["job_id", "model", "num_gpus", "submit_time", "duration"])
        w.writerows(rows)
    return path


def write_pai_csv(path, n_jobs, seed):
    """An Alibaba PAI cluster-trace-gpu-v2020 task table: jobs of one to
    three tasks, some failed, CPU-only or at t = 0 (skipped)."""
    rng = random.Random(seed)
    rows = []
    for j in range(n_jobs):
        start = rng.randrange(1, 50_000)
        for t in range(rng.randint(1, 3)):
            s = start + rng.randrange(200)
            rows.append([f"job{j}", f"task{t}", rng.randint(1, 4),
                         rng.choice(["Terminated"] * 5 + ["Failed"]), s,
                         s + rng.randrange(100, 20_000), 600, 29,
                         rng.choice([0, 25, 50, 100, 200]), "V100"])
    rows.append(["late", "worker", 1, "Terminated", 0, 100, 600, 29, 100, "V100"])
    with open(path, "w", newline="") as fh:
        w = csv.writer(fh)
        w.writerow(["job_name", "task_name", "inst_num", "status", "start_time",
                    "end_time", "plan_cpu", "plan_mem", "plan_gpu", "gpu_type"])
        w.writerows(rows)
    return path


def csv_fixtures(tmp_path):
    """{scenario: csv path}: csv-replay replays a save_csv_trace file of the
    port's mixed trace, helios-replay a Helios-style file, pai-replay a PAI
    task table."""
    canonical = tmp_path / "canonical.csv"
    p_trace.save_csv_trace(p_trace.make_mixed_trace(list(P_ARCHS.values()), n_jobs=30,
                                                    seed=5), canonical)
    return {"csv-replay": canonical,
            "helios-replay": write_helios_csv(tmp_path / "helios.csv", 30, 1),
            "pai-replay": write_pai_csv(tmp_path / "pai.csv", 30, 2)}


@pytest.mark.parametrize("name", ["csv-replay", "helios-replay", "pai-replay"])
@pytest.mark.parametrize("policy", ["dally", "tiresias"])
def test_csv_replay_artifact_equals_the_references(paper, tmp_path, name, policy):
    path = str(csv_fixtures(tmp_path)[name])
    kw = {"n_racks": N_RACKS} if name != "csv-replay" else {}
    ref_sc = rx.get_scenario(name).with_overrides(csv_path=path)
    port_sc = px.get_scenario(name).with_overrides(csv_path=path)
    ref = rx.artifact_json(rx.run_one(ref_sc, policy, 0, overrides=rx.SimOverrides(**kw)))
    port = px.artifact_json(px.run_one(port_sc, policy, 0, overrides=px.SimOverrides(**kw)))
    same(port, ref)
    assert json.loads(port)["metrics"]["n_finished"] > 0


def test_scenario_from_csv_equals_the_references(paper, tmp_path):
    """scenario_from_csv builds a Scenario of the class's own default
    profile, so the reference's is named here."""
    path = str(csv_fixtures(tmp_path)["csv-replay"])
    ref = rx.scenario_from_csv(path, n_racks=3, profile="nvidia_paper")
    port = px.scenario_from_csv(path, n_racks=3)
    assert (port.name, port.trace, port.csv_path, port.description, port.profile) == (
        ref.name, ref.trace, ref.csv_path, ref.description, ref.profile)
    same(px.artifact_json(px.run_one(port, "dally", 1)),
         rx.artifact_json(rx.run_one(ref, "dally", 1)))


def test_csv_scenario_without_a_path_raises_as_the_reference(paper):
    for mod in (rx, px):
        with pytest.raises(ValueError, match="csv_path"):
            mod.run_one("csv-replay", "dally", 0)


# -- the reference's deprecated spellings, left out of the port --------------------

@pytest.mark.parametrize("call,error,match", [
    (lambda: px.run_one("smoke", "dally", 0, n_jobs=12), TypeError, "n_jobs"),
    (lambda: px.SimOverrides(failures="mtbf"), TypeError, "failures"),
    (lambda: px.SimOverrides(naive_topology=True), TypeError, "naive_topology"),
    (lambda: px.SimOverrides.from_dict({"naive_topology": True}), ValueError,
     "unknown SimOverrides field"),
    (lambda: px.Scenario("t", failure_mode="mtbf"), TypeError, "failure_mode"),
    (lambda: px.get_scenario("failure-prone").with_overrides(
        failure_kw={"mtbf": 6 * 3600.0}), TypeError, "failure_kw"),
    (lambda: px.get_scenario("smoke").build_cluster(naive_topology=True), TypeError,
     "naive_topology"),
], ids=["run-one-kwarg", "failures", "naive-topology", "naive-topology-wire",
        "scenario-failure-mode", "with-overrides-failure-kw", "build-cluster"])
def test_deprecated_spellings_are_refused(call, error, match):
    """The reference accepts each of these, with a DeprecationWarning where
    it is a shim; the port has no such spelling."""
    with pytest.raises(error, match=match):
        call()


def test_sweep_has_no_naive_topology_flag(tmp_path, capsys):
    import repro_torch.experiments.sweep as p_sweep
    with pytest.raises(SystemExit) as info:
        p_sweep.main(["--naive-topology", "--out", str(tmp_path)])
    assert info.value.code == 2 and "--naive-topology" in capsys.readouterr().err
    assert not any(tmp_path.iterdir())


def test_modern_spellings_equal_the_references_shims(paper):
    """What the reference's legacy kwargs fold into, the port takes in its
    modern spelling: the same bytes."""
    with pytest.warns(DeprecationWarning, match="legacy"):
        ref = rx.run_one("smoke", policy="dally", seed=0, n_jobs=12, failures="mtbf")
    port = px.run_one("smoke", policy="dally", seed=0, overrides=px.SimOverrides(
        n_jobs=12, faults=px.FaultSpec(mode="mtbf")))
    same(px.artifact_json(port), rx.artifact_json(ref))


# -- SimOverrides and FaultSpec wire forms -------------------------------------

OVERRIDES = [
    {},
    {"n_jobs": 40, "contention": "fair-share", "faults": {"mode": "mtbf"}},
    {"n_racks": 3, "max_time": 5000.0, "parallelism": "auto"},
    {"stream": True, "spill_dir": "/x/y", "faults": {
        "mode": "maintenance", "knobs": {"window": 600.0}, "degradation": "mixed",
        "telemetry": True}},
]


@pytest.mark.parametrize("wire", OVERRIDES, ids=range(len(OVERRIDES)))
def test_simoverrides_round_trip_equals_the_references(wire):
    port, ref = px.SimOverrides.from_dict(wire), rx.SimOverrides.from_dict(wire)
    assert port.to_dict() == ref.to_dict() == wire
    assert px.SimOverrides.from_dict(port.to_dict()) == port
    assert json.dumps(port.to_dict(), sort_keys=True) == json.dumps(ref.to_dict(),
                                                                     sort_keys=True)
    assert px.SimOverrides.from_dict(None) == px.SimOverrides()


FAULTS = [
    {},
    {"mode": "mtbf", "knobs": {"mtbf": 3600.0}, "degradation": "stragglers",
     "degradation_kw": {"scope": 0.5}, "telemetry": True},
    {"degradation": "flapping-uplinks"},
    {"mode": "maintenance"},
]


@pytest.mark.parametrize("wire", FAULTS, ids=range(len(FAULTS)))
def test_faultspec_round_trip_equals_the_references(wire):
    port, ref = px.FaultSpec.from_dict(wire), rx.FaultSpec.from_dict(wire)
    assert port.to_dict() == ref.to_dict() == wire
    assert px.FaultSpec.from_dict(port.to_dict()) == port
    assert port.enabled == ref.enabled


@pytest.mark.parametrize("build,error", [
    (lambda m: m.FaultSpec(mode="bogus"), ValueError),
    (lambda m: m.FaultSpec(degradation="bogus"), ValueError),
    (lambda m: m.FaultSpec(degradation="stragglers", degradation_kw={"mtdb": 1.0}),
     ValueError),
    (lambda m: m.FaultSpec(knobs={"mtbf": 1.0}), ValueError),
    (lambda m: m.FaultSpec(degradation_kw={"scope": 0.5}), ValueError),
    (lambda m: m.FaultSpec.from_dict({"mode": "mtbf", "nope": 1}), ValueError),
    (lambda m: m.SimOverrides(archs=[1]).to_dict(), ValueError),
    (lambda m: m.SimOverrides.from_dict({"comm": "anything"}), ValueError),
    (lambda m: m.SimOverrides.from_dict({"n_job": 10}), ValueError),
    (lambda m: setattr(m.SimOverrides(), "n_jobs", 5), dataclasses.FrozenInstanceError),
    (lambda m: setattr(m.FaultSpec(), "mode", "mtbf"), dataclasses.FrozenInstanceError),
    (lambda m: m.run_one("smoke", overrides={"n_jobs": 10}), TypeError),
], ids=["mode", "degradation", "degradation-kw", "knobs-alone", "degradation-kw-alone",
        "unknown-key", "runtime-only-out", "runtime-only-in", "unknown-field",
        "frozen-overrides", "frozen-faults", "not-overrides"])
def test_wire_form_errors_are_the_references(build, error):
    msgs = []
    for mod in (rx, px):
        with pytest.raises(error) as info:
            build(mod)
        msgs.append(str(info.value))
    assert msgs[0] == msgs[1]


def test_faultspec_merge_equals_the_references():
    for mod in (rx, px):
        base = mod.FaultSpec(mode="mtbf", knobs={"mtbf": 3600.0},
                             degradation="stragglers", telemetry=True)
        ov = mod.FaultSpec(mode="maintenance").merged_over(base)
        assert ov.mode == "maintenance" and not ov.knobs
        assert ov.degradation == "stragglers" and ov.telemetry
        assert dict(mod.FaultSpec(mode="mtbf").merged_over(base).knobs) == {"mtbf": 3600.0}
        assert mod.FaultSpec().merged_over(base) == base
        assert mod.FaultSpec().merged_over(None) == mod.FaultSpec()


def test_run_one_timed_keeps_wall_s_out_of_the_bytes(paper):
    art = px.run_one_timed("smoke", policy="dally", seed=0,
                           overrides=px.SimOverrides(n_jobs=12))
    assert "wall_s" in art and art["config"]["n_jobs"] == 12
    ref = rx.artifact_json(rx.run_one("smoke", "dally", 0, overrides=rx.SimOverrides(n_jobs=12)))
    same(px.artifact_json(art), ref)


# -- the linear-scan topology against the indexed one -------------------------------------------------------

def allocation_sequence(topo, seed, steps=300):
    """A seeded walk of allocations at every level, releases, failures of
    whole free machines and repairs on a topology; returns every decision
    and every query it made."""
    rng = random.Random(seed)
    held, out = [], []
    for _ in range(steps):
        op = rng.random()
        out.append((topo.free_gpus(), topo.max_free_on_machine(), topo.max_free_on_rack(),
                    topo.n_whole_free_machines(), tuple(topo.failed_machines())))
        if op < 0.55:
            g = rng.choice([1, 2, 3, 4, 8, 16, 24, 32, 70])
            level = rng.choice(["machine", "rack", "network", "scatter"])
            out.append((g, topo.best_feasible_level(g)))
            placement = topo.allocate(g, level)
            out.append(("alloc", g, level, placement and placement.alloc))
            if placement is not None:
                held.append(placement)
        elif op < 0.85 and held:
            placement = held.pop(rng.randrange(len(held)))
            topo.release(placement)
            out.append(("release", placement.alloc))
        elif op < 0.93:
            m = rng.randrange(topo.n_machines)
            if not topo.is_failed(m) and topo.free[m] == topo.machine_capacity(m):
                topo.fail_machine(m)
                out.append(("fail", m))
        elif topo.failed_machines():
            m = rng.choice(topo.failed_machines())
            topo.recover_machine(m)
            out.append(("recover", m))
    return out


SHAPES = (dict(n_racks=2), dict(n_racks=4, machines_per_rack=4, gpus_per_machine=4),
          dict(rack_sizes=(8, 4, 2, 1), gpus_per_machine=8))


@pytest.mark.parametrize("shape", SHAPES, ids=range(len(SHAPES)))
@pytest.mark.parametrize("seed", [0, 1])
def test_naive_topology_places_as_the_indexed_one_and_the_references(shape, seed):
    """The port's linear-scan topology, its indexed one and the reference's
    linear-scan one make the same placements and answer the same queries
    on one seeded walk."""
    naive = allocation_sequence(NaiveClusterTopology(**shape), seed)
    assert any(step[0] == "fail" for step in naive if isinstance(step[0], str))
    assert allocation_sequence(ClusterTopology(**shape), seed) == naive
    assert allocation_sequence(rc.NaiveClusterTopology(**shape), seed) == naive


@pytest.mark.parametrize("name", ["paper-batch", "congested-spine", "failure-prone",
                                  "hetero-racks"])
def test_naive_topology_artifact_is_byte_identical(paper, monkeypatch, name):
    """The port's scenario built on NaiveClusterTopology writes the bytes of
    its indexed run and of the reference's naive_topology run."""
    kw = cut(rx.SCENARIOS[name])
    fast = px.artifact_json(px.run_one(name, "dally", 0, overrides=px.SimOverrides(**kw)))
    ref = rx.artifact_json(rx.run_one(name, "dally", 0, overrides=rx.SimOverrides(
        naive_topology=True, **kw)))
    monkeypatch.setattr(px.scenario, "ClusterTopology", NaiveClusterTopology)
    assert type(px.get_scenario(name).build_cluster()) is NaiveClusterTopology
    naive = px.artifact_json(px.run_one(name, "dally", 0, overrides=px.SimOverrides(**kw)))
    same(naive, fast)
    same(naive, ref)


def test_naive_topology_is_the_references_class():
    assert [n for n in vars(NaiveClusterTopology) if not n.startswith("__")] == \
        [n for n in vars(rc.NaiveClusterTopology) if not n.startswith("__")]


# -- the sweep ---------------------------------------------------------------------

def run_sweep(out, *argv):
    env = {**os.environ, "PYTHONPATH": str(ROOT / "src")}
    proc = subprocess.run([sys.executable, "-m", "repro_torch.experiments.sweep", *argv,
                           "--out", str(out)], capture_output=True, text=True, env=env,
                          timeout=300, cwd=out.parent)
    assert proc.returncode == 0, proc.stderr
    return proc.stdout


def test_sweep_serial_equals_two_workers_and_run_one(paper, tmp_path):
    argv = ("--scenarios", "smoke,congested-spine", "--policies", "dally,gandiva",
            "--seeds", "2", "--n-jobs", "20", "--racks", "2")
    run_sweep(tmp_path / "serial", *argv, "--workers", "1")
    out = run_sweep(tmp_path / "pool", *argv, "--workers", "2")
    cells = sorted(p.name for p in (tmp_path / "serial").glob("*__seed*.json"))
    assert len(cells) == 8
    assert cells == sorted(p.name for p in (tmp_path / "pool").glob("*__seed*.json"))
    for cell in cells:
        serial = (tmp_path / "serial" / cell).read_text()
        same((tmp_path / "pool" / cell).read_text(), serial)
        scenario, policy, seed = cell[:-5].split("__")
        ref = rx.run_one(scenario, policy, int(seed[4:]),
                         overrides=rx.SimOverrides(n_jobs=20, n_racks=2))
        same(serial, rx.artifact_json(ref))
    index = json.loads((tmp_path / "pool" / "sweep.json").read_text())
    assert index["workers"] == 2 and len(index["runs"]) == 8
    assert index["overrides"] == {"n_jobs": 20, "n_racks": 2}
    assert "workers=2 cells=8" in out.splitlines()[-1]


def test_sweep_writes_apart_from_the_references_artifacts():
    """Both sweeps write files of the same names, priced on different
    profiles: the port's default directory is its own."""
    import repro.experiments.sweep as r_sweep
    import repro_torch.experiments.sweep as p_sweep
    assert str(p_sweep.DEFAULT_OUT) == "runs/sweep"
    assert p_sweep.DEFAULT_OUT != r_sweep.DEFAULT_OUT
    assert p_sweep._cell_name("smoke", "dally", 0) == r_sweep._cell_name("smoke", "dally", 0)


def test_sweep_list_names_every_scenario(tmp_path):
    out = run_sweep(tmp_path / "list", "--list")
    assert [line.split()[0] for line in out.splitlines()] == sorted(px.SCENARIOS)


def test_sweep_streams_and_spills(paper, tmp_path):
    run_sweep(tmp_path / "s", "--scenarios", "smoke", "--policies", "dally",
              "--n-jobs", "25", "--stream", "--spill")
    art = json.loads((tmp_path / "s" / "smoke__dally__seed0.json").read_text())
    manifest = art["metrics"]["spill"]
    assert manifest["dir"] == str(tmp_path / "s" / "spill" / "smoke__dally__seed0")
    assert verify_manifest(manifest) is None
    ref = rx.run_one("smoke", "dally", 0, overrides=rx.SimOverrides(
        n_jobs=25, stream=True, spill_dir=str(tmp_path / "ref")))
    ref["metrics"]["spill"]["dir"] = manifest["dir"]
    same(json.dumps(art, indent=1, sort_keys=True), rx.artifact_json(ref))


# -- the public api ------------------------------------------------------------------

def test_api_all_equals_the_references():
    assert repro_torch.api.__all__ == repro.api.__all__
    for name in repro_torch.api.__all__:
        assert getattr(repro_torch.api, name) is not None, name


def test_api_names_are_the_ports_internals():
    from repro_torch.experiments.runner import run_one
    from repro_torch.service import SchedulerService
    assert repro_torch.api.run_one is run_one
    assert repro_torch.api.SchedulerService is SchedulerService
    for name in repro_torch.api.__all__:
        obj = getattr(repro_torch.api, name)
        module = getattr(obj, "__module__", None)
        assert module is None or not module.startswith("repro."), (name, module)


def test_api_run_one_equals_the_references(paper):
    ov = dict(n_jobs=15, contention="fair-share")
    got = repro_torch.api.run_one("smoke", "dally", 2,
                                  overrides=repro_torch.api.SimOverrides(**ov))
    want = repro.api.run_one("smoke", "dally", 2, overrides=repro.api.SimOverrides(**ov))
    same(repro_torch.api.artifact_json(got), repro.api.artifact_json(want))


"""The port's streaming trace sources, completion spill and the simulator's
source and spill branches (``repro_torch.core.trace_source``,
``repro_torch.core.spill``) against the JAX package's: each streaming
source's jobs field by field, a streamed run's event sequence against the
materialized one's, the CSV adapters, the spill's shards and manifest byte
for byte, and a snapshot taken with a source attached.

The reference runs on the paper's cluster (``reference_on_the_paper_cluster``
in ``test_torch_experiments.py``); where a reference maker is called
directly here it is given ``profile=NVIDIA_PAPER``, the port's default.
"""
from __future__ import annotations

import dataclasses
import json
import pickle

import pytest

import repro.core as rc
import repro.core.spill as r_spill
import repro.core.trace_source as r_ts
import repro.experiments as rx
import repro_torch.core as pc
import repro_torch.core.spill as p_spill
import repro_torch.core.trace_source as p_ts
import repro_torch.experiments as px
from repro.configs import ARCHS as R_ARCHS
from repro.types import NVIDIA_PAPER as R_PAPER
from repro_torch.configs import ARCHS as P_ARCHS
from test_torch_experiments import (reference_on_the_paper_cluster, same, write_helios_csv,
                                    write_pai_csv)

R_LIST, P_LIST = list(R_ARCHS.values()), list(P_ARCHS.values())
P_MAKERS = {"batch": pc.make_batch_trace, "poisson": pc.make_poisson_trace,
            "philly": pc.make_philly_trace, "mixed": pc.make_mixed_trace}


@pytest.fixture(scope="module")
def paper():
    with reference_on_the_paper_cluster():
        yield


def plain(value):
    """A plan (one ParallelPlan class in each package) as its fields."""
    return dataclasses.asdict(value) if dataclasses.is_dataclass(value) else value


def job_fields(j):
    """A Job's static identity (Job is eq=False)."""
    return (j.job_id, j.model, j.n_gpus, j.total_iters, j.compute_time_per_iter,
            j.arrival, j.skew, plain(j.plan), j.tenant, j.priority)


def assert_jobs_equal(got, want):
    assert len(got) == len(want)
    for a, b in zip(got, want):
        assert job_fields(a) == job_fields(b)


# -- the streaming makers ----------------------------------------------------------

def test_streaming_makers_are_the_references():
    assert sorted(p_ts.STREAMING_MAKERS) == sorted(r_ts.STREAMING_MAKERS)
    assert [c.__name__ for c in p_ts.STREAMING_MAKERS.values()] == \
        [c.__name__ for c in r_ts.STREAMING_MAKERS.values()]


@pytest.mark.parametrize("kind", sorted(r_ts.STREAMING_MAKERS))
@pytest.mark.parametrize("kw", [dict(n_jobs=60, seed=3),
                                dict(n_jobs=50, seed=7, parallelism="auto", gpus_per_machine=8)],
                         ids=["plain", "plans"])
def test_streaming_source_equals_the_references(kind, kw):
    src = p_ts.STREAMING_MAKERS[kind](P_LIST, **kw)
    ref = r_ts.STREAMING_MAKERS[kind](R_LIST, profile=R_PAPER, **kw)
    assert len(src) == len(ref) == kw["n_jobs"]
    assert src.plans == ref.plans
    assert src.provenance() == ref.provenance()
    got = list(src)
    assert_jobs_equal(got, list(ref))
    # the twin of the port's own materialized maker
    assert_jobs_equal(got, P_MAKERS[kind](P_LIST, **kw))
    assert src.peek_arrival() is None and src.next_job() is None


@pytest.mark.parametrize("kind", sorted(r_ts.STREAMING_MAKERS))
def test_mid_stream_pickle_resumes(kind):
    want = P_MAKERS[kind](P_LIST, n_jobs=50, seed=11)
    src = p_ts.STREAMING_MAKERS[kind](P_LIST, n_jobs=50, seed=11)
    head = [src.next_job() for _ in range(20)]
    resumed = pickle.loads(pickle.dumps(src))
    assert_jobs_equal(head + list(resumed), want)
    assert_jobs_equal(head + list(src), want)


def test_peek_is_a_lookahead():
    src = p_ts.STREAMING_MAKERS["poisson"](P_LIST, n_jobs=5, seed=1)
    first = src.peek_arrival()
    assert first == src.peek_arrival()
    assert src.next_job().arrival == first
    assert src.peek_arrival() == src.next_job().arrival


def test_materialized_trace_and_as_source():
    jobs = pc.make_poisson_trace(P_LIST, n_jobs=10, seed=0)
    src = p_ts.as_source(jobs)
    assert isinstance(src, p_ts.MaterializedTrace)
    assert p_ts.as_source(src) is src
    assert src.provenance() == r_ts.as_source(
        rc.make_poisson_trace(R_LIST, n_jobs=10, seed=0)).provenance()
    assert_jobs_equal(list(src), jobs)


# -- the CSV adapters and the CSV round trip -----------------------------------

def helios_fixtures(tmp_path):
    canonical = tmp_path / "canonical.csv"
    pc.save_csv_trace(pc.make_poisson_trace(P_LIST, n_jobs=30, seed=5), canonical)
    planned = tmp_path / "planned.csv"
    pc.save_csv_trace(pc.make_batch_trace(P_LIST, n_jobs=40, seed=6, parallelism="auto"),
                      planned)
    dup = tmp_path / "dup.csv"
    dup.write_text("job_id,model,n_gpus,total_iters,compute_time_per_iter,arrival\n"
                   "7,yi-9b,2,100,1.0,300.0\n7,yi-9b,1,100,1.0,100.0\n3,yi-9b,4,100,1.0,200.0\n")
    return [canonical, planned, dup, write_helios_csv(tmp_path / "helios.csv", 40, 3)]


def test_helios_adapter_equals_the_references(tmp_path):
    for path in helios_fixtures(tmp_path):
        src = p_ts.HeliosCsvTrace(path, P_LIST)
        ref = r_ts.HeliosCsvTrace(path, R_LIST, profile=R_PAPER)
        assert len(src) == len(ref)
        assert src.provenance() == ref.provenance()
        got = list(src)
        assert_jobs_equal(got, list(ref))
        assert_jobs_equal(got, pc.load_csv_trace(path, P_LIST))


def test_helios_adapter_resumes_mid_stream(tmp_path):
    path = helios_fixtures(tmp_path)[3]
    want = pc.load_csv_trace(path, P_LIST)
    src = p_ts.HeliosCsvTrace(path, P_LIST)
    head = [src.next_job()]
    assert_jobs_equal(head + list(pickle.loads(pickle.dumps(src))), want)


def test_pai_adapter_equals_the_references(tmp_path):
    path = write_pai_csv(tmp_path / "pai.csv", 60, 4)
    src = p_ts.AlibabaPaiTrace(path, P_LIST)
    ref = r_ts.AlibabaPaiTrace(path, R_LIST, profile=R_PAPER)
    prov = src.provenance()
    assert prov == ref.provenance()
    assert prov["n_skipped"] > 0 and prov["n_cpu_only"] > 0
    got = list(src)
    assert got and [j.job_id for j in got] == list(range(len(got)))
    assert_jobs_equal(got, list(ref))


def test_pai_adapter_refuses_no_archs_as_the_reference(tmp_path):
    path = tmp_path / "pai.csv"
    path.write_text("job_name,status\n")
    msgs = []
    for cls in (p_ts.AlibabaPaiTrace, r_ts.AlibabaPaiTrace):
        with pytest.raises(ValueError) as info:
            cls(path, [])
        msgs.append(str(info.value))
    assert msgs[0] == msgs[1]


def test_csv_round_trip_writes_the_references_bytes(tmp_path):
    for kw in (dict(n_jobs=40, seed=2), dict(n_jobs=60, seed=4, parallelism="auto")):
        pc.save_csv_trace(pc.make_batch_trace(P_LIST, **kw), tmp_path / "port.csv")
        rc.save_csv_trace(rc.make_batch_trace(R_LIST, profile=R_PAPER, **kw),
                          tmp_path / "ref.csv")
        assert (tmp_path / "port.csv").read_bytes() == (tmp_path / "ref.csv").read_bytes()
        assert_jobs_equal(pc.load_csv_trace(tmp_path / "port.csv", P_LIST),
                          pc.make_batch_trace(P_LIST, **kw))


# -- streamed against materialized runs ------------------------------------------

def events(scenario, seed=0, **kw):
    """(every processed event as (clock, kind), results()) of a cell of the
    port's, built as run_one builds it."""
    sc = px.get_scenario(scenario).with_overrides(**kw)
    sim = sc.build_sim(P_LIST, seed=seed)
    seen = []
    sim.event_hook = lambda s, kind: seen.append((s.clock, kind))
    return seen, sim.run()


STREAM_CELLS = [("smoke", 20), ("congested-spine", 24), ("failure-prone", 24),
                ("moe-heavy", 16), ("bursty-diurnal", 16)]


@pytest.mark.parametrize("scenario,n_jobs", STREAM_CELLS, ids=[c[0] for c in STREAM_CELLS])
def test_streamed_run_processes_the_materialized_events(paper, scenario, n_jobs):
    kw = dict(n_jobs=n_jobs, n_racks=2)
    mat, mat_res = events(scenario, **kw)
    srt, srt_res = events(scenario, stream=True, **kw)
    assert srt == mat and len(mat) > n_jobs
    assert json.dumps(srt_res, sort_keys=True) == json.dumps(mat_res, sort_keys=True)
    ref = rx.run_one(scenario, None, 0, overrides=rx.SimOverrides(stream=True, **kw))
    port = px.run_one(scenario, None, 0, overrides=px.SimOverrides(stream=True, **kw))
    assert port["schema"] == px.runner.ARTIFACT_SCHEMA_V6
    same(px.artifact_json(port), rx.artifact_json(ref))


def test_streamed_service_mode_pulls_arrivals_as_run_does(paper):
    sc = px.get_scenario("paper-poisson").with_overrides(n_jobs=30, n_racks=2, stream=True)
    want = sc.build_sim(P_LIST, seed=1).run()
    sim = sc.build_sim(P_LIST, seed=1)
    sim.begin()
    while not sim.idle:
        sim.step_events(7)
    assert sim.results() == want


def test_snapshot_with_a_source_attached_restores_the_run(paper):
    sc = px.get_scenario("smoke").with_overrides(n_jobs=40, stream=True)
    want = json.dumps(sc.build_sim(P_LIST, seed=0).run(), sort_keys=True)
    sim = sc.build_sim(P_LIST, seed=0)
    sim.begin()
    sim.step_events(37)
    assert sim.source.peek_arrival() is not None
    resumed = pc.ClusterSimulator.restore(sim.snapshot_bytes())
    assert json.dumps(resumed.run(), sort_keys=True) == want
    assert json.dumps(sim.run(), sort_keys=True) == want
    ref = rx.get_scenario("smoke").with_overrides(n_jobs=40, stream=True).build_sim(
        R_LIST, seed=0).run()
    assert json.dumps(ref, sort_keys=True) == want


def test_snapshot_is_refused_while_spilling(tmp_path):
    sim = px.get_scenario("smoke").with_overrides(n_jobs=10, stream=True).build_sim(
        P_LIST, seed=0)
    sim.attach_spill(p_spill.SpillWriter(tmp_path))
    with pytest.raises(RuntimeError, match="spill"):
        sim.snapshot_bytes()


def test_spill_needs_a_streamed_cell_as_the_reference(tmp_path):
    msgs = []
    for mod in (rx, px):
        with pytest.raises(ValueError, match="streamed") as info:
            mod.run_one("smoke", seed=0, overrides=mod.SimOverrides(
                n_jobs=10, spill_dir=str(tmp_path)))
        msgs.append(str(info.value))
    assert msgs[0] == msgs[1]


# -- the spill -------------------------------------------------------------------------

def manifest_without_dir(manifest):
    return {k: v for k, v in manifest.items() if k != "dir"}


@pytest.mark.parametrize("scenario,n_jobs", [("smoke", 30), ("dc-256-philly", 200),
                                             ("failure-prone", 40)])
def test_spill_writes_the_references_shards_and_manifest(paper, tmp_path, scenario, n_jobs):
    arts = {}
    for side, mod in (("port", px), ("ref", rx)):
        arts[side] = mod.run_one(scenario, "dally", 0, overrides=mod.SimOverrides(
            n_jobs=n_jobs, n_racks=2, stream=True, spill_dir=str(tmp_path / side)))
    port, ref = arts["port"]["metrics"]["spill"], arts["ref"]["metrics"]["spill"]
    assert port["dir"] == str(tmp_path / "port")
    assert manifest_without_dir(port) == manifest_without_dir(ref)
    assert p_spill.verify_manifest(port) is None
    for entry in port["shards"]:
        assert (tmp_path / "port" / entry["file"]).read_bytes() == \
            (tmp_path / "ref" / entry["file"]).read_bytes()
    records = list(p_spill.read_spilled(tmp_path / "port"))
    assert len(records) == arts["port"]["metrics"]["n_finished"] == port["n_jobs"]
    assert [r["finish_time"] for r in records] == sorted(r["finish_time"] for r in records)
    arts["ref"]["metrics"]["spill"]["dir"] = port["dir"]
    same(px.artifact_json(arts["port"]), rx.artifact_json(arts["ref"]))
    plain = px.run_one(scenario, "dally", 0, overrides=px.SimOverrides(
        n_jobs=n_jobs, n_racks=2, stream=True))
    metrics = dict(arts["port"]["metrics"])
    metrics.pop("spill")
    assert json.dumps(metrics, sort_keys=True) == json.dumps(plain["metrics"], sort_keys=True)


def test_spill_writer_rotates_shards_and_finds_a_flipped_byte(tmp_path):
    jobs = pc.make_poisson_trace(P_LIST, n_jobs=25, seed=0)
    ref_jobs = rc.make_poisson_trace(R_LIST, n_jobs=25, seed=0, profile=R_PAPER)
    writers = {"port": p_spill.SpillWriter(tmp_path / "port", shard_jobs=10),
               "ref": r_spill.SpillWriter(tmp_path / "ref", shard_jobs=10)}
    for side, module, trace in (("port", p_spill, jobs), ("ref", r_spill, ref_jobs)):
        for j in trace:
            j.finish_time = j.arrival + 1.0
            writers[side].write(module.finished_record(j))
        writers[side].close()
    manifest = writers["port"].manifest()
    assert manifest["n_jobs"] == 25 and len(manifest["shards"]) == 3
    assert manifest_without_dir(manifest) == manifest_without_dir(writers["ref"].manifest())
    assert p_spill.verify_manifest(manifest) is None
    assert [r["job_id"] for r in p_spill.read_spilled(tmp_path / "port")] == \
        [j.job_id for j in jobs]
    shard = tmp_path / "port" / manifest["shards"][1]["file"]
    raw = bytearray(shard.read_bytes())
    raw[5] ^= 0xFF
    shard.write_bytes(bytes(raw))
    assert p_spill.verify_manifest(manifest) is not None


def test_finished_tally_equals_the_references():
    """FinishedTally folds completions as results() needs them: the port's
    and the reference's agree on the same jobs."""
    tallies = []
    for core, archs, kw in ((pc, P_LIST, {}), (rc, R_LIST, {"profile": R_PAPER})):
        tally = core.FinishedTally()
        for i, j in enumerate(core.make_mixed_trace(archs, n_jobs=40, seed=9, **kw)):
            j.finish_time = j.arrival + 100.0 * (i + 1)
            j.t_run, j.t_queue, j.comm_time = 50.0 * i, 10.0 * i, 0.5 * i
            tally.add(j)
        tallies.append({k: v for k, v in vars(tally).items()})
    assert json.dumps(tallies[0], sort_keys=True, default=repr) == \
        json.dumps(tallies[1], sort_keys=True, default=repr)

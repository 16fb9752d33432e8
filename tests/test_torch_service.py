"""The port's online service (``repro_torch.service``) against the JAX
package's: the same submissions give the same ``artifact.json`` (v1 and v2
job specs, admission and the tenant ledger included), recovery after an
abandoned daemon gives the uninterrupted run's bytes, and job-spec
validation raises the reference's errors.

Snapshots pickle each package's own classes, so the journals' snapshot
digests differ between the packages; their other records and the artifact
do not.  The reference runs on the paper's cluster
(``reference_on_the_paper_cluster`` in ``test_torch_experiments.py``).
"""
from __future__ import annotations

import json
import os
import signal
import subprocess
import sys
import time
from pathlib import Path

import pytest

import repro.service as rs
import repro.service.jobspec as r_jobspec
import repro_torch.experiments as px
import repro_torch.service as ps
import repro_torch.service.jobspec as p_jobspec
from repro.configs import ARCHS as R_ARCHS
from repro.experiments import FaultSpec as RFaultSpec, SimOverrides as RSimOverrides
from repro_torch.configs import ARCHS as P_ARCHS
from repro_torch.core import make_batch_trace
from repro_torch.core.trace import compute_time_per_iter
from test_torch_experiments import reference_on_the_paper_cluster

ROOT = Path(__file__).resolve().parent.parent
SIDES = {"port": (ps, px.SimOverrides, px.FaultSpec), "ref": (rs, RSimOverrides, RFaultSpec)}

SPECS = [
    {"name": f"job-{i:03d}", "model": m, "n_gpus": g, "gpu_hours": h, "arrival": i * 200.0}
    for i, (m, g, h) in enumerate([
        ("yi-9b", 8, 2.0), ("qwen3-1.7b", 1, 0.5), ("qwen2-moe-a2.7b", 4, 1.0),
        ("recurrentgemma-2b", 2, 0.8), ("minicpm3-4b", 16, 3.0), ("yi-9b", 4, 1.5),
        ("qwen3-1.7b", 2, 0.3), ("qwen3-moe-30b-a3b", 8, 2.5)])]

MT_SPECS = [
    {"name": f"mt-{i:03d}", "model": m, "n_gpus": g, "gpu_hours": h, "arrival": i * 200.0,
     "tenant": t, "priority": p}
    for i, (m, g, h, t, p) in enumerate([
        ("yi-9b", 8, 2.0, "prod", "high"), ("qwen3-1.7b", 1, 0.5, "burst", "low"),
        ("qwen2-moe-a2.7b", 4, 1.0, "burst", "normal"),
        ("recurrentgemma-2b", 2, 0.8, "research", "normal"),
        ("minicpm3-4b", 16, 3.0, "burst", "low"), ("yi-9b", 4, 1.5, "prod", "normal"),
        ("qwen3-1.7b", 2, 0.3, "burst", "high"),
        ("qwen3-moe-30b-a3b", 8, 2.5, "research", "low")])]


@pytest.fixture(scope="module")
def paper():
    with reference_on_the_paper_cluster():
        yield


def drain(svc):
    while not svc.sim.idle:
        svc.tick()


def run_service(side, state_dir, overrides=None, specs=SPECS, events_per_tick=7,
                snapshot_every=20, crash_after_ticks=None, admission=None):
    """A service of one package ("port" or "ref") over specs on "smoke":
    (artifact.json's bytes, names its admission refused), or None once it is
    abandoned after crash_after_ticks ticks (its file handle closed, nothing
    finalized)."""
    service, _, _ = SIDES[side]
    svc = service.SchedulerService(
        state_dir, scenario="smoke", seed=0, overrides=overrides,
        events_per_tick=events_per_tick, snapshot_every=snapshot_every,
        admission=admission and service.AdmissionPolicy(**admission))
    refused = []
    for spec in specs:
        try:
            svc.submit(spec)
        except service.AdmissionRejected:
            refused.append(spec["name"])
    ticks = 0
    while not svc.sim.idle:
        svc.tick()
        ticks += 1
        if crash_after_ticks and ticks >= crash_after_ticks:
            svc.close()
            return None
    svc.finalize()
    svc.close()
    return (Path(state_dir) / "artifact.json").read_bytes(), refused


def overrides_of(side, wire):
    return SIDES[side][1].from_dict(wire)


def records(journal, skip=("snapshot",)):
    return [r for r in ps.Journal.read(journal) if r["type"] not in skip]


# -- the same submissions, the same artifact -------------------------------------

OVERRIDES = [{}, {"contention": "fair-share"}, {"faults": {"mode": "mtbf"}, "n_racks": 2},
             {"faults": {"degradation": "stragglers"}, "parallelism": "auto"}]


@pytest.mark.parametrize("wire", OVERRIDES, ids=["plain", "contention", "failures",
                                                 "stragglers-auto"])
def test_service_artifact_equals_the_references(paper, tmp_path, wire):
    port = run_service("port", tmp_path / "port", overrides_of("port", wire))
    ref = run_service("ref", tmp_path / "ref", overrides_of("ref", wire))
    assert port == ref
    art = json.loads(port[0])
    assert art["schema"] == "repro.service.artifact/v1"
    assert art["metrics"]["n_finished"] == len(SPECS)
    assert art["config"]["profile"] == "nvidia_paper"
    # the journals agree record for record, but for the snapshots' digests
    assert records(tmp_path / "port" / "journal.jsonl") == \
        records(tmp_path / "ref" / "journal.jsonl")


def test_v2_specs_and_admission_equal_the_references(paper, tmp_path):
    admission = {"max_waiting_jobs_per_tenant": 3}
    out = {side: run_service(side, tmp_path / side, overrides_of(side, {
        "contention": "fair-share"}), specs=MT_SPECS, snapshot_every=10, admission=admission)
        for side in SIDES}
    assert out["port"] == out["ref"]
    art_bytes, refused = out["port"]
    assert refused == ["mt-006"]
    art = json.loads(art_bytes)
    assert art["admission"]["n_admitted"] == 7 and art["admission"]["n_rejected"] == 1
    assert sorted(art["tenants"]) == ["burst", "prod", "research"]
    assert records(tmp_path / "port" / "journal.jsonl") == \
        records(tmp_path / "ref" / "journal.jsonl")


def test_single_tenant_artifact_keeps_the_legacy_shape(paper, tmp_path):
    art = json.loads(run_service("port", tmp_path / "s", specs=SPECS[:2])[0])
    assert "tenants" not in art and "admission" not in art


def test_inbox_run_equals_the_references_in_process_run(paper, tmp_path):
    """The inbox path of the port's service against the reference's
    in-process submissions."""
    ov = {"contention": "fair-share"}
    ref, _ = run_service("ref", tmp_path / "ref", overrides_of("ref", ov))
    inbox = tmp_path / "inbox"
    inbox.mkdir()
    for s in SPECS:
        (inbox / f"{s['name']}.json").write_text(json.dumps(s))
    svc = ps.SchedulerService(tmp_path / "svc", scenario="smoke",
                              overrides=overrides_of("port", ov), inbox=inbox)
    svc.serve(exit_when_idle=True)
    svc.close()
    assert (tmp_path / "svc" / "artifact.json").read_bytes() == ref


def test_streamed_background_trace_equals_the_references(paper, tmp_path):
    """stream_trace: the scenario's own trace streams in as background load,
    the inbox's jobs take ids from INBOX_JOB_ID_BASE."""
    assert ps.daemon.INBOX_JOB_ID_BASE == rs.daemon.INBOX_JOB_ID_BASE
    out = {}
    for side, (service, overrides, _) in SIDES.items():
        svc = service.SchedulerService(tmp_path / side, scenario="smoke",
                                       overrides=overrides(n_jobs=12), stream_trace=True,
                                       events_per_tick=9)
        for spec in SPECS[:3]:
            svc.submit(spec)
        drain(svc)
        svc.finalize()
        svc.close()
        out[side] = (tmp_path / side / "artifact.json").read_bytes()
    assert out["port"] == out["ref"]
    art = json.loads(out["port"])
    assert art["stream_trace"] is True and art["metrics"]["n_finished"] == 15


# -- recovery ---------------------------------------------------------------------------

@pytest.mark.parametrize("wire,crash_after", [({"contention": "fair-share"}, 9),
                                              ({"faults": {"mode": "mtbf"}, "n_racks": 2}, 5)],
                         ids=["contention", "failures"])
def test_recovery_from_a_snapshot_gives_the_uninterrupted_bytes(paper, tmp_path, wire,
                                                                 crash_after):
    ov = overrides_of("port", wire)
    want, _ = run_service("port", tmp_path / "ref", ov)
    assert run_service("port", tmp_path / "crash", ov, crash_after_ticks=crash_after) is None
    assert [r for r in ps.Journal.read(tmp_path / "crash" / "journal.jsonl")
            if r["type"] == "snapshot"]
    svc = ps.SchedulerService(tmp_path / "crash", events_per_tick=13)
    drain(svc)
    svc.finalize()
    svc.close()
    assert (tmp_path / "crash" / "artifact.json").read_bytes() == want
    assert want == run_service("ref", tmp_path / "the-ref", overrides_of("ref", wire))[0]


def test_recovery_without_a_snapshot_replays_the_whole_journal(paper, tmp_path):
    ov = overrides_of("port", {"contention": "fair-share"})
    want, _ = run_service("port", tmp_path / "ref", ov)
    assert run_service("port", tmp_path / "crash", ov, snapshot_every=10**9,
                       crash_after_ticks=6) is None
    assert not [r for r in ps.Journal.read(tmp_path / "crash" / "journal.jsonl")
                if r["type"] == "snapshot"]
    svc = ps.SchedulerService(tmp_path / "crash")
    drain(svc)
    svc.finalize()
    svc.close()
    assert (tmp_path / "crash" / "artifact.json").read_bytes() == want


def test_recovery_survives_a_torn_journal_tail(paper, tmp_path):
    ov = overrides_of("port", {"contention": "fair-share"})
    want, _ = run_service("port", tmp_path / "ref", ov)
    assert run_service("port", tmp_path / "crash", ov, crash_after_ticks=8) is None
    with open(tmp_path / "crash" / "journal.jsonl", "a") as fh:
        fh.write('{"type": "event", "op": "plac')
    svc = ps.SchedulerService(tmp_path / "crash")
    drain(svc)
    svc.finalize()
    svc.close()
    assert (tmp_path / "crash" / "artifact.json").read_bytes() == want


def test_recovery_passes_over_a_corrupt_snapshot(paper, tmp_path):
    ov = overrides_of("port", {"contention": "fair-share"})
    want, _ = run_service("port", tmp_path / "ref", ov)
    assert run_service("port", tmp_path / "crash", ov, snapshot_every=10,
                       crash_after_ticks=8) is None
    snaps = [r for r in ps.Journal.read(tmp_path / "crash" / "journal.jsonl")
             if r["type"] == "snapshot"]
    assert len(snaps) >= 2
    (tmp_path / "crash" / snaps[-1]["file"]).write_bytes(b"garbage")
    svc = ps.SchedulerService(tmp_path / "crash")
    drain(svc)
    svc.finalize()
    svc.close()
    assert (tmp_path / "crash" / "artifact.json").read_bytes() == want


def test_multitenant_recovery_gives_the_uninterrupted_bytes(paper, tmp_path):
    admission = {"max_waiting_jobs_per_tenant": 3}
    ov = overrides_of("port", {"contention": "fair-share"})
    want, _ = run_service("port", tmp_path / "ref", ov, specs=MT_SPECS, snapshot_every=10,
                          admission=admission)
    assert run_service("port", tmp_path / "crash", ov, specs=MT_SPECS, snapshot_every=10,
                       crash_after_ticks=5, admission=admission) is None
    svc = ps.SchedulerService(tmp_path / "crash", events_per_tick=13)
    drain(svc)
    svc.finalize()
    svc.close()
    assert (tmp_path / "crash" / "artifact.json").read_bytes() == want


def daemon(state, inbox, *extra):
    return [sys.executable, "-m", "repro_torch.service", "--state-dir", str(state),
            "--inbox", str(inbox), "--scenario", "smoke", "--events-per-tick", "5",
            "--snapshot-every", "25", "--overrides", '{"contention": "fair-share"}', *extra]


@pytest.mark.skipif(sys.platform == "win32", reason="POSIX signals")
def test_sigkilled_daemon_recovers_to_the_references_bytes(paper, tmp_path):
    """The CLI killed with SIGKILL once its journal shows a snapshot and
    every submit, restarted with --exit-when-idle: its artifact.json is the
    uninterrupted run's, and the reference's for the same inbox."""
    env = {**os.environ, "PYTHONPATH": str(ROOT / "src")}
    specs = [dict(s, arrival=i * 400.0) for i, s in enumerate(SPECS)]
    for d in ("ref-inbox", "inbox"):
        (tmp_path / d).mkdir()
        for s in specs:
            (tmp_path / d / f"{s['name']}.json").write_text(json.dumps(s))
    subprocess.run(daemon(tmp_path / "ref", tmp_path / "ref-inbox", "--exit-when-idle"),
                   check=True, env=env, timeout=300, capture_output=True)
    want = (tmp_path / "ref" / "artifact.json").read_bytes()
    proc = subprocess.Popen(daemon(tmp_path / "state", tmp_path / "inbox", "--throttle", "0.05"),
                            env=env, stdout=subprocess.DEVNULL)
    journal = tmp_path / "state" / "journal.jsonl"
    try:
        deadline = time.time() + 120
        while time.time() < deadline:
            txt = journal.read_text() if journal.exists() else ""
            if txt.count('"type": "snapshot"') >= 1 and \
                    txt.count('"type": "submit"') == len(specs):
                break
            assert proc.poll() is None, "the daemon exited before it was killed"
            time.sleep(0.1)
        else:
            pytest.fail("the daemon wrote no snapshot in time")
        proc.send_signal(signal.SIGKILL)
    finally:
        if proc.poll() is None:
            proc.kill()
        proc.wait()
    subprocess.run(daemon(tmp_path / "state", tmp_path / "inbox", "--exit-when-idle"),
                   check=True, env=env, timeout=300, capture_output=True)
    assert (tmp_path / "state" / "artifact.json").read_bytes() == want
    ref_inbox = tmp_path / "in-process-inbox"
    ref_inbox.mkdir()
    for s in specs:
        (ref_inbox / f"{s['name']}.json").write_text(json.dumps(s))
    svc = rs.SchedulerService(tmp_path / "in-process", scenario="smoke", inbox=ref_inbox,
                              overrides=RSimOverrides(contention="fair-share"))
    svc.serve(exit_when_idle=True)
    svc.close()
    assert (tmp_path / "in-process" / "artifact.json").read_bytes() == want


# -- submissions, the inbox and the live state -----------------------------------

def test_duplicate_and_conflicting_specs_as_the_reference(tmp_path):
    for side, (service, _, _) in SIDES.items():
        svc = service.SchedulerService(tmp_path / side, scenario="smoke")
        jid = svc.submit(SPECS[0])
        assert svc.submit(SPECS[0]) == jid
        with pytest.raises(service.DuplicateJobSpec):
            svc.submit({**SPECS[0], "n_gpus": 4})
        svc.close()
    assert issubclass(ps.DuplicateJobSpec, ps.JobSpecError)


def test_inbox_quarantines_bad_specs_as_the_reference(paper, tmp_path):
    bad = {"broken": "{not json",
           "badmodel": json.dumps({"name": "bad", "model": "nope", "n_gpus": 1,
                                   "gpu_hours": 1.0}),
           "bad-arrival": json.dumps({"name": "bad-arrival", "model": "yi-9b", "n_gpus": 1,
                                      "gpu_hours": 1.0, "arrival": "soon"}),
           "bad-tokens": json.dumps({"name": "bad-tokens", "model": "yi-9b", "n_gpus": 1,
                                     "gpu_hours": 1.0, "tokens_per_gpu_iter": 0})}
    notes = {}
    for side, (service, _, _) in SIDES.items():
        inbox = tmp_path / side / "inbox"
        inbox.mkdir(parents=True)
        for s in SPECS[:4]:
            (inbox / f"{s['name']}.json").write_text(json.dumps(s))
        for name, text in bad.items():
            (inbox / f"{name}.json").write_text(text)
        svc = service.SchedulerService(tmp_path / side / "s", scenario="smoke", inbox=inbox)
        assert svc.poll_inbox() == 4
        assert not list(inbox.glob("*.json"))
        assert len(list((inbox / "processed").glob("*.json"))) == 4
        notes[side] = {p.name: p.read_text() for p in (inbox / "rejected").glob("*.error")}
        svc.close()
    assert sorted(notes["port"]) == [f"{n}.json.error" for n in sorted(bad)]
    assert notes["port"] == notes["ref"]


def test_cluster_state_is_the_references_and_reads_only(paper, tmp_path):
    states = {}
    for side, (service, overrides, _) in SIDES.items():
        svc = service.SchedulerService(tmp_path / side, scenario="smoke",
                                       overrides=overrides(contention="fair-share"))
        for s in SPECS:
            svc.submit({**s, "arrival": 0.0, "name": "now-" + s["name"]})
        svc.sim.begin()
        svc.sim.step_events(12)
        if side == "port":
            before = svc.sim.snapshot_bytes()
        states[side] = svc.cluster_state()
        if side == "port":
            assert svc.sim.snapshot_bytes() == before
        svc.close()
    assert states["port"] == states["ref"]
    assert states["port"]["total_gpus"] == 128 and len(states["port"]["racks"]) == 2


def test_reopening_with_another_config_raises_as_the_reference(tmp_path):
    msgs = []
    for side, (service, overrides, faults) in SIDES.items():
        svc = service.SchedulerService(tmp_path / side, scenario="smoke", seed=0,
                                       overrides=overrides(contention="fair-share"))
        svc.close()
        with pytest.raises(service.ServiceError, match="scenario") as a:
            service.SchedulerService(tmp_path / side, scenario="paper-batch")
        with pytest.raises(service.ServiceError, match="overrides") as b:
            service.SchedulerService(tmp_path / side,
                                     overrides=overrides(faults=faults(mode="mtbf")))
        service.SchedulerService(tmp_path / side).close()
        msgs.append((str(a.value).replace(str(tmp_path / side), "<dir>"),
                     str(b.value).replace(str(tmp_path / side), "<dir>")))
    assert msgs[0] == msgs[1]


# -- job specs ---------------------------------------------------------------------------

def test_schema_strings_are_the_references():
    assert p_jobspec.JOBSPEC_SCHEMA == r_jobspec.JOBSPEC_SCHEMA == "repro.service.jobspec/v1"
    assert p_jobspec.JOBSPEC_SCHEMA_V2 == r_jobspec.JOBSPEC_SCHEMA_V2 == \
        "repro.service.jobspec/v2"
    assert ps.SERVICE_ARTIFACT_SCHEMA == rs.SERVICE_ARTIFACT_SCHEMA
    assert ps.daemon.SERVICE_SCHEMA == rs.daemon.SERVICE_SCHEMA


def test_lint_guard_passes_on_the_port():
    proc = subprocess.run([sys.executable, str(ROOT / "tools" / "check_legacy_kwargs.py"),
                           str(ROOT / "src" / "repro_torch")], capture_output=True, text=True,
                          cwd=ROOT)
    assert proc.returncode == 0, proc.stdout + proc.stderr


@pytest.mark.parametrize("wire", [
    {"name": "legacy", "model": "yi-9b", "n_gpus": 8, "gpu_hours": 2.0},
    {"schema": "repro.service.jobspec/v1", "name": "x", "model": "qwen3-1.7b", "n_gpus": 2,
     "total_iters": 500, "tokens_per_gpu_iter": 2048, "arrival": 30.0},
    {"schema": "repro.service.jobspec/v2", "name": "team-a/run", "model": "yi-9b", "n_gpus": 8,
     "gpu_hours": 2.0, "tenant": "team-a", "priority": "high"},
    {"name": "t", "model": "rwkv6-7b", "n_gpus": 16, "gpu_hours": 1.0, "priority": "low",
     "parallelism": "auto"},
], ids=["v1", "v1-iters", "v2", "v2-implicit"])
def test_job_specs_round_trip_and_build_the_references_jobs(paper, wire):
    port, ref = ps.JobSpec.from_dict(wire), rs.JobSpec.from_dict(wire)
    assert port.to_dict() == ref.to_dict()
    assert ps.JobSpec.from_dict(port.to_dict()) == port
    job = port.build_job(7, dict(P_ARCHS))
    ref_job = ref.build_job(7, dict(R_ARCHS))
    assert p_jobspec.job_to_dict(job) == json.loads(json.dumps(r_jobspec.job_to_dict(ref_job)))
    assert p_jobspec.job_to_dict(p_jobspec.job_from_dict(p_jobspec.job_to_dict(job))) == \
        p_jobspec.job_to_dict(job)


def test_job_spec_prices_as_the_trace_makers():
    trace_job = make_batch_trace(list(P_ARCHS.values()), n_jobs=1, seed=0)[0]
    spec = ps.JobSpec(name="twin", model=trace_job.model, n_gpus=trace_job.n_gpus,
                      total_iters=trace_job.total_iters, tokens_per_gpu_iter=1024)
    job = spec.build_job(0, dict(P_ARCHS))
    assert job.skew == trace_job.skew
    assert job.compute_time_per_iter == compute_time_per_iter(
        P_ARCHS[trace_job.model].n_active_params(), 1024)


BAD_SPECS = [
    (lambda m: m.JobSpec(name="x", model="yi-9b", n_gpus=1), "JobSpecError"),
    (lambda m: m.JobSpec(name="x", model="yi-9b", n_gpus=1, gpu_hours=1.0, total_iters=10),
     "JobSpecError"),
    (lambda m: m.JobSpec(name="x", model="yi-9b", n_gpus=0, gpu_hours=1.0), "JobSpecError"),
    (lambda m: m.JobSpec(name="x", model="yi-9b", n_gpus=1, gpu_hours=1.0,
                         parallelism="magic"), "JobSpecError"),
    (lambda m: m.JobSpec.from_dict({"schema": "bogus/v9", "name": "x", "model": "yi-9b",
                                    "n_gpus": 1, "gpu_hours": 1.0}), "JobSpecError"),
    (lambda m: m.JobSpec.from_dict({"name": "x", "model": "yi-9b", "n_gpus": 1,
                                    "gpu_hours": 1.0, "urgency": 99}), "JobSpecError"),
    (lambda m: m.JobSpec.from_dict({"name": "x", "model": "yi-9b", "n_gpus": 1,
                                    "gpu_hours": 1.0, "priority": 99}), "JobSpecError"),
    (lambda m: m.JobSpec(name="x", model="yi-9b", n_gpus=1, gpu_hours=1.0, tenant=""),
     "JobSpecError"),
    (lambda m: m.JobSpec(name="x", model="yi-9b", n_gpus=1, gpu_hours=1.0, arrival="soon"),
     "JobSpecError"),
    (lambda m: m.JobSpec(name="x", model="yi-9b", n_gpus=1, gpu_hours="2.0"), "JobSpecError"),
    (lambda m: m.JobSpec(name="x", model="yi-9b", n_gpus=1, gpu_hours=1.0,
                         tokens_per_gpu_iter=0), "JobSpecError"),
    (lambda m: m.JobSpec(name="x", model="nope", n_gpus=1, gpu_hours=1.0).build_job(
        0, m.daemon._archs_by_name()), "JobSpecError"),
    (lambda m: m.AdmissionPolicy.from_dict({"max_waiting_jobs": 3}), "ValueError"),
]


@pytest.mark.parametrize("build,error", BAD_SPECS, ids=range(len(BAD_SPECS)))
def test_job_spec_validation_raises_the_references_errors(build, error):
    raised = []
    for mod in (ps, rs):
        with pytest.raises(Exception) as info:
            build(mod)
        raised.append((type(info.value).__name__, str(info.value)))
    assert raised[0] == raised[1]
    assert raised[0][0] == error


def test_admission_and_ledger_equal_the_references():
    out = []
    for mod in (ps, rs):
        ledger = mod.TenantLedger()
        spec = mod.JobSpec(name="x", model="yi-9b", n_gpus=8, gpu_hours=1.0, tenant="busy")
        for i in range(3):
            ledger.note_submit(mod.JobSpec(name=f"b{i}", model="yi-9b", n_gpus=8,
                                           gpu_hours=1.0, tenant="busy").build_job(
                i, mod.daemon._archs_by_name()))
        decisions = [mod.AdmissionPolicy(**kw).decide(spec, ledger) for kw in (
            {}, {"max_waiting_jobs_per_tenant": 3}, {"max_waiting_gpus": 24},
            {"max_waiting_gpus": 32})]
        ledger.note_op("place", 10.0, {"job_id": 0})
        ledger.note_op("preempt", 20.0, {"job_id": 0})
        ledger.note_op("place", 30.0, {"job_id": 1})
        out.append((decisions, ledger.as_dict(), ledger.total_waiting_gpus()))
    assert out[0] == out[1]
    assert out[0][0][0] is None and "waiting jobs" in out[0][0][1]

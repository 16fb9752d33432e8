"""The port's scheduler and cluster simulator (``repro_torch.core``) against
the JAX package's (``repro.core``), to the bit.

Both sides get the same architectures in the same order (the JAX package's
registry order: the trace makers draw ``rng.choice`` over that list) and the
same hardware profile (the paper's NVIDIA cluster; the port has no TPU
profile).  Traces, skews, latencies, every policy's ``results()`` and the
sequence of events a run processes must be equal, not close: the simulator is
plain Python and numpy on the host in both packages.  Shared reference runs
sit in module fixtures.
"""
import dataclasses
import itertools
import json

import pytest

import repro.configs as r_configs
import repro.core as r_core
import repro.core.policies as r_policies
import repro.core.policies.dally as r_dally
import repro.core.simulator as r_sim
import repro.core.trace as r_trace
import repro.types as r_types
import repro_torch.configs as p_configs
import repro_torch.core as p_core
import repro_torch.core.policies as p_policies
import repro_torch.core.policies.dally as p_dally
import repro_torch.core.simulator as p_sim
import repro_torch.core.trace as p_trace
import repro_torch.types as p_types

NAMES = list(r_configs.ARCHS)


@dataclasses.dataclass(frozen=True)
class Side:
    """One package's scheduler: its core, policies, trace module, profile
    and the ten configs in the JAX package's registry order."""
    core: object
    policies: object
    trace: object
    sim: object
    dally: object
    profile: object
    archs: tuple


REF = Side(r_core, r_policies, r_trace, r_sim, r_dally, r_types.NVIDIA_PAPER,
           tuple(r_configs.ARCHS[n] for n in NAMES))
PORT = Side(p_core, p_policies, p_trace, p_sim, p_dally, p_types.NVIDIA_PAPER,
            tuple(p_configs.ARCHS[n] for n in NAMES))
SIDES = (REF, PORT)

MAKERS = ("make_batch_trace", "make_poisson_trace", "make_bursty_trace", "make_mixed_trace",
          "make_philly_trace", "make_multi_tenant_trace")


def _jobs(jobs):
    """Every field of every job (a plan as the dict of its fields)."""
    return [dataclasses.asdict(j) for j in jobs]


def _trace(side, maker, n_jobs, seed=0, **kw):
    return getattr(side.core, maker)(list(side.archs), n_jobs=n_jobs, seed=seed,
                                     profile=side.profile, **kw)


def _cell(side, policy, *, n_racks, n_jobs, trace="make_batch_trace", seed=0,
          fabric=False, failures=None, degradations=None, telemetry=False, profile=False,
          checkpoint_overhead=0.0):
    """A simulator built as the JAX package's Scenario.build_sim builds one:
    8 machines of 8 GPUs a rack, a round every 300 s, overlap 0.25, the
    trace submitted up front; ``failures`` and ``degradations`` name a
    maker and its keywords (a schedule over the machines, or the racks)."""
    core = side.core
    cluster = core.ClusterTopology(n_racks=n_racks, machines_per_rack=8, gpus_per_machine=8)
    comm = core.CommModel.from_configs(list(side.archs), profile=side.profile,
                                       overlap_frac=0.25)
    machines = list(range(cluster.n_machines))
    racks = sorted({m // cluster.machines_per_rack for m in machines})
    fab = None
    if fabric:
        nic = comm.profile.tier("network").bandwidth
        fab = core.FairShareFabric(cluster, nic_bw=nic, rack_uplink_bw=4 * nic,
                                   spine_bw=fabric if fabric is not True else 8 * nic)
    fail = None
    if failures:
        name, kw = failures
        if name == "make_mtbf_failures":
            kw = {**kw, "seed": seed}
        fail = getattr(side.trace, name)(machines, **kw)
    degr = None
    if degradations:
        name, kw = degradations
        ids = racks if name in ("make_slow_nic_degradations",
                                "make_flapping_uplink_degradations") else machines
        degr = getattr(side.trace, name)(ids, seed=seed, **kw)
    sim = core.ClusterSimulator(cluster, side.policies.make_policy(policy), comm,
                                round_period=300.0, checkpoint_overhead=checkpoint_overhead,
                                failure_events=fail, degradation_events=degr, fabric=fab,
                                telemetry=telemetry, profile=profile)
    for job in _trace(side, trace, n_jobs, seed):
        sim.submit(job)
    return sim


def _run(side, policy, **kw):
    """(results(), the events as (kind, clock, running, waiting, free GPUs)
    after each one) of one cell run to its end."""
    sim = _cell(side, policy, **kw)
    events = []
    sim.event_hook = lambda s, kind: events.append(
        (kind, s.clock, len(s.running), len(s.waiting), s.cluster.free_gpus()))
    return sim.run(), events


def _assert_same_run(ref, port):
    assert ref[0] == port[0]
    assert len(ref[1]) == len(port[1])
    first = next((i for i, (a, b) in enumerate(zip(*[r[1] for r in (ref, port)])) if a != b),
                 None)
    assert first is None, f"event {first}: {ref[1][first]} against {port[1][first]}"


# -- types ---------------------------------------------------------------------

def test_nvidia_paper_profile_equals_the_reference():
    assert dataclasses.asdict(p_types.NVIDIA_PAPER) == dataclasses.asdict(r_types.NVIDIA_PAPER)
    for name in ("machine", "rack", "network"):
        assert (dataclasses.asdict(p_types.NVIDIA_PAPER.tier(name))
                == dataclasses.asdict(r_types.NVIDIA_PAPER.tier(name)))
    assert set(p_types.PROFILES) == {"h100_sxm", "nvidia_paper"}
    with pytest.raises(KeyError):
        p_types.NVIDIA_PAPER.tier("pod")


def test_scheduler_defaults_to_the_paper_cluster():
    assert p_core.CommModel({}).profile is p_types.NVIDIA_PAPER
    cfg = PORT.archs[0]
    assert (p_trace.compute_time_per_iter(cfg.n_active_params())
            == r_trace.compute_time_per_iter(cfg.n_active_params(),
                                             profile=r_types.NVIDIA_PAPER))


# -- traces --------------------------------------------------------------------

@pytest.mark.parametrize("parallelism", [None, "auto"])
@pytest.mark.parametrize("maker", MAKERS)
def test_trace_makers_equal_the_reference(maker, parallelism):
    a, b = (_jobs(_trace(s, maker, 300, seed=3, parallelism=parallelism)) for s in SIDES)
    assert len(a) == 300 and a == b
    if parallelism == "auto":
        assert any(j["plan"] is not None for j in a)


@pytest.mark.parametrize("maker, kw", [
    ("make_mtbf_failures", {}),
    ("make_mtbf_failures", {"mtbf": 6 * 3600.0, "mttr": 1800.0, "scope": 0.5}),
    ("make_rolling_maintenance", {}),
    ("make_straggler_degradations", {}),
    ("make_slow_nic_degradations", {}),
    ("make_flapping_uplink_degradations", {}),
])
def test_failure_and_degradation_makers_equal_the_reference(maker, kw):
    ids = list(range(16)) if "nic" in maker or "uplink" in maker else list(range(128))
    a, b = (getattr(s.trace, maker)(ids, seed=5, **kw) if maker != "make_rolling_maintenance"
            else getattr(s.trace, maker)(ids, **kw) for s in SIDES)
    assert a and a == b


def test_mixed_degradations_and_resolved_knobs_equal_the_reference():
    a, b = (s.trace.make_mixed_degradations(list(range(64)), list(range(8)), seed=2)
            for s in SIDES)
    assert a and a == b
    for mode in ("stragglers", "slow-nics", "flapping-uplinks", "mixed"):
        assert (p_trace.resolve_degradation_kw(mode) == r_trace.resolve_degradation_kw(mode))
    for mode in ("mtbf", "maintenance"):
        assert p_trace.resolve_failure_kw(mode) == r_trace.resolve_failure_kw(mode)
    with pytest.raises(ValueError):
        p_trace.resolve_degradation_kw("stragglers", {"mtdb": 1.0})


@pytest.mark.parametrize("writer, reader", [(REF, PORT), (PORT, REF)], ids=["jax-to-port",
                                                                            "port-to-jax"])
def test_csv_trace_crosses_packages(tmp_path, writer, reader):
    jobs = _trace(writer, "make_multi_tenant_trace", 80, seed=1, parallelism="auto")
    path = tmp_path / "trace.csv"
    writer.core.save_csv_trace(jobs, path)
    back = reader.core.load_csv_trace(path, list(reader.archs))
    again = writer.core.load_csv_trace(path, list(writer.archs))
    assert _jobs(back) == _jobs(again)
    assert len(back) == 80


# -- skew and latencies ----------------------------------------------------------

@pytest.mark.parametrize("name", NAMES)
def test_model_skew_equals_the_reference(name):
    skew = p_trace.model_skew(p_configs.ARCHS[name])
    assert 0.0 < skew < 1.0
    assert skew == r_trace.model_skew(r_configs.ARCHS[name])


PLACEMENTS = [((0, 1),), ((0, 8),), ((0, 4),), ((0, 4), (1, 4)), ((0, 8), (1, 8)),
              ((0, 2), (3, 6), (7, 8)), ((0, 8), (8, 8)), ((0, 8), (9, 8), (17, 8), (25, 8)),
              ((0, 3), (8, 5), (16, 8), (40, 8), (41, 8)),
              tuple((m, 8) for m in range(0, 64, 4))]


def _latencies(side, with_plan):
    comm = side.core.CommModel.from_configs(list(side.archs), profile=side.profile)
    out = []
    for cfg, alloc in itertools.product(side.archs, PLACEMENTS):
        pl = side.core.Placement(alloc)
        plan = (side.core.plan_for(cfg, pl.n_gpus, tokens_per_gpu_iter=2048)
                if with_plan else None)
        for bw in (None, 12.5e9):
            t = comm.plan_time(cfg.name, plan, pl, 8, 8, internode_bw=bw)
            out.append((cfg.name, alloc, bw, t,
                        comm.iteration_time(cfg.name, 0.5, pl, 8, 8, internode_bw=bw,
                                            plan=plan)))
        out.append(comm.sensitivity_pct(cfg.name, 0.5, pl.n_gpus))
    return out


@pytest.mark.parametrize("with_plan", [False, True], ids=["pure-dp", "plan"])
def test_comm_latencies_equal_the_reference(with_plan):
    a, b = (_latencies(s, with_plan) for s in SIDES)
    assert a == b


def test_load_calibration_reads_the_ports_dryrun_records(tmp_path):
    """The reference reads collective bytes at ``hlo``, the port's dry-run
    writes them at ``ops``: the same bytes give the same factor."""
    cfgs = [p_configs.ARCHS[n] for n in ("qwen3-1.7b", "yi-9b", "rwkv6-7b")]
    port = p_core.CommModel.from_configs(cfgs)
    ref = r_core.CommModel.from_configs([r_configs.ARCHS[c.name] for c in cfgs])
    for i, cfg in enumerate(cfgs[:2]):
        measured = (i + 1) * 3.0e9
        (tmp_path / "port").mkdir(exist_ok=True)
        (tmp_path / "ref").mkdir(exist_ok=True)
        base = {"status": "ok", "n_chips": 256}
        (tmp_path / "port" / f"{cfg.name}__train_4k__pod16x16.json").write_text(
            json.dumps({**base, "ops": {"collective_bytes": measured}}))
        (tmp_path / "ref" / f"{cfg.name}__train_4k__pod16x16.json").write_text(
            json.dumps({**base, "hlo": {"collective_bytes": measured}}))
    port.load_calibration(str(tmp_path / "port"))
    ref.load_calibration(str(tmp_path / "ref"))
    assert port.calibration == ref.calibration and len(port.calibration) == 2


# -- simulator cells -------------------------------------------------------------

@pytest.fixture(scope="module")
def paper_batch_ref():
    return {p: _run(REF, p, n_racks=8, n_jobs=500) for p in ("dally", "tiresias", "gandiva")}


@pytest.mark.parametrize("policy", sorted(p_policies.POLICIES))
def test_every_policy_on_a_small_cell_equals_the_reference(policy):
    assert sorted(p_policies.POLICIES) == sorted(r_policies.POLICIES)
    ref, port = (_run(s, policy, n_racks=2, n_jobs=60) for s in SIDES)
    assert ref[0]["n_finished"] == 60
    _assert_same_run(ref, port)


@pytest.mark.parametrize("policy", ["dally", "tiresias", "gandiva"])
def test_paper_batch_at_8_racks_equals_the_reference(paper_batch_ref, policy):
    port = _run(PORT, policy, n_racks=8, n_jobs=500)
    assert port[0]["n_finished"] == 500
    _assert_same_run(paper_batch_ref[policy], port)


@pytest.mark.parametrize("option, shows", [
    ({"failures": ("make_mtbf_failures", {"mtbf": 12 * 3600.0, "mttr": 3600.0}),
      "checkpoint_overhead": 120.0}, "n_job_failures"),
    ({"failures": ("make_rolling_maintenance", {"start": 3600.0, "window": 1800.0})},
     "n_machine_failures"),
    ({"degradations": ("make_straggler_degradations", {})}, "n_degrade_reprices"),
    ({"fabric": 50e9, "degradations": ("make_slow_nic_degradations", {})}, "n_degrade_events"),
    ({"fabric": 50e9, "trace": "make_poisson_trace"}, "n_reprices"),
    ({"telemetry": True, "fabric": 50e9}, "telemetry"),
], ids=["mtbf", "maintenance", "stragglers", "slow-nics", "fair-share", "telemetry"])
def test_cells_with_options_equal_the_reference(option, shows):
    """Each option on a 2-rack dally cell; ``shows`` is a key of results()
    that the option adds and that must show it acted."""
    ref, port = (_run(s, "dally", n_racks=2, n_jobs=80, **option) for s in SIDES)
    assert ref[0]["n_finished"] == 80
    assert ref[0][shows]
    _assert_same_run(ref, port)


def test_profiled_cell_equals_the_reference_but_for_wall_times():
    """With SimProfile on, the same results, events and call counts by
    phase; only the wall times (and the peak RSS gauge) are the host's."""
    ref, port = (_run(s, "dally", n_racks=2, n_jobs=60, profile=True) for s in SIDES)
    calls = []
    for res in (ref[0], port[0]):
        prof = res.pop("profile")
        res.pop("profile_gauges")
        assert prof and all(v["wall_s"] >= 0.0 for v in prof.values())
        calls.append({k: v["calls"] for k, v in prof.items()})
    assert calls[0] == calls[1]
    _assert_same_run(ref, port)


def test_restore_mid_run_continues_to_the_same_results():
    ref = _cell(REF, "dally", n_racks=2, n_jobs=80,
                failures=("make_mtbf_failures", {})).run()
    sim = _cell(PORT, "dally", n_racks=2, n_jobs=80, failures=("make_mtbf_failures", {}))
    sim.begin()
    sim.step_events(150)
    clone = p_core.ClusterSimulator.restore(sim.snapshot_bytes())
    while clone.events:
        clone.step_events(17)
    assert clone.results() == ref
    while sim.events:
        sim.step_events(29)
    assert sim.results() == ref


def test_service_mode_drive_equals_the_batch_run():
    """begin / submit / advance_to / step_events, as a service drives them."""
    ref = _cell(REF, "dally", n_racks=2, n_jobs=60, trace="make_poisson_trace").run()
    sim = _cell(PORT, "dally", n_racks=2, n_jobs=0)
    sim.begin()
    prev = 0.0
    for job in _trace(PORT, "make_poisson_trace", 60):
        sim.advance_to(prev)
        sim.submit(job)
        prev = job.arrival
    while not sim.idle:
        sim.step_events(11)
    assert sim.results() == ref


@pytest.mark.parametrize("policy", ["dally", "tiresias"])
def test_victim_scan_scalar_and_numpy_paths_equal_the_reference(policy, monkeypatch):
    """Force the numpy victim scan and scorers on (threshold 0) and off
    (threshold 1e9) on both sides of a congested cell: four equal runs."""
    runs = []
    for threshold in (0, 10**9):
        for side in SIDES:
            monkeypatch.setattr(side.sim, "_VEC_MIN_VICTIMS", threshold)
            monkeypatch.setattr(side.dally, "_VEC_MIN_SCORE", threshold)
            runs.append(_run(side, policy, n_racks=1, n_jobs=40, seed=7))
    assert runs[0][0]["preemptions"] > 0
    for other in runs[1:]:
        _assert_same_run(runs[0], other)


def test_unplaceable_jobs_are_rejected_as_the_reference_rejects_them():
    """A job wider than the cluster never enters the queue: both sides
    reject it at submission, count it in results() and finish the rest."""
    runs, rejected = [], []
    for side in SIDES:
        sim = _cell(side, "dally", n_racks=1, n_jobs=30)
        first = _trace(side, "make_batch_trace", 1, seed=3)[0]
        for k in (1, 2):
            sim.submit(dataclasses.replace(first, job_id=10**6 + k,
                                           n_gpus=sim.cluster.total_gpus + k))
        runs.append((sim.run(), []))
        rejected.append([j.job_id for j in sim.rejected])
    assert runs[0][0]["n_rejected"] == 2 and runs[0][0]["n_finished"] == 30
    assert rejected[0] == rejected[1] == [10**6 + 1, 10**6 + 2]
    _assert_same_run(*runs)

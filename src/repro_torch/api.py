"""The supported public surface of the scheduling reproduction.

Import from here instead of deep internal paths — ``__all__`` is the JAX
package's ``repro.api.__all__``, and everything in it is held to the
reference's artifacts by the port's tests, while internal module layout may
shift between releases::

    from repro_torch.api import SimOverrides, run_one

    art = run_one("congested-spine", policy="dally", seed=0,
                  overrides=SimOverrides(n_jobs=40))

    from repro_torch.api import SchedulerService
    svc = SchedulerService("runs/svc", scenario="smoke",
                           overrides=SimOverrides(contention="fair-share"))
    svc.submit({"name": "my-run", "model": "yi-9b", "n_gpus": 8,
                "gpu_hours": 2.0})
    svc.serve(exit_when_idle=True)
"""
from repro_torch.core.policies import POLICIES, make_policy
from repro_torch.core.simulator import ClusterSimulator
from repro_torch.experiments.faults import FaultSpec
from repro_torch.experiments.runner import (
    SimOverrides,
    artifact_json,
    run_one,
    run_one_timed,
)
from repro_torch.experiments.scenario import (
    SCENARIOS,
    Scenario,
    get_scenario,
    register,
)
from repro_torch.service import (
    AdmissionPolicy,
    AdmissionRejected,
    JobSpec,
    SchedulerService,
    TenantLedger,
)

__all__ = [
    # experiment cells
    "Scenario", "SCENARIOS", "get_scenario", "register",
    "SimOverrides", "FaultSpec", "run_one", "run_one_timed",
    "artifact_json",
    # policies
    "POLICIES", "make_policy",
    # the simulator and the online service around it
    "ClusterSimulator", "SchedulerService", "JobSpec",
    # multi-tenancy (jobspec v2): admission control + per-tenant ledger
    "AdmissionPolicy", "AdmissionRejected", "TenantLedger",
]

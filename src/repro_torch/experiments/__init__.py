"""Experiment orchestration: declarative scenarios, a deterministic
single-cell runner, and a process-parallel sweep (see docs/experiments.md).

The port's copy of the JAX package's ``repro.experiments``: the same
scenarios, artifacts and CLI (``python -m repro_torch.experiments.sweep``).
"""
from .faults import FaultSpec  # noqa: F401
from .runner import (  # noqa: F401
    ARTIFACT_SCHEMA,
    ARTIFACT_SCHEMA_V2,
    ARTIFACT_SCHEMA_V3,
    ARTIFACT_SCHEMA_V4,
    ARTIFACT_SCHEMA_V5,
    ARTIFACT_SCHEMA_V6,
    SimOverrides,
    artifact_json,
    run_one,
    run_one_timed,
)
from .scenario import (  # noqa: F401
    SCENARIOS,
    ContentionSchedule,
    Scenario,
    get_scenario,
    register,
    scenario_from_csv,
)

def __getattr__(name):  # lazy: `python -m repro_torch.experiments.sweep` must not
    if name == "sweep":  # find the submodule pre-imported in sys.modules
        from . import sweep
        return sweep
    raise AttributeError(name)

"""Online scheduler service: a durable daemon around ClusterSimulator.

See docs/service.md for the lifecycle, the job-spec/journal wire formats,
and the crash-recovery byte-identity guarantee.  Run one with::

    python -m repro_torch.service --state-dir runs/svc --inbox runs/inbox \\
        --scenario smoke --exit-when-idle

The port's copy of the JAX package's ``repro.service``.
"""
from .daemon import (  # noqa: F401
    SERVICE_ARTIFACT_SCHEMA,
    SERVICE_SCHEMA,
    DuplicateJobSpec,
    SchedulerService,
    ServiceError,
)
from .jobspec import (  # noqa: F401
    JOBSPEC_SCHEMA,
    JOBSPEC_SCHEMA_V2,
    JobSpec,
    JobSpecError,
)
from .journal import JOURNAL_SCHEMA, Journal  # noqa: F401
from .tenancy import (  # noqa: F401
    DEFAULT_TENANT,
    AdmissionPolicy,
    AdmissionRejected,
    TenantLedger,
)

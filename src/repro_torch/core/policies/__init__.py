from .base import Policy  # noqa: F401
from .dally import DallyPolicy  # noqa: F401
from .gandiva import GandivaPolicy, ScatterPolicy  # noqa: F401
from .tiresias import TiresiasPolicy  # noqa: F401
from .variants import (  # noqa: F401
    DallyFullyConsolidatedPolicy,
    DallyManualPolicy,
    DallyNoWaitPolicy,
    DallyPatternBlindPolicy,
)

POLICIES = {
    "dally": DallyPolicy,
    "dally-blind": DallyPatternBlindPolicy,
    "dally-manual": DallyManualPolicy,
    "dally-nowait": DallyNoWaitPolicy,
    "dally-fullyconsolidated": DallyFullyConsolidatedPolicy,
    "tiresias": TiresiasPolicy,
    "gandiva": GandivaPolicy,
    "scatter": ScatterPolicy,
}


def make_policy(name: str, **kw) -> Policy:
    return POLICIES[name.lower()](**kw)

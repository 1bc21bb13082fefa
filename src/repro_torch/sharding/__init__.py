"""Sharding rules of the port: logical axes resolved to mesh axes
(``specs``) and kernels run on a DTensor's local shards (``local``)."""
from repro_torch.sharding.specs import (  # noqa: F401
    AxisRules,
    DEFAULT_PARAM_RULES,
    DEFAULT_ACT_RULES,
    activate_rules,
    active_rules,
    logical_constraint,
    spec_for,
    sharding_for,
    param_shardings,
    abstract_param_shardings,
)

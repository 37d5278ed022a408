"""Sharding rules: parameter partition specs and logical-axis rules
(port of `repro.sharding`)."""
from repro_torch.sharding.axes import (
    AxisRules,
    constrain,
    current_rules,
    use_rules,
)
from repro_torch.sharding.specs import param_spec, tree_param_specs

__all__ = [
    "AxisRules",
    "constrain",
    "current_rules",
    "use_rules",
    "param_spec",
    "tree_param_specs",
]

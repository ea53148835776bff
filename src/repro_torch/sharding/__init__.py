from repro_torch.sharding.hints import (
    arange_like, current_rules, full_hint, is_sharded, logical_rules,
    per_device, shard_hint, sharded_reshape, spec_for)
from repro_torch.sharding.rules import (
    RULESETS, axis_sizes, guard_divisibility, guard_spec, make_ruleset,
    param_spec_tree, to_placements)

__all__ = [
    "shard_hint", "sharded_reshape", "is_sharded", "arange_like",
    "full_hint", "per_device", "logical_rules",
    "current_rules",
    "spec_for", "RULESETS", "axis_sizes", "param_spec_tree", "make_ruleset",
    "guard_divisibility", "guard_spec", "to_placements",
]

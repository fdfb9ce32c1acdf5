"""Logical-axis sharding rules of the port: the solver's problem axis and the LM mesh."""
from repro_torch.sharding.partition import (
    Placement,
    Rules,
    batch_solve_rules,
    constrain,
    current_rules,
    cut,
    data_shard_count,
    default_rules,
    fit_spec,
    replicated_rules,
    sharding_tree,
    spec_tree,
    use_rules,
)

__all__ = ["Placement", "Rules", "batch_solve_rules", "constrain", "current_rules", "cut",
           "data_shard_count", "default_rules", "fit_spec", "replicated_rules",
           "sharding_tree", "spec_tree", "use_rules"]

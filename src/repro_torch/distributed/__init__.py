from repro_torch.distributed.axes import (
    DEFAULT_RULES,
    PartitionSpec,
    logical_constraint,
    resolve_axis,
    sharding_for,
    spec_for,
    use_rules,
)

__all__ = [
    "DEFAULT_RULES", "PartitionSpec", "logical_constraint", "resolve_axis",
    "sharding_for", "spec_for", "use_rules",
]

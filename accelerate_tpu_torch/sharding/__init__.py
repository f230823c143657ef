"""The sharding planner and its rules (port of `accelerate_tpu/sharding`):
a `PartitionSpec` per param leaf over the port's process mesh, and each
rank's shard of a tree (`shard_pytree`). `constrain`, the reference's
in-jit activation hint, arrives with sequence parallelism (queue 1 item
6b, part 2)."""

from .planner import (
    NamedSharding,
    PartitionSpec,
    auto_fsdp_spec,
    batch_sharding,
    batch_spec,
    describe_plan,
    holds_blocks,
    plan_optimizer_sharding,
    placement_of,
    plan_sharding,
    shard_pytree,
)
from .rules import ShardingRule, ShardingRules, transformer_rules

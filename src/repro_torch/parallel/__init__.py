"""Distribution: logical-axis sharding on DTensor (``sharding``),
sequence-sharded flash-decode (``flash_decode``) and the GPipe pipeline
(``pipeline``)."""

from repro_torch.parallel.sharding import (  # noqa: F401
    Axes,
    ShardingRules,
    logical_spec,
    shard_constraint,
)

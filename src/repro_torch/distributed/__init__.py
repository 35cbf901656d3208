"""Distribution: logical-axis sharding rules onto DTensor placements, for
the (pod, data, model) mesh, as ``repro.distributed``."""
from repro_torch.distributed.sharding import (ShardingRules, DEFAULT_RULES,
                                              logical_to_sharding,
                                              shard_params,
                                              batch_sharding)  # noqa: F401

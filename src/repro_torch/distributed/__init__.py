from repro_torch.distributed.pipeline_parallel import gpipe_apply
from repro_torch.distributed.sharding import (DEFAULT_RULES, NamedSharding,
                                              PartitionSpec, ShardingRules,
                                              batch_specs, named_shardings,
                                              partition_spec)

__all__ = ["DEFAULT_RULES", "NamedSharding", "PartitionSpec", "ShardingRules",
           "batch_specs", "gpipe_apply", "named_shardings", "partition_spec"]

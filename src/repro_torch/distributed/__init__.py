from repro_torch.distributed.sharding import (DEFAULT_RULES, NamedSharding,
                                              PartitionSpec, ShardingRules,
                                              batch_specs, named_shardings,
                                              partition_spec)

__all__ = ["DEFAULT_RULES", "NamedSharding", "PartitionSpec", "ShardingRules",
           "batch_specs", "named_shardings", "partition_spec"]

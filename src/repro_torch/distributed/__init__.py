"""Distribution: logical-axis sharding rules for params, LoRA banks, batches
and caches, the shards they cut, and the collectives of the sharded
forward."""

"""repro_torch.parallel — serving over a mesh of ranks: the sharding rules
(:mod:`.sharding`), the collectives (:mod:`.comm`) and the expert-parallel
MoE (:mod:`.moe_shard_map`)."""

"""repro_torch.parallel — serving and training over a mesh of ranks: the
sharding rules (:mod:`.sharding`), the collectives, which carry gradients
(:mod:`.comm`), the expert-parallel MoE (:mod:`.moe_shard_map`) and the
GPipe block stack (:mod:`.pipeline`)."""

"""Distribution on one GPU (port of ``repro.dist``): the reference's mesh
folded onto one device, with its axes as explicit array axes.

sharding.py     ParamSpec trees, Mesh/PartitionSpec/NamedSharding, the
                logical->physical rules, activation constraints
collectives.py  bf16/int8-compressed gradient mean + pure-DP step; the
                chip farm's reductions
pipeline.py     GPipe microbatch ring over a folded mesh axis

The reference's ``compat.py`` only installs JAX API shims and has no
counterpart."""

"""What a step runs on a mesh of ranks: the collectives over its axes and
their autograd Functions (`collectives`), and tensors placed on it by
specs the caller computes (`placement`: `Sharded`, `local_shard`,
`gather_full`, `state_to_mesh`, ...).

The layer below ``models``, ``optim``, ``data`` and ``checkpoint``: it
imports none of them and nothing of ``repro_torch.launch``, whose
``sharding`` computes the reference's specs and builds the placement
(``launch.sharding.placement``) that ``launch.train`` hands down.
"""

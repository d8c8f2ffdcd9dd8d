"""The port of ``repro/distributed``: the sharding rules as DTensor
placements (:mod:`repro_torch.distributed.sharding`) and gradient
compression with ``compressed_psum`` (:mod:`repro_torch.distributed.
compression`)."""

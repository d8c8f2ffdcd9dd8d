"""Hand-written Hopper kernels (``csrc/``) with their plain PyTorch
versions, launch counters and the tile predicate (``ops.tile_ok``)."""

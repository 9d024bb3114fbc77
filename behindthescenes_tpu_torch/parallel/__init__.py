"""Multi-rank execution on `torch.distributed` (counterpart of
behindthescenes_tpu/parallel/): `mesh` holds the group and sharding
helpers, `launch` starts a function on several local ranks."""

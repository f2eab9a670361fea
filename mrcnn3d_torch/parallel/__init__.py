"""Multi-process parallelism over torch.distributed (`mrcnn3d/parallel`):
the process groups and the gradient all-reduce (`mesh`), batched
inference (`batched`), depth sharding of the backbone (`spatial`) and a
spawner of gloo process groups (`launch`)."""

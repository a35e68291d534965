"""Multi-device layouts: the slab sweeps, the polarized traces and the FFT
operators over a 1-D ``torch.distributed`` device mesh, one process per
device (counterpart of the JAX package's ``parallel/``, which runs inside
``jax.shard_map``)."""

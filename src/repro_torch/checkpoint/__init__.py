"""Durable checkpoints: pytrees of tensors or arrays <-> npz files, in the
JAX package's on-disk format (``npz``)."""
from repro_torch.checkpoint.npz import (CheckpointError, gc_checkpoints,
                                        latest_checkpoint, list_checkpoints,
                                        load_pytree, save_pytree)

__all__ = ["save_pytree", "load_pytree", "CheckpointError",
           "latest_checkpoint", "list_checkpoints", "gc_checkpoints"]

"""Sharding of the transformer over a mesh of ranks: the logical-axis
rules and their DTensor placements."""
from repro_torch.parallel import sharding

__all__ = ["sharding"]

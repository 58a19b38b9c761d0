"""PyTorch/CUDA port of the hierarchical-FL system, for one NVIDIA H100.

Mirrors the JAX package ``repro`` module for module (``repro_torch.core``
↔ ``repro.core`` and so on) and imports nothing of it, nor JAX.  The
slice ported so far is the paper's main path: ``core.plan`` picks the
association and (a*, b*); ``fl.sim.HFLSimulator`` runs synchronous or
async Algorithm 1 on the flat ``(N, F_total)`` buffer, whose edge (eq. 6)
and cloud (eq. 10) aggregations are hand-written CUDA kernels
(``kernels/csrc``), as is the per-edge sum of each chunk the streaming
edge accumulator (``fl.aggregate.StreamingEdgeAccumulator``) folds.
Entry points run on the card unless given ``device="cpu"``.
"""

"""Hand-written CUDA kernels of the port and their plain PyTorch versions.

* ``hier_aggregate`` — eq. 6 edge and eq. 10 cloud aggregation over the
  flat ``(N, F)`` buffer (``csrc/segment_aggregate.cu``,
  ``csrc/cloud_aggregate.cu``), and the streaming accumulator's per-edge
  weighted sums (``csrc/segment_sum.cu``).
* ``build``          — ``nvcc`` build at first use, bound with ``ctypes``.
"""

"""Hand-written CUDA kernels of the port and their plain PyTorch versions.

* ``hier_aggregate`` — eq. 6 edge and eq. 10 cloud aggregation over the
  flat ``(N, F)`` buffer (``csrc/segment_aggregate.cu``,
  ``csrc/cloud_aggregate.cu``), the reduce-only weighted mean of a data
  shard's slab (``csrc/weighted_mean.cu``), and the streaming
  accumulator's per-edge weighted sums (``csrc/segment_sum.cu``).
* ``flash_attention`` — blocked online-softmax GQA attention with causal
  and sliding-window masks, the prefill attention of the transformer stack
  (``csrc/flash_attention.cu``).
* ``rglru_scan``     — the RG-LRU linear recurrence ``h_t = a_t h_{t-1} +
  b_t`` (``csrc/rglru_scan.cu``).
* ``decode_attention`` — one-token GQA attention over the ring KV cache,
  the decode attention of the transformer stack
  (``csrc/decode_attention.cu``).
* ``build``          — ``nvcc`` build at first use, bound with ``ctypes``.
"""

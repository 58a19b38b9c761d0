"""Models the port supports: LeNet and logistic regression (``lenet``), and
the transformer stack for the ``attn``, ``local_attn`` and ``rglru`` layer
kinds (``model.build_model``: serving, and the training loss through
``impl="xla_flash"``; RecurrentGemma runs whole)."""

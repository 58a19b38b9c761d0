"""Models the port supports: LeNet and logistic regression (``lenet``), and
the transformer stack's serving path for the ``attn``, ``local_attn`` and
``rglru`` layer kinds (``model.build_model``; RecurrentGemma runs whole)."""

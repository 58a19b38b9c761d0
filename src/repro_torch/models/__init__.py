"""Models the port supports: LeNet and logistic regression (``lenet``), and
the transformer stack for the ``attn`` (with an MLP or the MoE FFN,
``moe``), ``local_attn``, ``rglru``, ``mlstm`` and ``slstm`` layer kinds
(``model.build_model``: serving, and the training loss through
``impl="xla_flash"``)."""

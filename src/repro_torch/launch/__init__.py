"""Launchers of the port: the serving driver (``serve``) and its step
(``steps.make_serve_step``), the training launcher (``train``: ``--mode
dp`` and ``--mode hfl``) and its step (``steps.make_train_step``), meshes
of ``torch.distributed`` ranks for the data-sharded flat buffer and the
SPMD backend (``mesh``), and the crash-tolerant always-on HFL control
plane (``service``: ``HFLService``, ``python -m
repro_torch.launch.service``)."""

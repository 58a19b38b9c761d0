"""Launchers of the port: the serving driver (``serve``) and its step
(``steps.make_serve_step``), and meshes of ``torch.distributed`` ranks for
the data-sharded flat buffer (``mesh``)."""

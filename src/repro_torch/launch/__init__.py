"""Launchers of the port: the serving driver (``serve``) and its step
(``steps.make_serve_step``)."""

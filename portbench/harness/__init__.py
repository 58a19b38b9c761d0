"""The benchmark's own machinery: definitions found by name, the run's
environment, the profiled slice and the arithmetic on its intervals.

Nothing here imports the program (``repro_torch``) at module level; the
entries under ``portbench/entries`` do, when a run builds them.
"""

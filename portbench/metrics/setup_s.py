"""``setup_s``: seconds from the run's start (the process's first line)
to the end of set-up: imports, inputs and weights drawn from the seed,
the program built, its kernels built or loaded, every shape warmed up."""


def value(rec) -> float:
    return rec["setup_s"]

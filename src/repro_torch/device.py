"""Where the port's entry points run.

Every entry point takes ``device=``.  ``None`` means the CUDA card; if
there is none the entry point raises instead of running on the CPU
unasked.  Callers that want the CPU (the tests do) say ``device="cpu"``.
"""
from __future__ import annotations

import torch


def resolve_device(device=None) -> torch.device:
    """The device an entry point runs on: the card unless named otherwise."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "repro_torch runs on a CUDA device by default and none is "
                "available; pass device='cpu' to run on the CPU")
        return torch.device("cuda")
    return torch.device(device)

"""The kernels' refusal of autograd.

The CUDA kernels write a fresh output tensor through ``ctypes``: the
output has no ``grad_fn``, so a loss that went through one would give its
inputs no gradient, silently.  None of them has a backward (nor has the
reference's Pallas kernels: no ``custom_vjp`` in ``repro/kernels``); the
reference trains through ``impl="xla_flash"``.  So on a CUDA tensor each
wrapper calls ``refuse_autograd`` before it launches.
"""
from __future__ import annotations

import torch


def refuse_autograd(kernel: str, *tensors) -> None:
    """Raise ``RuntimeError`` when grad mode is on and one of ``tensors``
    requires grad, or under a ``torch.func`` transform (``grad``,
    ``vmap``, ...).  Under ``torch.no_grad()`` a kernel launches as ever."""
    if torch._C._functorch.peek_interpreter_stack() is not None:
        why = "under a torch.func transform"
    elif torch.is_grad_enabled() and any(t.requires_grad for t in tensors):
        why = "on inputs that require grad"
    else:
        return
    raise RuntimeError(
        f"{kernel}: the CUDA kernel has no backward and cannot run {why}; "
        f"train through impl=\"xla_flash\" (models.model.Model), or call it "
        f"under torch.no_grad()")

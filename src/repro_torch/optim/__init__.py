from repro_torch.optim.optimizers import Optimizer, adamw, opt_state_axes, sgd

__all__ = ["Optimizer", "adamw", "opt_state_axes", "sgd"]

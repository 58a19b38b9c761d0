"""LeNet on (synthetic-)MNIST — the paper's own simulation model (§V-A).

"For machine learning tasks, we consider a classification task using
standard dataset MNIST. For the training model, we use LeNet."
MNIST is unavailable offline; repro_torch.data.synthetic makes a class-mean
Gaussian image set of the same shape (see DESIGN.md §6.3).
"""
import dataclasses


@dataclasses.dataclass(frozen=True)
class LeNetConfig:
    name: str = "lenet-mnist"
    image_size: int = 28
    in_channels: int = 1
    num_classes: int = 10
    conv_channels: tuple = (6, 16)
    kernel_size: int = 5
    fc_dims: tuple = (120, 84)


CONFIG = LeNetConfig()
SMOKE_CONFIG = LeNetConfig(name="lenet-mnist-smoke", conv_channels=(4, 8), fc_dims=(32, 16))

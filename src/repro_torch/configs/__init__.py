"""Model configurations the port supports: dataclass copies of the JAX
package's ``repro/configs`` (LeNet for the FL path; the ten architectures
of the transformer stack, loaded with ``get_config``)."""
from repro_torch.configs.base import (
    ARCH_IDS,
    INPUT_SHAPES,
    ModelConfig,
    ShapeConfig,
    get_config,
)
from repro_torch.configs.lenet_mnist import CONFIG, SMOKE_CONFIG, LeNetConfig

__all__ = ["ARCH_IDS", "CONFIG", "INPUT_SHAPES", "LeNetConfig", "ModelConfig",
           "SMOKE_CONFIG", "ShapeConfig", "get_config"]

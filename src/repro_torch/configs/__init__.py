"""Model configurations the port supports (dataclass copies of the JAX
package's ``repro/configs``)."""
from repro_torch.configs.lenet_mnist import CONFIG, SMOKE_CONFIG, LeNetConfig

__all__ = ["CONFIG", "SMOKE_CONFIG", "LeNetConfig"]

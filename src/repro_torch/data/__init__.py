"""Data substrate: synthetic datasets + federated partitioners."""
from repro_torch.data.partition import (dirichlet_partition, iid_partition,
                                        size_partition)
from repro_torch.data.synthetic import (class_gaussian_images, logreg_data,
                                        synthetic_mnist)

__all__ = [
    "class_gaussian_images", "logreg_data", "synthetic_mnist",
    "dirichlet_partition", "iid_partition", "size_partition",
]

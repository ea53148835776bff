from repro_torch.data.builders import make_federated_image_dataset
from repro_torch.data.partition import (
    build_client_arrays, dirichlet_partition, paper_noniid_partition)
from repro_torch.data.pipeline import (
    ClientData, FederatedDataset, gather_client_batches,
    sample_batch_indices, split_client_holdout)
from repro_torch.data.population import (
    DensePopulationData, SyntheticPopulation, make_synthetic_population)
from repro_torch.data.synthetic import (
    CIFAR_LIKE, MNIST_LIKE, ImageSpec, make_image_dataset,
    make_token_stream)

__all__ = [
    "CIFAR_LIKE", "MNIST_LIKE", "ClientData", "DensePopulationData",
    "FederatedDataset", "ImageSpec", "SyntheticPopulation",
    "build_client_arrays", "dirichlet_partition", "gather_client_batches",
    "make_federated_image_dataset", "make_image_dataset",
    "make_synthetic_population", "make_token_stream",
    "paper_noniid_partition",
    "sample_batch_indices", "split_client_holdout",
]

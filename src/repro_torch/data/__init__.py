"""repro_torch.data — deterministic synthetic heterogeneous data pipelines."""

from .pipeline import (
    HeterogeneousLMData,
    client_weights_from_counts,
    dirichlet_partition,
    dirichlet_proportions,
    lm_batch_iterator,
    make_lm_data,
    make_prefix_embeddings,
    worker_batches,
)

__all__ = [
    "HeterogeneousLMData",
    "client_weights_from_counts",
    "dirichlet_partition",
    "dirichlet_proportions",
    "lm_batch_iterator",
    "make_lm_data",
    "make_prefix_embeddings",
    "worker_batches",
]

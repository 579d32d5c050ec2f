"""repro_torch.data — deterministic synthetic heterogeneous token streams."""

from .pipeline import HeterogeneousLMData, worker_batches

__all__ = ["HeterogeneousLMData", "worker_batches"]

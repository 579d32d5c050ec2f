"""repro_torch.models — the dense LM training path (port of repro.models)."""

from .config import LayerSpec, ModelConfig, Segment, dense_stack
from repro_torch.device import default_device

from .model import forward, init_params, lm_loss, param_count

__all__ = [
    "LayerSpec", "ModelConfig", "Segment", "default_device", "dense_stack",
    "forward", "init_params", "lm_loss", "param_count",
]

"""repro_torch.models — the LM of every family (global and sliding-window
GQA, MLA, the recurrent RG-LRU, mLSTM and sLSTM mixers, MLP and MoE
feed-forwards, MTP, sinusoidal positions, frontend prefixes): training,
dense / ring / latent-cache and recurrent-state decode and the paged
serving steps (port of repro.models)."""

from .config import LayerSpec, MLAConfig, MoEConfig, ModelConfig, Segment, dense_stack, reduced
from repro_torch.device import default_device

from .model import (
    decode_step,
    forward,
    init_cache,
    init_paged_cache,
    init_params,
    lm_loss,
    logits_parallel,
    paged_copy_pages,
    paged_decode_step,
    paged_gather_pages,
    paged_prefill_chunk,
    paged_scatter_pages,
    param_count,
    prefill,
)

__all__ = [
    "LayerSpec", "MLAConfig", "MoEConfig", "ModelConfig", "Segment", "default_device",
    "dense_stack", "reduced", "decode_step", "forward", "init_cache",
    "init_paged_cache", "init_params", "lm_loss", "logits_parallel", "paged_copy_pages",
    "paged_decode_step", "paged_gather_pages", "paged_prefill_chunk",
    "paged_scatter_pages", "param_count", "prefill",
]

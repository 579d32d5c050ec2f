"""Architecture registry (port of ``repro.configs``).

Each ``<arch>.py`` exposes ``get_config() -> ArchConfig`` with the published
dimensions ([citation] per file) and the distribution policy of the
reference (worker axes, parameter sharding flavour, frontend prefix,
long-context support). All ten of the reference's architectures are
ported: the attention and MoE families and the two recurrent ones.
"""

from __future__ import annotations

import dataclasses
import importlib

from repro_torch.models.config import ModelConfig

ARCH_IDS = [
    "deepseek_v3_671b",
    "qwen15_0_5b",
    "llama4_scout_17b_a16e",
    "musicgen_medium",
    "qwen3_32b",
    "internvl2_1b",
    "deepseek_coder_33b",
    "gemma3_27b",
    "recurrentgemma_2b",
    "xlstm_350m",
]

# public ids (with dashes) map to module names
PUBLIC_TO_MODULE = {
    "deepseek-v3-671b": "deepseek_v3_671b",
    "qwen1.5-0.5b": "qwen15_0_5b",
    "llama4-scout-17b-a16e": "llama4_scout_17b_a16e",
    "musicgen-medium": "musicgen_medium",
    "qwen3-32b": "qwen3_32b",
    "internvl2-1b": "internvl2_1b",
    "deepseek-coder-33b": "deepseek_coder_33b",
    "gemma3-27b": "gemma3_27b",
    "recurrentgemma-2b": "recurrentgemma_2b",
    "xlstm-350m": "xlstm_350m",
}


@dataclasses.dataclass(frozen=True)
class ArchConfig:
    model: ModelConfig
    #: how to split the MARINA worker axis on the multi-pod mesh:
    #: "pod_data" → n = pods × data (small/mid models);
    #: "pod"      → n = pods, data axis becomes intra-worker FSDP (giant MoE).
    worker_axes: str = "pod_data"
    #: shard params over the data axis too (FSDP/ZeRO-3 within a worker)
    fsdp: bool = False
    #: prefix length of stub frontend embeddings (vlm/audio); 0 = none
    prefix_len: int = 0

    @property
    def runs_long_context(self) -> bool:
        return self.model.supports_long_context() or self._windowed_dense()

    def _windowed_dense(self) -> bool:
        kinds = [l.mixer for s in self.model.segments for l in s.period]
        # dense archs qualify if *global* attention is a bounded fraction and
        # the rest is sliding-window (gemma3 5:1)
        return "attn_local" in kinds and kinds.count("attn") <= len(kinds) // 4


def get_arch(name: str) -> ArchConfig:
    mod_name = PUBLIC_TO_MODULE.get(name, name.replace("-", "_").replace(".", "_"))
    if mod_name not in ARCH_IDS:
        raise ValueError(f"unknown architecture {name!r}")
    mod = importlib.import_module(f"repro_torch.configs.{mod_name}")
    return mod.get_config()

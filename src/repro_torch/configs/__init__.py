"""Architecture registry (port of ``repro.configs``).

Each ``<arch>.py`` exposes ``get_config() -> ArchConfig`` with the published
dimensions. Only the dense architectures the port can train are present.
"""

from __future__ import annotations

import dataclasses
import importlib

from repro_torch.models.config import ModelConfig

ARCH_IDS = ["qwen15_0_5b"]

# public ids (with dashes) map to module names
PUBLIC_TO_MODULE = {"qwen1.5-0.5b": "qwen15_0_5b"}


@dataclasses.dataclass(frozen=True)
class ArchConfig:
    model: ModelConfig


def get_arch(name: str) -> ArchConfig:
    mod_name = PUBLIC_TO_MODULE.get(name, name.replace("-", "_").replace(".", "_"))
    if mod_name not in ARCH_IDS:
        raise NotImplementedError(f"architecture {name!r} is not ported yet")
    mod = importlib.import_module(f"repro_torch.configs.{mod_name}")
    return mod.get_config()

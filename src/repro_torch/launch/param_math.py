"""Analytic parameter and FLOP accounting for full-size configs, with no
allocation (port of ``repro.launch.param_math``).

The shapes are ``init_params(…, device="meta")``'s, the tree the launch
layer builds its steps on (``launch/distributed.py``), so a count is
exactly what a run would allocate. ``model_flops`` is 6·N·D (dense) or
6·N_active·D (MoE): the useful-compute yardstick a training cell's share of
the card's peak is read against (``roofline.RooflineReport``).
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from repro_torch.core.tree_util import tree_flatten_with_path, tree_leaves
from repro_torch.models import init_params
from repro_torch.models.config import ModelConfig

#: the stacked expert weights of an MoE feed-forward, (repeat?, E, d, f)
MOE_EXPERT_LEAVES = ("moe_gate", "moe_up", "moe_down")


@functools.lru_cache(maxsize=None)
def _shapes(cfg: ModelConfig, dtype: torch.dtype):
    return init_params(0, cfg, dtype, device="meta")


def param_shapes(cfg: ModelConfig, dtype=torch.bfloat16):
    """The parameter tree of ``cfg`` as meta tensors (shapes and dtypes,
    no storage)."""
    return _shapes(cfg, dtype)


def count_params(cfg: ModelConfig) -> int:
    """Every parameter of ``cfg``."""
    return sum(int(np.prod(t.shape)) for t in tree_leaves(param_shapes(cfg)))


def count_active_params(cfg: ModelConfig) -> int:
    """Parameters touched per token: the stacked MoE expert weights count at
    top_k/E (shared experts and everything else in full)."""
    total = 0
    for path, leaf in tree_flatten_with_path(param_shapes(cfg))[0]:
        n = int(np.prod(leaf.shape))
        keys = {getattr(p, "key", None) for p in path}
        if cfg.moe is not None and keys & set(MOE_EXPERT_LEAVES) and leaf.ndim >= 3:
            n = int(n * cfg.moe.top_k / cfg.moe.num_experts)
        total += n
    return total


def model_flops(cfg: ModelConfig, tokens: int) -> float:
    """6·N_active·D: the useful compute of training on ``tokens`` tokens."""
    return 6.0 * count_active_params(cfg) * tokens

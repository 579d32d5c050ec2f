"""Layer assembly: (pre-norm mixer + residual) ∘ (pre-norm FF + residual) —
port of the dense attention + MLP layer of ``repro.models.blocks``.

MoE, SSM, MLA and local-attention layers and the serving caches are not
ported yet.
"""

from __future__ import annotations

from typing import Any

import torch

from . import attention as attn
from .config import LayerSpec, ModelConfig
from .layers import init_mlp, init_rmsnorm, mlp, rmsnorm

PyTree = Any


def _check_spec(spec: LayerSpec) -> None:
    if spec.mixer != "attn" or spec.ff not in ("mlp", "none"):
        raise NotImplementedError(
            f"layer {spec.mixer}/{spec.ff} is not ported yet (dense attn + mlp only)")


def init_layer(gen, cfg: ModelConfig, spec: LayerSpec, dtype, device) -> PyTree:
    _check_spec(spec)
    p: dict[str, Any] = {
        "ln1": init_rmsnorm(cfg.d_model, dtype, device),
        "mixer": attn.init_attn(gen, cfg, dtype, device),
    }
    if spec.ff == "mlp":
        p["ln2"] = init_rmsnorm(cfg.d_model, dtype, device)
        p["ff"] = init_mlp(gen, cfg.d_model, cfg.d_ff, dtype, device)
    return p


def layer_train(p: PyTree, cfg: ModelConfig, spec: LayerSpec, x: torch.Tensor,
                positions: torch.Tensor):
    """→ (x', aux_loss)."""
    _check_spec(spec)
    h = rmsnorm(x, p["ln1"], cfg.norm_eps)
    x = x + attn.attn_train(p["mixer"], cfg, h, positions, chunk=cfg.attn_chunk)
    if spec.ff == "mlp":
        x = x + mlp(p["ff"], rmsnorm(x, p["ln2"], cfg.norm_eps))
    return x, torch.zeros((), dtype=torch.float32, device=x.device)

"""Layer assembly: (pre-norm mixer + residual) ∘ (pre-norm FF + residual) —
port of the dense attention + MLP layer of ``repro.models.blocks``: training
(optionally returning the serving cache, so prefill is one forward pass),
dense-cache decode, and the paged twins of both for the serving engine.

MoE, SSM, MLA and local-attention layers are not ported yet.
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
                positions: torch.Tensor, *, want_cache: bool = False,
                cache_len: int | None = None):
    """→ (x', aux_loss, cache-or-None)."""
    _check_spec(spec)
    h = rmsnorm(x, p["ln1"], cfg.norm_eps)
    cache = None
    x = x + attn.attn_train(p["mixer"], cfg, h, positions, chunk=cfg.attn_chunk)
    if want_cache:
        cache = _attn_cache_from_prefill(p["mixer"], cfg, h, positions,
                                         cache_len or h.shape[1])
    return _ff_decode(p, cfg, spec, x), torch.zeros((), dtype=torch.float32,
                                                    device=x.device), cache


def layer_decode(p: PyTree, cfg: ModelConfig, spec: LayerSpec, cache: PyTree,
                 x_t: torch.Tensor, pos: int):
    _check_spec(spec)
    h = rmsnorm(x_t, p["ln1"], cfg.norm_eps)
    y, cache = attn.attn_decode(p["mixer"], cfg, cache, h, pos)
    return _ff_decode(p, cfg, spec, x_t + y), cache


def _ff_decode(p: PyTree, cfg: ModelConfig, spec: LayerSpec, x_t: torch.Tensor):
    if spec.ff == "mlp":
        return x_t + mlp(p["ff"], rmsnorm(x_t, p["ln2"], cfg.norm_eps))
    return x_t


def _check_paged(spec: LayerSpec) -> None:
    if spec.mixer != "attn":
        raise ValueError(
            f"paged serving supports global-attention mixers only, got {spec.mixer!r}")
    _check_spec(spec)


def layer_paged_decode(p: PyTree, cfg: ModelConfig, spec: LayerSpec, cache: PyTree,
                       x_t: torch.Tensor, lengths: torch.Tensor, tables: torch.Tensor,
                       *, backend: str = "auto"):
    """Paged twin of :func:`layer_decode` — global-attention mixers only
    (paging a ring buffer or an O(1) recurrent state buys nothing)."""
    _check_paged(spec)
    h = rmsnorm(x_t, p["ln1"], cfg.norm_eps)
    y, cache = attn.paged_attn_decode(p["mixer"], cfg, cache, h, lengths, tables,
                                      backend=backend)
    return _ff_decode(p, cfg, spec, x_t + y), cache


def layer_paged_prefill(p: PyTree, cfg: ModelConfig, spec: LayerSpec, cache: PyTree,
                        x: torch.Tensor, start: int, table_row: torch.Tensor,
                        n_valid: int, *, backend: str = "auto"):
    """Paged twin of :func:`layer_train` for one request's prompt chunk."""
    _check_paged(spec)
    h = rmsnorm(x, p["ln1"], cfg.norm_eps)
    y, cache = attn.paged_attn_prefill_chunk(p["mixer"], cfg, cache, h, start,
                                             table_row, n_valid, backend=backend)
    return _ff_decode(p, cfg, spec, x + y), cache


def init_layer_paged_cache(cfg: ModelConfig, spec: LayerSpec, npage: int,
                           page_size: int, dtype, *, quantized: bool = False,
                           device=None):
    _check_paged(spec)
    return attn.init_paged_attn_cache(cfg, npage, page_size, dtype,
                                      quantized=quantized, device=device)


def init_layer_cache(cfg: ModelConfig, spec: LayerSpec, B: int, max_len: int, dtype,
                     device=None):
    _check_spec(spec)
    return attn.init_attn_cache(cfg, B, max_len, dtype=dtype, device=device)


# ---------------------------------------------------------------------------
# prefill-cache helpers
# ---------------------------------------------------------------------------


def _pad_time(t: torch.Tensor, L: int) -> torch.Tensor:
    """Pad axis 1 (time) with zeros up to L (or cut it to L)."""
    S = t.shape[1]
    if S >= L:
        return t[:, :L]
    pad = [0, 0] * (t.dim() - 2) + [0, L - S]
    return torch.nn.functional.pad(t, pad)


def _attn_cache_from_prefill(p, cfg, h, positions, cache_len):
    """Recompute the k/v projections (cheap) and lay them out as the decode
    cache."""
    _, k, v = attn._qkv(p, cfg, h, positions)
    return {"k": _pad_time(k, cache_len), "v": _pad_time(v, cache_len)}

"""Layer assembly: (pre-norm mixer + residual) ∘ (pre-norm FF + residual) —
port of ``repro.models.blocks`` for the attention families: global and
sliding-window GQA and MLA mixers, MLP and MoE feed-forwards. Training
(optionally returning the serving cache, so prefill is one forward pass:
the full cache for global attention, the ring for sliding-window layers,
the latent cache for MLA), dense-cache decode, and the paged twins of both
for the serving engine (global attention only, as in the reference).

The recurrent mixers (RG-LRU, mLSTM, sLSTM) are the next slice of the port
(ROADMAP A4c) and raise ``NotImplementedError``.
"""

from __future__ import annotations

from typing import Any

import torch

from . import attention as attn
from . import moe as moe_mod
from .config import LayerSpec, ModelConfig
from .layers import init_mlp, init_rmsnorm, mlp, rmsnorm

PyTree = Any

_RECURRENT = ("rglru", "mlstm", "slstm")


def _refuse(mixer: str):
    if mixer in _RECURRENT:
        raise NotImplementedError(
            f"the {mixer} mixer is not ported yet: the recurrent families are the "
            "next slice of the port (ROADMAP A4c)")
    raise ValueError(mixer)


def init_layer(gen, cfg: ModelConfig, spec: LayerSpec, dtype, device) -> PyTree:
    p: dict[str, Any] = {"ln1": init_rmsnorm(cfg.d_model, dtype, device)}
    if spec.mixer in ("attn", "attn_local"):
        p["mixer"] = attn.init_attn(gen, cfg, dtype, device)
    elif spec.mixer == "mla":
        p["mixer"] = attn.init_mla(gen, cfg, dtype, device)
    else:
        _refuse(spec.mixer)
    if spec.ff == "mlp":
        p["ln2"] = init_rmsnorm(cfg.d_model, dtype, device)
        p["ff"] = init_mlp(gen, cfg.d_model, cfg.d_ff, dtype, device)
    elif spec.ff == "moe":
        p["ln2"] = init_rmsnorm(cfg.d_model, dtype, device)
        p["ff"] = moe_mod.init_moe(gen, cfg, dtype, device)
    return p


def layer_train(p: PyTree, cfg: ModelConfig, spec: LayerSpec, x: torch.Tensor,
                positions: torch.Tensor, *, want_cache: bool = False,
                cache_len: int | None = None):
    """→ (x', aux_loss, cache-or-None)."""
    h = rmsnorm(x, p["ln1"], cfg.norm_eps)
    cache = None
    cache_len = cache_len or x.shape[1]
    if spec.mixer in ("attn", "attn_local"):
        local = spec.mixer == "attn_local"
        y = attn.attn_train(p["mixer"], cfg, h, positions, local=local,
                            chunk=cfg.attn_chunk)
        if want_cache:
            cache = _attn_cache_from_prefill(p["mixer"], cfg, h, positions, local,
                                             cache_len)
    elif spec.mixer == "mla":
        y = attn.mla_train(p["mixer"], cfg, h, positions, chunk=cfg.attn_chunk)
        if want_cache:
            cache = _mla_cache_from_prefill(p["mixer"], cfg, h, positions, cache_len)
    else:
        _refuse(spec.mixer)
    x = x + y
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    if spec.ff == "mlp":
        x = x + mlp(p["ff"], rmsnorm(x, p["ln2"], cfg.norm_eps))
    elif spec.ff == "moe":
        y, aux = moe_mod.moe_ff(p["ff"], cfg, rmsnorm(x, p["ln2"], cfg.norm_eps))
        x = x + y
    return x, aux, cache


def layer_decode(p: PyTree, cfg: ModelConfig, spec: LayerSpec, cache: PyTree,
                 x_t: torch.Tensor, pos: int):
    h = rmsnorm(x_t, p["ln1"], cfg.norm_eps)
    if spec.mixer in ("attn", "attn_local"):
        y, cache = attn.attn_decode(p["mixer"], cfg, cache, h, pos,
                                    local=spec.mixer == "attn_local")
    elif spec.mixer == "mla":
        y, cache = attn.mla_decode(p["mixer"], cfg, cache, h, pos)
    else:
        _refuse(spec.mixer)
    return _ff_decode(p, cfg, spec, x_t + y), cache


def _ff_decode(p: PyTree, cfg: ModelConfig, spec: LayerSpec, x_t: torch.Tensor):
    if spec.ff == "mlp":
        return x_t + mlp(p["ff"], rmsnorm(x_t, p["ln2"], cfg.norm_eps))
    if spec.ff == "moe":
        y, _ = moe_mod.moe_ff(p["ff"], cfg, rmsnorm(x_t, p["ln2"], cfg.norm_eps))
        return x_t + y
    return x_t


def _check_paged(spec: LayerSpec) -> None:
    if spec.mixer != "attn":
        raise ValueError(
            f"paged serving supports global-attention mixers only, got {spec.mixer!r}")


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
    if spec.mixer in ("attn", "attn_local"):
        return attn.init_attn_cache(cfg, B, max_len, local=spec.mixer == "attn_local",
                                    dtype=dtype, device=device)
    if spec.mixer == "mla":
        return attn.init_mla_cache(cfg, B, max_len, dtype, device)
    _refuse(spec.mixer)


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


def _attn_cache_from_prefill(p, cfg, h, positions, local, cache_len):
    """Recompute the k/v projections (cheap) and lay them out as the decode
    cache: padded to ``cache_len``, or for a sliding-window layer the last
    min(L, S) positions at their ring slots ``pos % L``."""
    _, k, v = attn._qkv(p, cfg, h, positions)
    if not local:
        return {"k": _pad_time(k, cache_len), "v": _pad_time(v, cache_len)}
    L = min(cfg.window, cache_len)
    T = min(L, k.shape[1])
    slots = (positions[:, -T:] % L).long()
    B = k.shape[0]
    bidx = torch.arange(B, device=k.device)[:, None]
    ring_k = k.new_zeros((B, L, *k.shape[2:]))
    ring_v = v.new_zeros((B, L, *v.shape[2:]))
    ring_k[bidx, slots] = k[:, -T:]
    ring_v[bidx, slots] = v[:, -T:]
    return {"k": ring_k, "v": ring_v}


def _mla_cache_from_prefill(p, cfg, h, positions, cache_len):
    _, _, ckv, k_rope = attn._mla_qkv(p, cfg, h, positions)
    return {"ckv": _pad_time(ckv, cache_len),
            "k_rope": _pad_time(k_rope[:, :, 0, :], cache_len)}

"""Layer assembly: (pre-norm mixer + residual) ∘ (pre-norm FF + residual) —
port of ``repro.models.blocks``: global and sliding-window GQA, MLA and the
recurrent mixers (RG-LRU, mLSTM, sLSTM), MLP and MoE feed-forwards.
Training (optionally returning the serving cache, so prefill is one
forward pass: the full cache for global attention, the ring for
sliding-window layers, the latent cache for MLA, the O(1) state of a
recurrent mixer), dense-cache decode, and the paged twins of both for the
serving engine (global attention only, as in the reference: paging a ring
or a recurrent state buys nothing).

Every function takes ``tp``, the model group (``layers.py``): the layer's
leaves are then this rank's slices, and :func:`_tp_layer` says how each
part runs — GQA on the rank's heads (``attention.tp_plan``), the MLP and
the shared experts tensor-parallel, the MoE experts split over the ranks,
and every other sharded leaf (the norms, MLA, the recurrent mixers)
gathered on use. Without a group it is the one-rank code, unchanged.
"""

from __future__ import annotations

import functools

import dataclasses
from typing import Any, Callable, NamedTuple

import torch

from repro_torch.roofline.memory import shapes_only

from . import attention as attn
from . import moe as moe_mod
from . import ssm
from .config import LayerSpec, ModelConfig
from .layers import (
    active,
    copy_to_group,
    gather_tree_on_use,
    init_mlp,
    init_rmsnorm,
    mlp_tp,
    reduce_from_group,
    rmsnorm,
)

PyTree = Any

class _Recurrent(NamedTuple):
    init: Callable
    train: Callable
    prefill: Callable  # → (output, the decode state after the sequence)
    decode: Callable
    state: Callable    # the empty decode state


_RECURRENT = {
    "rglru": _Recurrent(ssm.init_rglru, ssm.rglru_train, ssm.rglru_prefill,
                        ssm.rglru_decode, ssm.init_rglru_state),
    "mlstm": _Recurrent(ssm.init_mlstm, ssm.mlstm_train, ssm.mlstm_prefill,
                        ssm.mlstm_decode, ssm.init_mlstm_state),
    "slstm": _Recurrent(ssm.init_slstm, ssm.slstm_train, ssm.slstm_prefill,
                        ssm.slstm_decode, ssm.init_slstm_state),
}


def init_layer(gen, cfg: ModelConfig, spec: LayerSpec, dtype, device) -> PyTree:
    p: dict[str, Any] = {"ln1": init_rmsnorm(cfg.d_model, dtype, device)}
    if spec.mixer in ("attn", "attn_local"):
        p["mixer"] = attn.init_attn(gen, cfg, dtype, device)
    elif spec.mixer == "mla":
        p["mixer"] = attn.init_mla(gen, cfg, dtype, device)
    elif spec.mixer in _RECURRENT:
        p["mixer"] = _RECURRENT[spec.mixer].init(gen, cfg, dtype, device)
    else:
        raise ValueError(spec.mixer)
    if spec.ff == "mlp":
        p["ln2"] = init_rmsnorm(cfg.d_model, dtype, device)
        p["ff"] = init_mlp(gen, cfg.d_model, cfg.d_ff, dtype, device)
    elif spec.ff == "moe":
        p["ln2"] = init_rmsnorm(cfg.d_model, dtype, device)
        p["ff"] = moe_mod.init_moe(gen, cfg, dtype, device)
    return p


@functools.lru_cache(maxsize=None)
@shapes_only()
def layer_meta(cfg: ModelConfig, spec: LayerSpec) -> PyTree:
    """One layer's whole leaves as meta tensors (their shapes)."""
    return init_layer(None, cfg, spec, torch.float32, "meta")


class _TP(NamedTuple):
    """How a layer runs on a model group: its leaves as the mixer and the
    norms use them, the mixer's (per-rank) config, whether the mixer is a
    rank-local stretch (heads split), the FF's whole shapes, the group."""
    p: dict
    mcfg: ModelConfig
    par: bool
    ff_full: Any
    tp: Any


def _tp_layer(p: PyTree, cfg: ModelConfig, spec: LayerSpec, tp) -> _TP:
    if not active(tp):
        return _TP(p, cfg, False, None, tp)
    full = layer_meta(cfg, spec)
    q = {k: gather_tree_on_use(p[k], full[k], tp) for k in ("ln1", "ln2") if k in p}
    if spec.mixer in ("attn", "attn_local"):
        q["mixer"], mcfg, par = attn.tp_plan(p["mixer"], cfg, full["mixer"], tp)
    else:
        q["mixer"], mcfg, par = gather_tree_on_use(p["mixer"], full["mixer"], tp), cfg, False
    if "ff" in p:
        q["ff"] = p["ff"]
    return _TP(q, mcfg, par, full.get("ff"), tp)


def _enter(t: _TP, h: torch.Tensor) -> torch.Tensor:
    return copy_to_group(h, t.tp) if t.par else h


def _leave(t: _TP, y: torch.Tensor) -> torch.Tensor:
    return reduce_from_group(y, t.tp) if t.par else y


def layer_train(p: PyTree, cfg: ModelConfig, spec: LayerSpec, x: torch.Tensor,
                positions: torch.Tensor, *, want_cache: bool = False,
                cache_len: int | None = None, tp=None):
    """→ (x', aux_loss, cache-or-None)."""
    t = _tp_layer(p, cfg, spec, tp)
    p, mcfg = t.p, t.mcfg
    h = rmsnorm(x, p["ln1"], cfg.norm_eps)
    cache = None
    cache_len = cache_len or x.shape[1]
    if spec.mixer in ("attn", "attn_local"):
        local = spec.mixer == "attn_local"
        hin = _enter(t, h)
        y = _leave(t, attn.attn_train(p["mixer"], mcfg, hin, positions, local=local,
                                      chunk=cfg.attn_chunk))
        if want_cache:
            cache = _attn_cache_from_prefill(p["mixer"], mcfg, hin, positions, local,
                                             cache_len)
    elif spec.mixer == "mla":
        y = attn.mla_train(p["mixer"], cfg, h, positions, chunk=cfg.attn_chunk)
        if want_cache:
            cache = _mla_cache_from_prefill(p["mixer"], cfg, h, positions, cache_len)
    elif spec.mixer in _RECURRENT:
        # the prefill state: the scan's last element (RG-LRU, sLSTM), or
        # mLSTM's whole-sequence formula (not its chunk carry)
        if want_cache:
            y, cache = _RECURRENT[spec.mixer].prefill(p["mixer"], cfg, h)
        else:
            y = _RECURRENT[spec.mixer].train(p["mixer"], cfg, h)
    else:
        raise ValueError(spec.mixer)
    x = x + y
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    if spec.ff == "mlp":
        x = x + mlp_tp(p["ff"], rmsnorm(x, p["ln2"], cfg.norm_eps), t.ff_full, t.tp)
    elif spec.ff == "moe":
        y, aux = moe_mod.moe_ff(p["ff"], cfg, rmsnorm(x, p["ln2"], cfg.norm_eps),
                                t.tp, t.ff_full)
        x = x + y
    return x, aux, cache


def layer_decode(p: PyTree, cfg: ModelConfig, spec: LayerSpec, cache: PyTree,
                 x_t: torch.Tensor, pos: int, tp=None):
    t = _tp_layer(p, cfg, spec, tp)
    p = t.p
    h = rmsnorm(x_t, p["ln1"], cfg.norm_eps)
    if spec.mixer in ("attn", "attn_local"):
        y, cache = attn.attn_decode(p["mixer"], t.mcfg, cache, _enter(t, h), pos,
                                    local=spec.mixer == "attn_local")
        y = _leave(t, y)
    elif spec.mixer == "mla":
        y, cache = attn.mla_decode(p["mixer"], cfg, cache, h, pos)
    elif spec.mixer in _RECURRENT:
        y, cache = _RECURRENT[spec.mixer].decode(p["mixer"], cfg, cache, h)
    else:
        raise ValueError(spec.mixer)
    return _ff_decode(t, cfg, spec, x_t + y), cache


def _ff_decode(t: _TP, cfg: ModelConfig, spec: LayerSpec, x_t: torch.Tensor):
    p = t.p
    if spec.ff == "mlp":
        return x_t + mlp_tp(p["ff"], rmsnorm(x_t, p["ln2"], cfg.norm_eps), t.ff_full, t.tp)
    if spec.ff == "moe":
        y, _ = moe_mod.moe_ff(p["ff"], cfg, rmsnorm(x_t, p["ln2"], cfg.norm_eps),
                              t.tp, t.ff_full)
        return x_t + y
    return x_t


def _check_paged(spec: LayerSpec) -> None:
    if spec.mixer != "attn":
        raise ValueError(
            f"paged serving supports global-attention mixers only, got {spec.mixer!r}")


def layer_paged_decode(p: PyTree, cfg: ModelConfig, spec: LayerSpec, cache: PyTree,
                       x_t: torch.Tensor, lengths: torch.Tensor, tables: torch.Tensor,
                       *, backend: str = "auto", tp=None):
    """Paged twin of :func:`layer_decode` — global-attention mixers only
    (paging a ring buffer or an O(1) recurrent state buys nothing)."""
    _check_paged(spec)
    t = _tp_layer(p, cfg, spec, tp)
    h = rmsnorm(x_t, t.p["ln1"], cfg.norm_eps)
    y, cache = attn.paged_attn_decode(t.p["mixer"], t.mcfg, cache, _enter(t, h), lengths,
                                      tables, backend=backend)
    return _ff_decode(t, cfg, spec, x_t + _leave(t, y)), cache


def layer_paged_prefill(p: PyTree, cfg: ModelConfig, spec: LayerSpec, cache: PyTree,
                        x: torch.Tensor, start: int, table_row: torch.Tensor,
                        n_valid: int, *, backend: str = "auto", tp=None):
    """Paged twin of :func:`layer_train` for one request's prompt chunk."""
    _check_paged(spec)
    t = _tp_layer(p, cfg, spec, tp)
    h = rmsnorm(x, t.p["ln1"], cfg.norm_eps)
    y, cache = attn.paged_attn_prefill_chunk(t.p["mixer"], t.mcfg, cache, _enter(t, h),
                                             start, table_row, n_valid, backend=backend)
    return _ff_decode(t, cfg, spec, x + _leave(t, y)), cache


def cache_cfg(cfg: ModelConfig, spec: LayerSpec, m: int) -> ModelConfig:
    """The config a layer's serving cache is laid out by on a model group of
    m ranks, as ``attention.tp_plan`` runs the layer: a GQA layer whose H
    and KV heads split holds its H/m heads' KV/m heads; one whose query
    heads split but KV heads do not holds the KV of each of its H/m query
    heads (the expanded layout ``tp_plan`` computes); one whose query heads
    do not split runs whole and holds the whole cache, as every other mixer
    does."""
    if m == 1 or spec.mixer not in ("attn", "attn_local") or cfg.num_heads % m:
        return cfg
    hl = cfg.num_heads // m
    return dataclasses.replace(cfg, num_heads=hl,
                               num_kv_heads=hl if cfg.num_kv_heads % m else cfg.num_kv_heads // m,
                               head_dim=cfg.resolved_head_dim)


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
    if spec.mixer in _RECURRENT:  # O(1): independent of max_len
        return _RECURRENT[spec.mixer].state(cfg, B, dtype, device)
    raise ValueError(spec.mixer)


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

"""The language model: init / train forward / loss / prefill / decode_step /
the paged serving steps — port of ``repro.models.model`` for the attention
families.

The parameter tree has the reference's leaves and shapes: each segment
position holds its layers' weights stacked over a leading ``repeat`` axis
(``model.py:57-68`` of the reference), and a multi-token-prediction head
sits under ``mtp`` (``proj``, ``layer``, ``norm``), so a flat layout built
from either package places every leaf at the same offset. The caches keep
the reference's layout too — a list per segment, a list per period
position, leaves with a leading ``repeat`` axis (``(repeat, npage, P, KV,
hd)`` for a page pool) — so ``convert.params_from_jax`` carries a JAX cache
across unchanged. The serving functions write the cache in place and
return it. ``remat`` maps to ``torch.utils.checkpoint`` (training only).
Supports token inputs with an optional continuous ``prefix_embed`` (a
frontend's output) before them, rotary or sinusoidal positions, tied or
untied unembedding, the MoE load-balance losses summed over the layers, and
DeepSeek-V3's MTP loss term.
"""

from __future__ import annotations

from typing import Any

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from repro_torch.core.tree_util import tree_leaves, tree_map
from repro_torch.device import default_device

from .blocks import (
    init_layer,
    init_layer_cache,
    init_layer_paged_cache,
    layer_decode,
    layer_paged_decode,
    layer_paged_prefill,
    layer_train,
)
from .config import ModelConfig
from .layers import (
    _normal,
    embed,
    init_embedding,
    init_rmsnorm,
    rmsnorm,
    sinusoidal_pos,
    unembed,
)

PyTree = Any


def init_params(seed: int, cfg: ModelConfig, dtype=torch.float32,
                device=None) -> PyTree:
    """Random parameters from ``seed`` (a ``torch.Generator`` on the target
    device). ``device="meta"`` builds the shapes only. A segment position's
    layers are drawn one at a time into their stacked tensors, so the peak
    holds one layer more than the model."""
    device = default_device(device)
    gen = None if device.type == "meta" else torch.Generator(device=device).manual_seed(seed)
    params: dict[str, Any] = {
        "embed": init_embedding(gen, cfg.vocab_size, cfg.d_model, dtype, device),
        "final_norm": init_rmsnorm(cfg.d_model, dtype, device),
    }
    if not cfg.tie_embeddings:
        params["lm_head"] = init_embedding(gen, cfg.vocab_size, cfg.d_model, dtype, device)
    segs = []
    for seg in cfg.segments:
        pos_params = []
        for spec in seg.period:
            stacked = None
            for r in range(seg.repeat):
                layer = init_layer(gen, cfg, spec, dtype, device)
                if seg.repeat == 1:  # a view: no copy
                    stacked = tree_map(lambda t: t[None], layer)
                    break
                if stacked is None:
                    stacked = tree_map(lambda t: t.new_empty((seg.repeat, *t.shape)), layer)
                tree_map(lambda dst, t: dst[r].copy_(t), stacked, layer)
                del layer
            pos_params.append(stacked)
        segs.append(pos_params)
    params["segments"] = segs
    if cfg.mtp_depth > 0:
        mtp_spec = cfg.segments[-1].period[-1]
        params["mtp"] = {
            "proj": _normal(gen, (2 * cfg.d_model, cfg.d_model), 0.02, dtype, device),
            "layer": init_layer(gen, cfg, mtp_spec, dtype, device),
            "norm": init_rmsnorm(cfg.d_model, dtype, device),
        }
    return params


def _stack_trees(trees: list) -> PyTree:
    if trees[0] is None:
        return None
    if isinstance(trees[0], dict):
        return {k: _stack_trees([t[k] for t in trees]) for k in trees[0]}
    return torch.stack(trees)


def _slice(tree: PyTree, r: int) -> PyTree:
    if isinstance(tree, dict):
        return {k: _slice(v, r) for k, v in tree.items()}
    return tree[r]


def _embed_inputs(params: PyTree, cfg: ModelConfig, tokens: torch.Tensor,
                  prefix_embed: torch.Tensor | None):
    """Token embeddings after the prefix, positions 0 … P+S−1 over both, and
    the sinusoids added where the config has them."""
    x = embed(params["embed"], tokens)
    if prefix_embed is not None:
        x = torch.cat([prefix_embed.to(x.dtype), x], dim=1)
    B, S, _ = x.shape
    positions = torch.arange(S, dtype=torch.int32, device=x.device).expand(B, S)
    if cfg.pos_emb == "sinusoidal":
        x = x + sinusoidal_pos(positions, cfg.d_model).to(x.dtype)
    return x, positions


def forward(params: PyTree, cfg: ModelConfig, tokens: torch.Tensor,
            prefix_embed: torch.Tensor | None = None, *,
            want_cache: bool = False, cache_len: int | None = None,
            last_logits_only: bool = False):
    """→ (logits (B,S,V) or (B,1,V), aux_loss, cache-or-None, hidden (B,S,d)).

    ``prefix_embed`` (B, P, d) goes before the tokens' embeddings, and
    positions run 0 … P+S−1 over both. ``last_logits_only`` computes the
    unembedding for the final position only (the serving prefill)."""
    x, positions = _embed_inputs(params, cfg, tokens, prefix_embed)
    aux_total = torch.zeros((), dtype=torch.float32, device=x.device)
    use_remat = cfg.remat and not want_cache and torch.is_grad_enabled()

    def apply_layer(pp, spec, x_c):
        kw = dict(want_cache=want_cache, cache_len=cache_len)
        if use_remat:
            return checkpoint(layer_train, pp, cfg, spec, x_c, positions,
                              use_reentrant=False, **kw)
        return layer_train(pp, cfg, spec, x_c, positions, **kw)

    caches = []
    for seg, pos_params in zip(cfg.segments, params["segments"]):
        per_pos = [[] for _ in seg.period]
        for r in range(seg.repeat):
            for i, (spec, pp) in enumerate(zip(seg.period, pos_params)):
                x, aux, cache = apply_layer(_slice(pp, r), spec, x)
                aux_total = aux_total + aux
                per_pos[i].append(cache)
        caches.append([_stack_trees(c) if want_cache else None for c in per_pos])

    x = rmsnorm(x, params["final_norm"], cfg.norm_eps)
    logits = _logits(params, cfg, x[:, -1:, :] if last_logits_only else x)
    return logits, aux_total, (caches if want_cache else None), x


def _logits(params: PyTree, cfg: ModelConfig, x: torch.Tensor) -> torch.Tensor:
    table = params["embed"] if cfg.tie_embeddings else params["lm_head"]
    logits = unembed(table, x)
    if cfg.logit_softcap > 0:
        logits = cfg.logit_softcap * torch.tanh(logits / cfg.logit_softcap)
    return logits


def lm_loss(params: PyTree, cfg: ModelConfig, tokens: torch.Tensor,
            prefix_embed: torch.Tensor | None = None) -> torch.Tensor:
    """Next-token cross-entropy over token positions, the prefix excluded,
    + the MoE aux loss + the MTP term (0.3 × its NLL + its aux)."""
    logits, aux, _, hidden = forward(params, cfg, tokens, prefix_embed)
    P = 0 if prefix_embed is None else prefix_embed.shape[1]
    pred = logits[:, P:-1]
    tgt = tokens[:, 1:].long()
    loss = _nll(pred, tgt) + aux
    if cfg.mtp_depth > 0 and tokens.shape[1] > 2:
        # DeepSeek-V3-style MTP: hidden_t with embed(token_{t+1}) predicts
        # token_{t+2} through one extra layer
        h_in = hidden[:, P:, :][:, :-2, :]
        e_next = embed(params["embed"], tokens[:, 1:-1])
        z = torch.cat([h_in, e_next], dim=-1) @ params["mtp"]["proj"]
        B, S2, _ = z.shape
        positions = torch.arange(S2, dtype=torch.int32, device=z.device).expand(B, S2)
        spec = cfg.segments[-1].period[-1]
        z, mtp_aux, _ = layer_train(params["mtp"]["layer"], cfg, spec, z, positions)
        z = rmsnorm(z, params["mtp"]["norm"], cfg.norm_eps)
        table = params["embed"] if cfg.tie_embeddings else params["lm_head"]
        loss = loss + 0.3 * _nll(unembed(table, z), tokens[:, 2:].long()) + mtp_aux
    return loss


def _nll(logits: torch.Tensor, tgt: torch.Tensor) -> torch.Tensor:
    logp = F.log_softmax(logits.float(), dim=-1)
    return torch.mean(-torch.gather(logp, -1, tgt[..., None])[..., 0])


# ---------------------------------------------------------------------------
# serving
# ---------------------------------------------------------------------------


def _layers(params: PyTree, cfg: ModelConfig, cache: PyTree):
    """(spec, layer params, layer cache) in layer order: slices of the
    stacked trees, so an in-place write to a layer's cache lands in ``cache``."""
    for seg, pos_params, seg_cache in zip(cfg.segments, params["segments"], cache):
        for r in range(seg.repeat):
            for spec, pp, c in zip(seg.period, pos_params, seg_cache):
                yield spec, _slice(pp, r), _slice(c, r)


def _cache_tree(cfg: ModelConfig, make_one) -> PyTree:
    return [[tree_map(lambda t, n=seg.repeat: t[None].repeat(n, *([1] * t.dim())),
                      make_one(spec)) for spec in seg.period] for seg in cfg.segments]


def init_cache(cfg: ModelConfig, B: int, max_len: int, dtype=torch.float32,
               device=None) -> PyTree:
    """Dense decode caches: (repeat, B, max_len, KV, hd) leaves."""
    device = default_device(device)
    return _cache_tree(cfg, lambda spec: init_layer_cache(cfg, spec, B, max_len, dtype,
                                                          device))


def prefill(params: PyTree, cfg: ModelConfig, tokens: torch.Tensor,
            prefix_embed: torch.Tensor | None = None, *, max_len: int | None = None,
            last_logits_only: bool = False):
    """Serve prefill: one forward pass that also lays out the decode cache,
    sized for ``max_len`` positions. Returns (last logits (B,V), cache)."""
    logits, _, cache, _ = forward(params, cfg, tokens, prefix_embed, want_cache=True,
                                  cache_len=max_len, last_logits_only=last_logits_only)
    return logits[:, -1, :], cache


def decode_step(params: PyTree, cfg: ModelConfig, cache: PyTree, token_t: torch.Tensor,
                pos: int):
    """One serve step: token_t (B,) at absolute position ``pos``, attending
    to the cache. Returns (logits (B,V), cache)."""
    x = embed(params["embed"], token_t[:, None])
    if cfg.pos_emb == "sinusoidal":
        p = torch.full((x.shape[0], 1), pos, dtype=torch.int32, device=x.device)
        x = x + sinusoidal_pos(p, cfg.d_model).to(x.dtype)
    for spec, pp, c in _layers(params, cfg, cache):
        x, _ = layer_decode(pp, cfg, spec, c, x, pos)
    x = rmsnorm(x, params["final_norm"], cfg.norm_eps)
    return _logits(params, cfg, x)[:, 0, :], cache


def init_paged_cache(cfg: ModelConfig, npage: int, page_size: int, dtype=torch.float32,
                     *, quantized: bool = False, device=None) -> PyTree:
    """Per-layer KV page pools with (repeat, npage, P, KV, hd) leaves: every
    layer owns its pool, all layers share ONE block table (core/paging.py).
    Global-attention mixers only; page 0 is the reserved null page."""
    device = default_device(device)
    return _cache_tree(cfg, lambda spec: init_layer_paged_cache(
        cfg, spec, npage, page_size, dtype, quantized=quantized, device=device))


def _ids(ids, device) -> torch.Tensor:
    return torch.as_tensor(ids, device=device).long()


def _pool_device(cache: PyTree) -> torch.device:
    return tree_leaves(cache)[0].device


def paged_copy_pages(cache: PyTree, src, dst) -> PyTree:
    """Copy pool pages ``src[i] → dst[i]`` in every layer's pool (the COW
    split), in place: the gather of the sources completes before the write.
    ``src`` / ``dst`` are fixed-width (W,) vectors padded with the null page
    (padded lanes copy page 0 onto itself)."""
    dev = _pool_device(cache)
    src, dst = _ids(src, dev), _ids(dst, dev)

    def copy(leaf):
        leaf[:, dst] = leaf[:, src]
        return leaf

    return tree_map(copy, cache)


def paged_gather_pages(cache: PyTree, ids) -> PyTree:
    """Snapshot pool pages ``ids`` ((W,), null-padded) of every layer's pool
    to host memory — the swap-out half of preemption: (repeat, W, ...)
    leaves on the CPU."""
    ids = _ids(ids, _pool_device(cache))
    return tree_map(lambda leaf: leaf[:, ids].cpu(), cache)


def paged_scatter_pages(cache: PyTree, ids, snap: PyTree) -> PyTree:
    """Write a :func:`paged_gather_pages` snapshot back into pages ``ids`` —
    the resume half of preemption (fresh pages, identical content). Padded
    lanes write the null page."""
    ids = _ids(ids, _pool_device(cache))

    def scatter(leaf, s):
        leaf[:, ids] = s.to(device=leaf.device, dtype=leaf.dtype)
        return leaf

    return tree_map(scatter, cache, snap)


def paged_decode_step(params: PyTree, cfg: ModelConfig, cache: PyTree,
                      token_t: torch.Tensor, lengths: torch.Tensor, tables: torch.Tensor,
                      *, backend: str = "auto"):
    """One continuous-batching decode step: slot s's token at position
    ``lengths[s]`` (idle slots carry length 0 and null tables; their logits
    are garbage the scheduler ignores). Returns (logits (S,V), cache)."""
    x = embed(params["embed"], token_t[:, None])
    if cfg.pos_emb == "sinusoidal":
        x = x + sinusoidal_pos(lengths[:, None].to(torch.int32), cfg.d_model).to(x.dtype)
    for spec, pp, c in _layers(params, cfg, cache):
        x, _ = layer_paged_decode(pp, cfg, spec, c, x, lengths, tables, backend=backend)
    x = rmsnorm(x, params["final_norm"], cfg.norm_eps)
    return _logits(params, cfg, x)[:, 0, :], cache


def paged_prefill_chunk(params: PyTree, cfg: ModelConfig, cache: PyTree,
                        tokens: torch.Tensor, start: int, table_row: torch.Tensor,
                        n_valid: int, *, backend: str = "auto"):
    """One chunked-prefill dispatch for ONE request: tokens (1, C) are prompt
    positions [start, start+C), the first ``n_valid`` real; table_row
    (max_pages,) int32. Writes their k/v rows into the request's pages and
    attends causally over its whole cached prefix. Returns (logits (V,) at
    the chunk's last valid position, cache)."""
    x = embed(params["embed"], tokens)
    if cfg.pos_emb == "sinusoidal":
        pos = (start + torch.arange(tokens.shape[1], dtype=torch.int32,
                                    device=x.device))[None]
        x = x + sinusoidal_pos(pos, cfg.d_model).to(x.dtype)
    for spec, pp, c in _layers(params, cfg, cache):
        x, _ = layer_paged_prefill(pp, cfg, spec, c, x, start, table_row, n_valid,
                                   backend=backend)
    x = rmsnorm(x, params["final_norm"], cfg.norm_eps)
    return _logits(params, cfg, x[:, n_valid - 1:n_valid, :])[0, 0], cache


def param_count(params: PyTree) -> int:
    return sum(x.numel() for x in tree_leaves(params))

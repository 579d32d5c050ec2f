"""The language model: init / train forward / loss — port of the dense
training path of ``repro.models.model``.

The parameter tree has the reference's leaves and shapes: each segment
position holds its layers' weights stacked over a leading ``repeat`` axis
(``model.py:57-68`` of the reference), so a flat layout built from either
package places every leaf at the same offset. ``remat`` maps to
``torch.utils.checkpoint``. Multi-token prediction, prefix embeddings and
the decode / serving paths are not ported yet.
"""

from __future__ import annotations

from typing import Any

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from repro_torch.device import default_device

from .blocks import init_layer, layer_train
from .config import ModelConfig
from .layers import embed, init_embedding, init_rmsnorm, rmsnorm, unembed

PyTree = Any


def init_params(seed: int, cfg: ModelConfig, dtype=torch.float32,
                device=None) -> PyTree:
    """Random parameters from ``seed`` (a ``torch.Generator`` on the target
    device). ``device="meta"`` builds the shapes only."""
    device = default_device(device)
    gen = None if device.type == "meta" else torch.Generator(device=device).manual_seed(seed)
    if cfg.mtp_depth > 0 or cfg.frontend is not None or cfg.pos_emb == "sinusoidal":
        raise NotImplementedError("MTP heads, frontends and sinusoidal positions "
                                  "are not ported yet")
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
            stack = [init_layer(gen, cfg, spec, dtype, device) for _ in range(seg.repeat)]
            pos_params.append(_stack_trees(stack))
        segs.append(pos_params)
    params["segments"] = segs
    return params


def _stack_trees(trees: list) -> PyTree:
    if isinstance(trees[0], dict):
        return {k: _stack_trees([t[k] for t in trees]) for k in trees[0]}
    return torch.stack(trees)


def _slice(tree: PyTree, r: int) -> PyTree:
    if isinstance(tree, dict):
        return {k: _slice(v, r) for k, v in tree.items()}
    return tree[r]


def forward(params: PyTree, cfg: ModelConfig, tokens: torch.Tensor):
    """→ (logits (B,S,V), aux_loss, hidden (B,S,d))."""
    x = embed(params["embed"], tokens)
    B, S, _ = x.shape
    positions = torch.arange(S, dtype=torch.int32, device=x.device).expand(B, S)
    aux_total = torch.zeros((), dtype=torch.float32, device=x.device)

    def apply_layer(pp, spec, x_c):
        if cfg.remat and torch.is_grad_enabled():
            return checkpoint(layer_train, pp, cfg, spec, x_c, positions,
                              use_reentrant=False)
        return layer_train(pp, cfg, spec, x_c, positions)

    for seg, pos_params in zip(cfg.segments, params["segments"]):
        for r in range(seg.repeat):
            for spec, pp in zip(seg.period, pos_params):
                x, aux = apply_layer(_slice(pp, r), spec, x)
                aux_total = aux_total + aux

    x = rmsnorm(x, params["final_norm"], cfg.norm_eps)
    table = params["embed"] if cfg.tie_embeddings else params["lm_head"]
    logits = unembed(table, x)
    if cfg.logit_softcap > 0:
        logits = cfg.logit_softcap * torch.tanh(logits / cfg.logit_softcap)
    return logits, aux_total, x


def lm_loss(params: PyTree, cfg: ModelConfig, tokens: torch.Tensor) -> torch.Tensor:
    """Next-token cross-entropy over token positions (+ aux loss)."""
    logits, aux, _ = forward(params, cfg, tokens)
    pred = logits[:, :-1]
    tgt = tokens[:, 1:].long()
    logp = F.log_softmax(pred.float(), dim=-1)
    nll = -torch.gather(logp, -1, tgt[..., None])[..., 0]
    return torch.mean(nll) + aux


def param_count(params: PyTree) -> int:
    from repro_torch.core.tree_util import tree_leaves

    return sum(x.numel() for x in tree_leaves(params))

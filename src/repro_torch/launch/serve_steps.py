"""Serving round assembly: the prefill / decode steps of a MARINA-trained
model on the mesh (port of ``repro.launch.serve_steps``; ``launch/serve.py``
drives the single-process engine, ``launch/distributed.py`` the training
rounds).

GSPMD has no counterpart here, so the bundles choose one placement and
state it. The batch's rows (dense) or the engine's slots (paged) split over
the worker groups where ``sharding.serve_batch_axes`` finds axes that divide
them, as :meth:`Mesh.workers` splits workers (contiguous, one group a
worker group); where none does, every group computes every row. Where the
model axis spans ranks (``Mesh.model`` = m > 1) the parameters are this
rank's slices (``sharding.shard_tree``), a GQA layer runs its H/m heads on
its KV/m heads' share of the cache or pool (``cache_leaf_spec``'s split of
the KV-head dimension; an int8 pool's scales go with their codes), every
other layer's cache is held whole, and the logits are vocabulary-parallel.
An fsdp arch serves on a mesh laid out for it (``make_mesh(...,
fsdp=True)``: ``Mesh.fsdp`` = D > 1) on any mesh whose "data" axis spans
ranks, the single-pod mesh included, as the reference shards its serving
parameters over "data" wherever the mesh has it: a rank holds the data
split of every ``F`` leaf too, gathered on use one layer at a time,
forward only. The rows (slots) then split over the worker groups and the
data ranks as ``serve_batch_axes`` finds them dividing ("pod", then
"data"): a rank computes its own rows (``layers.RowSplit``, the MoE
dispatch over the data group's rows), and its outputs cross the data group
(``fsdp/...`` kinds) before the worker groups. Where "data" does not
divide them the data ranks compute the same rows. Each step takes the
GLOBAL inputs on every rank.

* Dense (``build_serve_steps``): a worker group prefills and decodes its
  own rows and holds their cache rows (the reference's batch-sharded
  cache); the logits are gathered over the vocabulary (kind
  ``model/logits``) and the rows all-gathered (kind ``logits``), so every
  rank returns all B rows of all V.
* Paged (``build_paged_serve_steps``): every worker group holds the whole
  page pool (its model rank's heads of it). A decode step runs the group's
  slots (its writes land in its own pool), samples their tokens, and then
  all-gathers the tokens (kind ``tokens``) and the K/V rows each slot wrote
  — one row of every layer's pool, in the pool's own dtype: int8 codes and
  their f32 scales on int8 pages, every layer's in one exchange (kind
  ``kv_rows``) — and writes the other groups' rows into its pool, so the
  pools stay equal across the groups. A
  prefill chunk (one request) runs on every group and moves nothing over
  the worker axis. Sampling: the first index of the largest logit at
  ``temperature`` 0, else ``prng.categorical`` on logits × float32(1/T)
  (the paged steps' rule, ``serve.scale_logits``), whose Gumbel noise each
  rank draws for the whole (slots, V) block under the step's key and slices
  to its slots (and vocabulary range), so the tokens do not depend on the
  split. Over vocabulary-parallel logits each model rank takes its range's
  best (value, global index) and the group keeps the largest, ties to the
  lowest global index (kind ``model/pick``). On a mesh with no group these
  are the single-process engine's steps (``serve.build_paged_steps``).

The builders take no ``multi_pod``: the reference's is read nowhere. The
mesh counts what these exchanges carry (``Mesh.payload_bytes``). The
bundles' ``fns`` are plain callables with the reference's names and
arguments; ``meta`` holds the cache's meta shapes (``cache_shapes``, this
rank's) and the rows this rank computes (``rows``).
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch import prng
from repro_torch.core.tree_util import tree_flatten, tree_flatten_with_path
from repro_torch.launch import sharding as shd
from repro_torch.launch.serve import engine_form, sample, scale_logits
from repro_torch.models import (
    decode_step as model_decode,
    logits_parallel,
    init_cache,
    init_paged_cache,
    init_params,
    paged_decode_step,
    paged_prefill_chunk,
    prefill as model_prefill,
)
from repro_torch.models.layers import RowSplit


def _tp(mesh):
    """The inner groups the steps run on (None: the rank holds the whole
    model)."""
    return mesh if (mesh.model > 1 or mesh.fsdp > 1) else None


def _data_spans(mesh) -> bool:
    """Whether the mesh's "data" axis (of more than one slot) spans ranks."""
    data = mesh.shape.get("data", 1)
    return data > 1 and mesh.world > mesh.size // (data * mesh.shape.get("model", 1))


def _shapes(arch, mesh, dtype) -> tuple:
    """(whole meta shapes, this rank's slices of them): the rule table's
    split, with the data axis where the arch is fsdp."""
    cfg = arch.model
    param_shapes = init_params(0, cfg, dtype, device="meta")
    if mesh.fsdp > 1 and not arch.fsdp:
        raise ValueError(f"a mesh laid out for fsdp, but {cfg.name!r} is not an fsdp arch")
    if arch.fsdp and mesh.fsdp == 1 and _data_spans(mesh):
        raise ValueError(f"{cfg.name!r} splits its serving parameters over \"data\": lay the "
                         "mesh out for fsdp (make_mesh(..., fsdp=True))")
    return param_shapes, shd.shard_tree(param_shapes, mesh, arch.fsdp)


def _whole_logits(mesh, params, cfg, logits: torch.Tensor) -> torch.Tensor:
    """All V logits from this rank's vocabulary slice."""
    if logits_parallel(params, cfg, _tp(mesh)):
        return mesh.model_gather(logits, -1, kind="model/logits")
    return logits


def _rows(mesh, B: int) -> tuple:
    """(the rows (slots) of a batch of B this rank computes, whether the
    data group splits them, whether their outputs cross the worker groups).
    The worker groups cross on one rank too, whenever the mesh has a group
    and the groups split the batch; not where every group computes every
    row. On an fsdp mesh the rows are the reference's ``serve_batch_axes``
    blocks, "pod" major: block g·d + j of the g-th worker group's j-th data
    rank."""
    axes = shd.serve_batch_axes(mesh, B) or ()
    if mesh.fsdp == 1:
        rows = mesh.workers(B) if axes else range(B)
        return rows, False, mesh.group is not None and len(rows) * mesh.world == B
    g = mesh.world if "pod" in axes else 1
    d = mesh.fsdp if "data" in axes else 1
    per = B // (g * d)
    at = (mesh.rank if g > 1 else 0) * d + (mesh.fsdp_rank if d > 1 else 0)
    return range(at * per, (at + 1) * per), d > 1, mesh.group is not None and "pod" in axes


def _gather_out(mesh, x: torch.Tensor, B: int, over_data: bool, over_groups: bool,
                kind: str) -> torch.Tensor:
    """All B rows of an output from this rank's rows: over the data group
    (kind ``fsdp/<kind>``), then over the worker groups (``kind``)."""
    if over_data:
        x = mesh.fsdp_gather(x.contiguous(), 0, kind=f"fsdp/{kind}")
    return mesh.gather_rows(x, B, kind=kind) if over_groups else x


def _row_tp(mesh, over_data: bool):
    """The inner groups a step over this rank's rows runs on."""
    return RowSplit(mesh, serving=True) if over_data else _tp(mesh)


def _on(mesh, x, dtype=None) -> torch.Tensor:
    t = x if isinstance(x, torch.Tensor) else torch.from_numpy(np.array(x))
    return t.to(device=mesh.device, dtype=dtype)


def build_serve_steps(arch, mesh, *, batch: int, seq_len: int, mode: str,
                      dtype=torch.bfloat16, last_logits: bool = False):
    """The dense serving steps: ``"prefill"`` (``prefill_step(params, tokens,
    prefix=None)`` → (logits (B, V), this rank's cache rows), the cache
    sized ``seq_len``) or ``"decode"`` (``decode_step(params, cache, token,
    pos)`` → (logits (B, V), cache), the cache updated in place)."""
    from repro_torch.launch.distributed import StepBundle

    cfg = arch.model
    param_shapes, local_shapes = _shapes(arch, mesh, dtype)
    rows, over_data, over_groups = _rows(mesh, batch)
    tp = _row_tp(mesh, over_data)

    def gather(params, logits):
        logits = _whole_logits(mesh, params, cfg, logits)
        return _gather_out(mesh, logits, batch, over_data, over_groups, "logits")

    fns = {}
    if mode == "prefill":
        @torch.inference_mode()
        def prefill_step(params, tokens, prefix=None):
            toks = _on(mesh, tokens)[rows.start:rows.stop]
            pre = None if prefix is None else _on(mesh, prefix)[rows.start:rows.stop]
            logits, cache = model_prefill(params, cfg, toks, pre, max_len=seq_len,
                                          last_logits_only=last_logits, tp=tp)
            return gather(params, logits), cache

        fns["prefill_step"] = prefill_step
        meta = {}
    else:
        @torch.inference_mode()
        def decode_step(params, cache, token, pos):
            tok = _on(mesh, token)[rows.start:rows.stop]
            logits, cache = model_decode(params, cfg, cache, tok, int(pos), tp=tp)
            return gather(params, logits), cache

        fns["decode_step"] = decode_step
        meta = {"cache_shapes": init_cache(cfg, len(rows), seq_len, dtype, device="meta",
                                           model=mesh.model)}
    return StepBundle(mesh=mesh, n_workers=1, param_shapes=param_shapes, fns=fns,
                      meta={**meta, "rows": rows, "fsdp": arch.fsdp},
                      local_shapes=local_shapes)


def _written_rows(leaf: torch.Tensor, pages: torch.Tensor, offs: torch.Tensor) -> torch.Tensor:
    """The (slots, repeat, ...) rows a decode step wrote into one pool leaf
    (repeat, npage, P, ...)."""
    return leaf[:, pages, offs].movedim(1, 0).contiguous()


def paged_step_fns(cfg, mesh, *, temperature: float = 0.0, backend: str = "auto") -> tuple:
    """``(decode, prefill)``: the paged decode step and prefill chunk of
    :func:`build_paged_serve_steps` over GLOBAL inputs, the slots this rank
    computes read off the inputs' slot count. On a mesh without a group
    every slot is this process's and nothing crosses: these are the single-
    process engine's steps too (``serve.build_paged_steps``)."""

    tp = _tp(mesh)

    def pick(params, logits, key, lo: "int | None" = None, hi: "int | None" = None,
             n: "int | None" = None):
        """The tokens of ``logits``: one request's (V,) row, or slots [lo,
        hi) of an (n, V) block, drawn under the block's noise. Over this
        rank's vocabulary slice: its range's best, then the group's."""
        if logits_parallel(params, cfg, tp):
            return _pick_parallel(logits, key, lo, hi, n)
        if temperature == 0 or lo is None:
            return sample(logits, temperature, key, jitted=True)
        noise = prng.gumbel(key, (n, logits.shape[-1]), device=logits.device)
        return torch.argmax(noise[lo:hi] + scale_logits(logits, temperature, jitted=True),
                            dim=-1)

    def _pick_parallel(logits, key, lo, hi, n):
        vl = logits.shape[-1]
        off = mesh.model_rank * vl
        scores = logits
        if temperature > 0:
            shape = (cfg.vocab_size,) if lo is None else (n, cfg.vocab_size)
            noise = prng.gumbel(key, shape, device=logits.device)[..., off:off + vl]
            noise = noise if lo is None else noise[lo:hi]
            scores = noise + scale_logits(logits, temperature, jitted=True)
        idx = torch.argmax(scores, dim=-1, keepdim=True)
        # (value, global index) pairs, exact in float64, in one all-gather
        pair = torch.cat([torch.gather(scores, -1, idx).double(), (idx + off).double()], -1)
        got = mesh.model_gather(pair[..., None, :], -2, kind="model/pick")
        # the first rank holding the largest value: the lowest global index
        best = torch.argmax(got[..., 0], dim=-1, keepdim=True)
        return torch.gather(got[..., 1], -1, best)[..., 0].long()

    @torch.inference_mode()
    def decode_fn(params, cache, token, lens, tbl, key=None):
        token, lens = _on(mesh, token), _on(mesh, lens, torch.int32)
        tbl = _on(mesh, tbl, torch.int32)
        n = token.shape[0]
        rows, over_data, over_groups = _rows(mesh, n)
        lo, hi = rows.start, rows.stop
        # copies, not views: a view of slots [lo, hi) starts lo rows in, and
        # the paged kernel takes 16-byte aligned tensors
        logits, cache = paged_decode_step(params, cfg, cache, token[lo:hi].clone(),
                                          lens[lo:hi].clone(), tbl[lo:hi].clone(),
                                          backend=backend, tp=_row_tp(mesh, over_data))
        toks = pick(params, logits, key, lo, hi, n).to(torch.int32)
        if not (over_data or over_groups):
            return toks, cache
        page_size = tree_flatten(cache)[0][0].shape[2]
        pages = torch.gather(tbl, 1, (lens // page_size).long()[:, None])[:, 0].long()
        offs = (lens % page_size).long()
        others = [s for s in range(n) if s not in rows]
        # every layer's written rows in one exchange: each slot's rows of
        # every pool leaf as bytes, side by side
        leaves = tree_flatten(cache)[0]
        mine = [_written_rows(leaf, pages[lo:hi], offs[lo:hi]) for leaf in leaves]
        got = _gather_out(mesh, torch.cat([w.reshape(hi - lo, -1).view(torch.uint8)
                                           for w in mine], 1), n,
                          over_data, over_groups, "kv_rows")
        if others:
            idx = torch.as_tensor(others, device=got.device)
            off = 0
            for leaf, w in zip(leaves, mine):
                nb = w[:1].numel() * w.element_size()
                rows_w = got[idx, off:off + nb].contiguous().view(w.dtype)
                leaf[:, pages[idx], offs[idx]] = rows_w.reshape(len(others),
                                                                *w.shape[1:]).movedim(0, 1)
                off += nb
        return _gather_out(mesh, toks, n, over_data, over_groups, "tokens"), cache

    @torch.inference_mode()
    def prefill_fn(params, cache, tokens, start, table_row, n_valid, key=None):
        logits, cache = paged_prefill_chunk(params, cfg, cache, _on(mesh, tokens), int(start),
                                            _on(mesh, table_row, torch.int32), int(n_valid),
                                            backend=backend, tp=tp)
        return pick(params, logits, key).to(torch.int32), cache

    return decode_fn, prefill_fn


def build_paged_serve_steps(arch, mesh, *, n_slots: int, npage: int, page_size: int,
                            max_pages: int, chunk: int, dtype=torch.bfloat16,
                            quantized: bool = False, temperature: float = 0.0,
                            backend: str = "auto"):
    """The continuous-batching steps over a paged KV cache
    (:func:`paged_step_fns`):

    * ``paged_decode_step(params, cache, token, lens, tbl, key=None)`` — one
      token for every slot against the pool (updated in place); returns the
      (n_slots,) int32 tokens (argmax at ``temperature`` 0, else a draw
      under ``key``) and the pool;
    * ``paged_prefill_chunk(params, cache, tokens, start, table_row,
      n_valid, key=None)`` — one chunk of one request's prompt written into
      its block-table row; returns the would-be first generated token and
      the pool.

    Global-attention models only (``init_paged_cache`` raises otherwise).
    ``backend`` ``ref`` runs the kernels' plain versions."""
    from repro_torch.launch.distributed import StepBundle

    cfg = arch.model
    param_shapes, local_shapes = _shapes(arch, mesh, dtype)
    cache_shapes = init_paged_cache(cfg, npage, page_size, dtype, quantized=quantized,
                                    device="meta", model=mesh.model)
    decode_fn, prefill_fn = paged_step_fns(cfg, mesh, temperature=temperature,
                                           backend=backend)
    return StepBundle(mesh=mesh, n_workers=1, param_shapes=param_shapes,
                      fns={"paged_decode_step": decode_fn, "paged_prefill_chunk": prefill_fn},
                      meta={"cache_shapes": cache_shapes, "rows": _rows(mesh, n_slots)[0],
                            "cfg": cfg, "temperature": temperature, "fsdp": arch.fsdp},
                      local_shapes=local_shapes)


#: the norm scales a serving rank gathers once, not at every layer and step
_NORMS = ("ln1", "ln2", "q_norm", "k_norm")


def whole_norms(params, mesh, param_shapes, fsdp: bool = False):
    """This rank's parameters with the sharded norm scales gathered once
    over the model group (kind ``model/norms``) and the data group (kind
    ``fsdp/norms``): the model finds them whole and gathers nothing on
    use."""
    if mesh.model == 1 and mesh.fsdp == 1:
        return params
    flat, treedef = tree_flatten_with_path(params)
    out = []
    for (path, t), (fd, md) in zip(flat, shd.leaf_splits(param_shapes, mesh, fsdp)):
        if shd._leaf_name(path) in _NORMS:
            if md is not None:
                t = mesh.model_gather(t, md, kind="model/norms")
            if fd is not None:
                t = mesh.fsdp_gather(t, fd, kind="fsdp/norms")
        out.append(t)
    return treedef.unflatten(out)


def engine_steps(bundle, params, *, seed: int = 0) -> dict:
    """The paged bundle's steps in the engine's form (``serve.build_engine``
    / ``run_continuous``'s ``steps``; :func:`serve.engine_form`): numpy
    tokens out, and at a temperature the key ``PRNGKey(seed)`` split once
    per prefill chunk and decode step. The page ops are the single-process
    ones (every rank holds the pool). On a model group the norm scales are
    gathered once here (:func:`whole_norms`)."""
    params = whole_norms(params, bundle.mesh, bundle.param_shapes,
                         bundle.meta.get("fsdp", False))
    return engine_form(params, bundle.fns["paged_decode_step"],
                       bundle.fns["paged_prefill_chunk"],
                       temperature=bundle.meta["temperature"], seed=seed,
                       model=bundle.mesh.model)

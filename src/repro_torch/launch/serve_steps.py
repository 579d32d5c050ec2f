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
Each step takes the GLOBAL inputs on every rank.

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
  their f32 scales on int8 pages (kind ``kv_rows``) — and writes the other
  groups' rows into its pool, so the pools stay equal across the groups. A
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


def _tp(mesh):
    """The model group the steps run on (None: the rank holds the whole
    model)."""
    return mesh if mesh.model > 1 else None


def _whole_logits(mesh, params, cfg, logits: torch.Tensor) -> torch.Tensor:
    """All V logits from this rank's vocabulary slice."""
    if logits_parallel(params, cfg, _tp(mesh)):
        return mesh.model_gather(logits, -1, kind="model/logits")
    return logits


def _rows(mesh, B: int) -> range:
    """The rows (slots) of a batch of B this rank computes."""
    return mesh.workers(B) if shd.serve_batch_axes(mesh, B) else range(B)


def _exchanges(mesh, rows: range, B: int) -> bool:
    """Whether the rows' outputs cross the group: where the ranks split the
    batch (on one rank too, whenever the mesh has a group), not where every
    rank computes every row."""
    return mesh.group is not None and len(rows) * mesh.world == B


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
    param_shapes = init_params(0, cfg, dtype, device="meta")
    rows = _rows(mesh, batch)
    split = _exchanges(mesh, rows, batch)
    tp = _tp(mesh)

    def gather(params, logits):
        logits = _whole_logits(mesh, params, cfg, logits)
        return mesh.gather_rows(logits, batch, kind="logits") if split else logits

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
                      meta={**meta, "rows": rows})


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
        rows = _rows(mesh, n)
        lo, hi = rows.start, rows.stop
        logits, cache = paged_decode_step(params, cfg, cache, token[lo:hi], lens[lo:hi],
                                          tbl[lo:hi], backend=backend, tp=tp)
        toks = pick(params, logits, key, lo, hi, n).to(torch.int32)
        if not _exchanges(mesh, rows, n):
            return toks, cache
        page_size = tree_flatten(cache)[0][0].shape[2]
        pages = torch.gather(tbl, 1, (lens // page_size).long()[:, None])[:, 0].long()
        offs = (lens % page_size).long()
        others = [s for s in range(n) if s not in rows]
        for leaf in tree_flatten(cache)[0]:
            got = mesh.gather_rows(_written_rows(leaf, pages[lo:hi], offs[lo:hi]), n,
                                   kind="kv_rows")
            if others:
                idx = torch.as_tensor(others, device=leaf.device)
                leaf[:, pages[idx], offs[idx]] = got[idx].movedim(0, 1)
        return mesh.gather_rows(toks, n, kind="tokens"), cache

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
    param_shapes = init_params(0, cfg, dtype, device="meta")
    cache_shapes = init_paged_cache(cfg, npage, page_size, dtype, quantized=quantized,
                                    device="meta", model=mesh.model)
    decode_fn, prefill_fn = paged_step_fns(cfg, mesh, temperature=temperature,
                                           backend=backend)
    return StepBundle(mesh=mesh, n_workers=1, param_shapes=param_shapes,
                      fns={"paged_decode_step": decode_fn, "paged_prefill_chunk": prefill_fn},
                      meta={"cache_shapes": cache_shapes, "rows": _rows(mesh, n_slots),
                            "cfg": cfg, "temperature": temperature})


#: the norm scales a serving rank gathers once, not at every layer and step
_NORMS = ("ln1", "ln2", "q_norm", "k_norm")


def whole_norms(params, mesh, param_shapes):
    """This rank's parameters with the sharded norm scales gathered once
    over the model group (kind ``model/norms``): the model finds them whole
    and gathers nothing on use."""
    if mesh.model == 1:
        return params
    flat, treedef = tree_flatten_with_path(params)
    dims = shd.model_dims(param_shapes, mesh)
    return treedef.unflatten([
        mesh.model_gather(t, d, kind="model/norms")
        if d is not None and shd._leaf_name(path) in _NORMS else t
        for (path, t), d in zip(flat, dims)])


def engine_steps(bundle, params, *, seed: int = 0) -> dict:
    """The paged bundle's steps in the engine's form (``serve.build_engine``
    / ``run_continuous``'s ``steps``; :func:`serve.engine_form`): numpy
    tokens out, and at a temperature the key ``PRNGKey(seed)`` split once
    per prefill chunk and decode step. The page ops are the single-process
    ones (every rank holds the pool). On a model group the norm scales are
    gathered once here (:func:`whole_norms`)."""
    params = whole_norms(params, bundle.mesh, bundle.param_shapes)
    return engine_form(params, bundle.fns["paged_decode_step"],
                       bundle.fns["paged_prefill_chunk"],
                       temperature=bundle.meta["temperature"], seed=seed,
                       model=bundle.mesh.model)

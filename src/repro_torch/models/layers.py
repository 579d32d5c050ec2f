"""Primitive layers: norms, embeddings, rotary and sinusoidal positions, the
gated MLP.

Functional, as in ``repro.models.layers``: ``init_*`` builds parameter
subtrees (dicts of tensors with the reference's names and shapes), the apply
functions consume them. Random init draws from a ``torch.Generator`` on the
target device; on the ``meta`` device only shapes are made.

The model-parallel primitives take ``tp``, the model group: anything with
``model`` (its size m), ``model_rank`` and the collectives ``model_gather``
/ ``model_sum`` (``launch.topology.Mesh``). Activations between the blocks
are replicated, bit for bit, on every rank of the group; a rank-local
stretch starts at :func:`copy_to_group` (identity forward, the group's sum
backward) and ends at :func:`reduce_from_group` (the sum forward, identity
backward). :func:`gather_on_use` all-gathers a sharded leaf forward and
returns this rank's slice of the (replicated) gradient backward. Sums over
the group add the m partials in rank order, so every rank holds the same
bits. The vocabulary-parallel embedding, logits and loss split the
(V, d) table on V.

On an fsdp mesh ``tp`` also has ``fsdp`` (D), ``fsdp_rank`` and the
data-group collectives (``fsdp_gather`` / ``fsdp_reduce_scatter`` /
``fsdp_sum``), and ``fsdp_dim(name, shape)``, the dimension the data axis
splits a whole leaf on. A leaf's data split is gathered at its use, one
layer at a time (:func:`fsdp_layer`, :func:`fsdp_leaf`):
:func:`fsdp_gather_on_use` all-gathers forward and reduce-scatters the
gradient backward, since every data rank saw other rows of the batch.
Where those rows differ (training: ``tp`` wrapped in :class:`RowSplit`)
the losses and the MoE dispatch combine over the data group
(:func:`data_sum`); in serving every data rank computes the same rows.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F


def _normal(gen, shape, scale, dtype, device):
    if torch.device(device).type == "meta":
        return torch.empty(shape, dtype=dtype, device="meta")
    return torch.randn(shape, generator=gen, device=device).mul_(scale).to(dtype)


def init_dense(gen, d_in: int, d_out: int, dtype, device, scale: float | None = None):
    scale = scale if scale is not None else 1.0 / np.sqrt(d_in)
    return _normal(gen, (d_in, d_out), scale, dtype, device)


def init_rmsnorm(d: int, dtype, device):
    return torch.ones((d,), dtype=dtype, device=device)


def rmsnorm(x: torch.Tensor, scale: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    """In float32, as the reference (float64 stays float64)."""
    dt = x.dtype
    x32 = x if dt == torch.float64 else x.float()
    var = torch.mean(torch.square(x32), dim=-1, keepdim=True)
    return (x32 * torch.rsqrt(var + eps)).to(dt) * scale


def init_embedding(gen, vocab: int, d: int, dtype, device):
    return _normal(gen, (vocab, d), d**-0.5, dtype, device)


def embed(table: torch.Tensor, ids: torch.Tensor) -> torch.Tensor:
    return table[ids]


def unembed(table: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """Logits via the (possibly tied) embedding table: x (…, d) → (…, V)."""
    return x @ table.T


def rope(x: torch.Tensor, positions: torch.Tensor, theta: float) -> torch.Tensor:
    """Rotary embedding. x: (..., S, H, hd) with hd even; positions: (..., S)."""
    hd = x.shape[-1]
    half = hd // 2
    exps = torch.arange(0, half, dtype=torch.float32, device=x.device) / half
    freqs = 1.0 / torch.pow(torch.tensor(theta, dtype=torch.float32, device=x.device), exps)
    ang = positions[..., :, None].float() * freqs            # (..., S, half)
    cos = torch.cos(ang)[..., :, None, :]
    sin = torch.sin(ang)[..., :, None, :]
    x1, x2 = x[..., :half], x[..., half:]
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


def sinusoidal_pos(positions: torch.Tensor, d: int) -> torch.Tensor:
    """(…, S) → (…, S, d) classic transformer sinusoids (musicgen), in f32."""
    half = d // 2
    exps = torch.arange(half, dtype=torch.float32, device=positions.device) / half
    freqs = 1.0 / torch.pow(torch.tensor(10_000.0, dtype=torch.float32,
                                         device=positions.device), exps)
    ang = positions[..., None].float() * freqs
    return torch.cat([torch.sin(ang), torch.cos(ang)], dim=-1)


def init_mlp(gen, d: int, f: int, dtype, device):
    return {
        "w_gate": init_dense(gen, d, f, dtype, device),
        "w_up": init_dense(gen, d, f, dtype, device),
        "w_down": init_dense(gen, f, d, dtype, device),
    }


def mlp(params, x: torch.Tensor) -> torch.Tensor:
    h = F.silu(x @ params["w_gate"]) * (x @ params["w_up"])
    return h @ params["w_down"]


# ---------------------------------------------------------------------------
# model-parallel primitives
# ---------------------------------------------------------------------------


def active(tp) -> bool:
    """Whether ``tp`` is a model group of more than one rank."""
    return tp is not None and getattr(tp, "model", 1) > 1


class _CopyToGroup(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, tp):
        ctx.tp = tp
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return ctx.tp.model_sum(g.contiguous()), None


class _ReduceFromGroup(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, tp):
        return tp.model_sum(x.contiguous())

    @staticmethod
    def backward(ctx, g):
        return g, None


class _GatherOnUse(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, tp, dim):
        ctx.tp, ctx.dim = tp, dim
        return tp.model_gather(x, dim, kind="model/gather_on_use")

    @staticmethod
    def backward(ctx, g):
        return ctx.tp.model_slice(g, ctx.dim), None, None


def copy_to_group(x: torch.Tensor, tp) -> torch.Tensor:
    """Identity forward; the group's sum of the gradient backward (enter a
    rank-local stretch)."""
    return _CopyToGroup.apply(x, tp) if active(tp) else x


def reduce_from_group(x: torch.Tensor, tp) -> torch.Tensor:
    """The group's sum of the partials forward (rank order); identity
    backward (leave a rank-local stretch)."""
    return _ReduceFromGroup.apply(x, tp) if active(tp) else x


def gather_on_use(x: torch.Tensor, tp, dim: int) -> torch.Tensor:
    """The whole leaf from this rank's slice along ``dim``; backward, this
    rank's slice of the gradient, which is replicated wherever the leaf
    feeds replicated compute."""
    return _GatherOnUse.apply(x, tp, dim) if active(tp) else x


def split_dim(local: tuple, full: tuple) -> "int | None":
    """The dimension a slice's shape differs from its whole leaf's in."""
    for d, (a, b) in enumerate(zip(local, full)):
        if a != b:
            return d
    return None


def gather_tree_on_use(p, full, tp):
    """Every sharded leaf of a parameter subtree gathered on use (``full``:
    the subtree's whole shapes, e.g. meta tensors)."""
    if not active(tp):
        return p
    if isinstance(p, dict):
        return {k: gather_tree_on_use(v, full[k], tp) for k, v in p.items()}
    d = split_dim(tuple(p.shape), tuple(full.shape))
    return p if d is None else gather_on_use(p, tp, d)


def vocab_parallel(table: torch.Tensor, vocab: int, tp) -> bool:
    """Whether ``table`` is this rank's (V/m, d) slice of a (V, d) table."""
    return active(tp) and table.shape[0] * tp.model == vocab


def _held_otherwise(table: torch.Tensor, vocab: int, width: int, tp) -> torch.Tensor:
    """A (V, d) table that is not vocabulary-parallel, whole: gathered on
    use along the dimension the model axis splits (the rule table's
    fallback puts a large table's split on d when V does not divide), as it
    is where the rank holds it whole."""
    d = split_dim(tuple(table.shape), (vocab, width))
    return table if d is None else gather_on_use(table, tp, d)


def embed_tp(table: torch.Tensor, ids: torch.Tensor, vocab: int, tp,
             width: int) -> torch.Tensor:
    """:func:`embed` of a vocabulary-parallel table: each rank looks up the
    ids in its range (zero rows elsewhere) and the group adds them, which is
    exact (one nonzero a row). A table held otherwise is gathered on use
    (``width``: its whole rows' width)."""
    if not active(tp):
        return embed(table, ids)
    if not vocab_parallel(table, vocab, tp):
        return embed(_held_otherwise(table, vocab, width, tp), ids)
    vl = table.shape[0]
    local = ids.long() - tp.model_rank * vl
    ok = (local >= 0) & (local < vl)
    rows = table[local.clamp(0, vl - 1)]
    return reduce_from_group(torch.where(ok[..., None], rows, torch.zeros_like(rows)), tp)


def unembed_tp(table: torch.Tensor, x: torch.Tensor, vocab: int, tp) -> torch.Tensor:
    """:func:`unembed` of a vocabulary-parallel table: this rank's (…, V/m)
    logits (copy-to-group on x); a table held otherwise is gathered on use
    (to ``x``'s width) and the logits are whole."""
    if not active(tp):
        return unembed(table, x)
    if not vocab_parallel(table, vocab, tp):
        return unembed(_held_otherwise(table, vocab, x.shape[-1], tp), x)
    return unembed(table, copy_to_group(x, tp))


def nll_tp(logits: torch.Tensor, tgt: torch.Tensor, tp) -> torch.Tensor:
    """Mean next-token NLL over vocabulary-parallel logits (this rank's
    (…, V/m) slice): the max and the sum of exponentials combined over the
    group in rank order, the target logit from the rank that holds it."""
    lf = logits.float()
    vl = lf.shape[-1]
    m_loc = torch.amax(lf, dim=-1, keepdim=True).detach()
    m = torch.amax(tp.model_gather(m_loc, -1, kind="model/max"), dim=-1, keepdim=True)
    se = reduce_from_group(torch.sum(torch.exp(lf - m), dim=-1), tp)
    local = tgt.long() - tp.model_rank * vl
    ok = (local >= 0) & (local < vl)
    picked = torch.gather(lf, -1, local.clamp(0, vl - 1)[..., None])[..., 0]
    t_logit = reduce_from_group(torch.where(ok, picked, torch.zeros_like(picked)), tp)
    return torch.mean(m[..., 0] + torch.log(se) - t_logit)


def mlp_tp(params, x: torch.Tensor, full, tp) -> torch.Tensor:
    """The gated MLP with ``w_gate`` / ``w_up`` column-parallel and
    ``w_down`` row-parallel (a slice of the hidden units a rank), the
    partial outputs summed over the group; held otherwise (a hidden width
    that does not split), its leaves gathered on use."""
    if not active(tp):
        return mlp(params, x)
    f = full["w_gate"].shape[-1]
    fl = f // tp.model
    if (f % tp.model == 0 and params["w_gate"].shape[-1] == fl
            and params["w_up"].shape[-1] == fl and params["w_down"].shape[-2] == fl):
        return reduce_from_group(mlp(params, copy_to_group(x, tp)), tp)
    return mlp(gather_tree_on_use(params, full, tp), x)


# ---------------------------------------------------------------------------
# the data axis inside a worker (fsdp)
# ---------------------------------------------------------------------------


def fsdp_active(tp) -> bool:
    """Whether ``tp`` splits the parameters over a data group of more than
    one rank."""
    return tp is not None and getattr(tp, "fsdp", 1) > 1


class RowSplit:
    """The mesh ``tp`` with each worker's batch rows split over its data
    group (a training pass; ``serving``: a serving step, forward only): the
    losses and the MoE dispatch then combine over the group. Anything else
    is the mesh's."""

    fsdp_rows = True

    def __init__(self, mesh, serving: bool = False):
        self._mesh = mesh
        self.serving = serving

    def __getattr__(self, name):
        return getattr(self._mesh, name)


def rows_split(tp) -> bool:
    """Whether the data ranks of ``tp`` hold different rows of the batch."""
    return fsdp_active(tp) and getattr(tp, "fsdp_rows", False)


class _FsdpGatherOnUse(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, tp, dim):
        ctx.tp, ctx.dim = tp, dim
        return tp.fsdp_gather(x, dim, kind="fsdp/gather_on_use")

    @staticmethod
    def backward(ctx, g):
        return ctx.tp.fsdp_reduce_scatter(g.contiguous(), ctx.dim,
                                          kind="fsdp/reduce_scatter"), None, None


class _DataSum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, tp):
        return tp.fsdp_sum(x.contiguous(), kind="fsdp/sum")

    @staticmethod
    def backward(ctx, g):
        return g, None


def fsdp_gather_on_use(x: torch.Tensor, tp, dim: int) -> torch.Tensor:
    """The leaf whole along ``dim`` from this data rank's slice; backward,
    this rank's slice of the data group's summed gradient (each data rank
    saw other rows, so every partial counts)."""
    return _FsdpGatherOnUse.apply(x, tp, dim) if fsdp_active(tp) else x


def data_sum(x: torch.Tensor, tp) -> torch.Tensor:
    """Σ over the data group forward (rank order); identity backward: each
    rank's gradient reaches its own rows only, and the reduce-scatter of
    the parameters' gradients adds them up."""
    return _DataSum.apply(x, tp) if rows_split(tp) else x


def fsdp_leaf(x: torch.Tensor, tp, name: str, full: tuple) -> torch.Tensor:
    """An unstacked leaf named ``name`` (whole shape ``full``) with its data
    split gathered, where this rank holds a slice of it."""
    if not fsdp_active(tp):
        return x
    d = tp.fsdp_dim(name, tuple(full))
    if d is None or x.shape[d] == full[d]:
        return x
    return fsdp_gather_on_use(x, tp, d)


class _FsdpGatherMany(torch.autograd.Function):
    """Several leaves' data splits in one collective each way: forward one
    all-gather of their flattened slices, backward one all-to-all of the
    gradients' slices, each added in data-rank order (what
    :func:`fsdp_gather_on_use` does leaf by leaf)."""

    @staticmethod
    def forward(ctx, tp, dims, *xs):
        D = tp.fsdp
        ctx.tp, ctx.dims, ctx.shapes, ctx.dtype = tp, dims, [x.shape for x in xs], xs[0].dtype
        flat = torch.cat([x.reshape(-1) for x in xs])
        full = tp.fsdp_gather(flat, 0, kind="fsdp/gather_on_use").view(D, -1)
        outs, off = [], 0
        for x, d in zip(xs, dims):
            part = full[:, off:off + x.numel()].reshape(D, *x.shape)
            outs.append(torch.cat(part.unbind(0), dim=d))
            off += x.numel()
        return tuple(outs)

    @staticmethod
    def backward(ctx, *gs):
        tp, D = ctx.tp, ctx.tp.fsdp
        send = []
        for g, shape, d in zip(gs, ctx.shapes, ctx.dims):
            whole = list(shape)
            whole[d] *= D
            g = g if g is not None else torch.zeros(whole, dtype=ctx.dtype, device=tp.device)
            send.append(torch.stack(g.chunk(D, dim=d)).reshape(D, -1))
        acc = tp.fsdp_reduce_rows(torch.cat(send, dim=1), kind="fsdp/reduce_scatter")
        grads, off = [], 0
        for shape in ctx.shapes:
            n = int(np.prod(shape))
            grads.append(acc[off:off + n].reshape(shape))
            off += n
        return (None, None, *grads)


def _gather_split(items: list, tp) -> list:
    """``items``: (piece, dim or None, pick or None) — the pieces with a
    dim gathered along it (one collective for all of them where they share
    a dtype), then indexed by ``pick``; the others as they are."""
    todo = [i for i, (_x, d, _p) in enumerate(items) if d is not None]
    out = [x for x, _d, _p in items]
    if len({items[i][0].dtype for i in todo}) == 1:
        got = _FsdpGatherMany.apply(tp, [items[i][1] for i in todo],
                                    *[items[i][0].contiguous() for i in todo])
    else:
        got = [fsdp_gather_on_use(items[i][0], tp, items[i][1]) for i in todo]
    for i, g in zip(todo, got):
        pick = items[i][2]
        out[i] = g if pick is None else g[pick]
    return out


def _leaves(tree, full, name: str = "") -> list:
    """(keys, leaf, whole leaf, name) of a parameter subtree, in order."""
    if isinstance(tree, dict):
        return [((k,) + keys, x, f, n)
                for k, v in tree.items() for keys, x, f, n in _leaves(v, full[k], k)]
    return [((), tree, full, name)]


def _rebuild(tree, values: list):
    """``tree`` with its leaves replaced by ``values`` (in order)."""
    it = iter(values)

    def walk(t):
        if isinstance(t, dict):
            return {k: walk(v) for k, v in t.items()}
        return next(it)
    return walk(tree)


def fsdp_tree(p, full, tp):
    """:func:`fsdp_leaf` over an unstacked subtree (``full`` its whole
    shapes), in one collective each way."""
    if not fsdp_active(tp):
        return p
    items = []
    for _keys, x, f, name in _leaves(p, full):
        d = tp.fsdp_dim(name, tuple(f.shape))
        items.append((x, None if d is None or x.shape[d] == f.shape[d] else d, None))
    return _rebuild(p, _gather_split(items, tp))


def fsdp_layer_local(pp, r: int, repeat: int, full, tp, name: str = ""):
    """This rank's pieces of layer ``r`` of a stacked (repeat, …) subtree
    (``full``: one layer's whole shapes): ``leaf[r]``, or where the data
    axis splits the layer dimension (the stacked norms and biases) the row
    this rank holds at r's offset. :func:`fsdp_layer` gathers them; the
    pieces are what a remat checkpoint saves."""
    if isinstance(pp, dict):
        return {k: fsdp_layer_local(v, r, repeat, full[k], tp, k) for k, v in pp.items()}
    if not fsdp_active(tp) or pp.shape[0] == repeat:
        return pp[r]
    return pp[r % pp.shape[0]][None]


def fsdp_layer(pieces, r: int, repeat: int, full, tp):
    """Layer ``r``'s leaves from :func:`fsdp_layer_local`'s pieces, their
    data split gathered on use — forward one all-gather over the data group
    for the whole layer, backward one reduce-scatter; the model split
    stays."""
    if not fsdp_active(tp):
        return pieces
    items = []
    for _keys, x, f, name in _leaves(pieces, full):
        d = tp.fsdp_dim(name, (repeat, *f.shape))
        if d is None:
            items.append((x, None, None))
        elif d == 0:
            # the layer dimension: the rank holds every layer, or its row
            whole = x.dim() == len(f.shape)
            items.append((x, None if whole else 0, None if whole else r // (repeat // tp.fsdp)))
        else:
            items.append((x, None if x.shape[d - 1] == f.shape[d - 1] else d - 1, None))
    return _rebuild(pieces, _gather_split(items, tp))

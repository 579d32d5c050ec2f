"""Mixture-of-Experts FF layer — port of ``repro.models.moe``: top-k
routing, shared experts, capacity dispatch.

Tokens are sorted by expert id (a stable argsort) and packed into an
(E, C, d) capacity buffer through int32 slot indices, then each expert runs
a dense batched SwiGLU over its C rows. C = tokens·top_k/E ·
capacity_factor, rounded up to a multiple of 8 (``capacity``, as the
reference has it: C decides which tokens drop). Routers: softmax over the
experts or per-expert sigmoids, each normalized over the top-k, plus the
Switch load-balance loss (eq. 4) × ``aux_loss_coef``.

Three rules differ from a literal copy of the reference (ROADMAP C):

* top-k ties go to the lowest expert index, as ``lax.top_k`` takes them, by
  a stable descending sort (``torch.topk`` promises no order);
* a (token, k) pair of rank ≥ C in its expert writes nothing, so an
  overflowing expert keeps its ranks 0 … C−1, as the reference's docstring
  says (the reference writes its dropped pairs onto the expert's rank-0
  slot, and XLA's last write wins there, so it keeps ranks 1 … C−1);
* the combine is a gather: each token adds its top-k experts' outputs ×
  weights in k order, with no duplicate-index scatter-add (whose float
  order CUDA's atomics would change from run to run), so the layer is
  run-to-run identical on the card.

``moe_ff.drops``: set it to a zero int64 tensor on the layer's device to
count the (token, k) pairs dropped by the capacity (added on the device,
no host sync); None (the default) counts nothing.

On a model group the experts split over the ranks (expert parallelism:
``moe_gate`` / ``moe_up`` / ``moe_down`` hold E/m experts a rank). The
router stays replicated, so every rank routes every token alike; each rank
runs its own experts' C capacity rows, and the slot outputs are
all-gathered, so the combine still adds each token's k outputs in top-k
order (a sum over the ranks would not). The shared experts are a
tensor-parallel MLP. Stacks that do not split by expert are gathered on
use.

Where the data ranks of an fsdp mesh hold different rows of the worker's
batch (training, ``layers.rows_split``) the dispatch is the whole batch's,
as the reference's: C is sized from the worker's T = D·T_local tokens, a
pair's rank in its expert counts the pairs of the data ranks before this
one (an exclusive prefix of the per-rank counts, all-gathered over the data
group), and the Switch loss's fractions and mean probabilities are the
data group's sums ÷ T. Each rank runs its own kept pairs through a local
(E, C_local) buffer, C_local = min(C, T_local·k).
"""

from __future__ import annotations

from typing import Any

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch.kernels import ref as kref

from .config import ModelConfig, MoEConfig
from .layers import (
    _normal,
    active,
    copy_to_group,
    data_sum,
    gather_on_use,
    gather_tree_on_use,
    init_dense,
    init_mlp,
    mlp,
    mlp_tp,
    rows_split,
)

PyTree = Any


def init_moe(gen, cfg: ModelConfig, dtype, device):
    m: MoEConfig = cfg.moe
    d, f, E = cfg.d_model, m.d_expert, m.num_experts
    p = {
        "router": init_dense(gen, d, E, dtype, device, scale=0.02),
        # (E, d_in, d_out) stacks, drawn whole
        "moe_gate": _normal(gen, (E, d, f), 1.0 / np.sqrt(d), dtype, device),
        "moe_up": _normal(gen, (E, d, f), 1.0 / np.sqrt(d), dtype, device),
        "moe_down": _normal(gen, (E, f, d), 1.0 / np.sqrt(f), dtype, device),
    }
    if m.num_shared:
        p["shared"] = init_mlp(gen, d, f * m.num_shared, dtype, device)
    return p


def _top_k(scores: torch.Tensor, k: int):
    """(values, indices) of the k largest scores per row, ties to the lowest
    index (``lax.top_k``'s order)."""
    vals, idx = torch.sort(scores, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def _route(p, m: MoEConfig, x_flat: torch.Tensor, tp=None):
    """x_flat (T, d) → (expert_ids (T,k) int32, combine_w (T,k), aux_loss);
    over the data group's rows where they split the batch."""
    logits = (x_flat @ p["router"]).float()                      # (T, E)
    probs = kref.softmax_ref(logits)
    scores = torch.sigmoid(logits) if m.router_score == "sigmoid" else probs
    w, ids = _top_k(scores, m.top_k)
    w = w / torch.clamp(torch.sum(w, -1, keepdim=True), min=1e-9)
    # Switch load-balance loss: E · Σ_e fraction_e · router_prob_e
    onehot = F.one_hot(ids[:, 0], m.num_experts).float()
    if rows_split(tp):
        T = x_flat.shape[0] * tp.fsdp
        frac = data_sum(torch.sum(onehot, dim=0), tp) / T
        mean_p = data_sum(torch.sum(probs, dim=0), tp) / T
    else:
        frac, mean_p = torch.mean(onehot, dim=0), torch.mean(probs, dim=0)
    aux = m.num_experts * torch.sum(frac * mean_p)
    return ids.to(torch.int32), w, aux * m.aux_loss_coef


def capacity(m: MoEConfig, T: int) -> int:
    c = int(T * m.top_k / m.num_experts * m.capacity_factor)
    return max(8, -(-c // 8) * 8)  # a multiple of 8, as the reference


def _combine(yg: torch.Tensor, pair_slot: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """Each token's top-k expert outputs × weights, added in k order by
    gather: yg (E·C + 1, d) with a zero last row (the dropped pairs' slot),
    pair_slot (T, k), w (T, k) → (T, d) = ((0 + yg[s_0]·w_0) + yg[s_1]·w_1) …"""
    y = yg.new_zeros((pair_slot.shape[0], yg.shape[1]))
    for j in range(pair_slot.shape[1]):
        y = y + yg[pair_slot[:, j]] * w[:, j, None]
    return y


def moe_ff(p, cfg: ModelConfig, x: torch.Tensor, tp=None, full=None):
    """x (B, S, d) → (y (B, S, d), aux_loss scalar). ``tp`` the model group
    and ``full`` the layer's whole shapes (module doc)."""
    m: MoEConfig = cfg.moe
    B, S, d = x.shape
    T = B * S
    E, k = m.num_experts, m.top_k
    e0, El = 0, E
    if active(tp):
        El = E // tp.model
        ep = E % tp.model == 0 and all(p[n].shape[0] == El
                                       for n in ("moe_gate", "moe_up", "moe_down"))
        if ep:
            e0 = tp.model_rank * El
        else:
            El = E
        p = {n: (v if (ep and n.startswith("moe_")) or n == "shared"
                 else gather_tree_on_use(v, full[n], tp)) for n, v in p.items()}
    x_flat = x.reshape(T, d)
    ids, w, aux = _route(p, m, x_flat, tp)                       # (T, k)
    whole = rows_split(tp)
    C = capacity(m, T * tp.fsdp if whole else T)

    # --- pack: rank of each (token, k) pair within its expert --------------
    flat_e = ids.reshape(-1)                                     # (T·k,)
    order = torch.argsort(flat_e, stable=True)                   # sorted by expert
    sorted_e = flat_e[order]
    group_start = torch.searchsorted(
        sorted_e, torch.arange(E, dtype=sorted_e.dtype, device=x.device))
    rank = torch.arange(T * k, device=x.device) - group_start[sorted_e.long()]
    before = 0
    if whole:
        # the pairs of the data ranks before this one come first in the
        # worker's batch: their counts per expert offset this rank's ranks
        counts = torch.zeros((E,), dtype=torch.int64, device=x.device).scatter_add_(
            0, flat_e.long(), torch.ones_like(flat_e, dtype=torch.int64))
        allc = tp.fsdp_gather(counts[None], 0, kind="fsdp/moe_counts")
        before = allc[:tp.fsdp_rank].sum(0)[sorted_e.long()]
    keep = rank + before < C
    if moe_ff.drops is not None:
        moe_ff.drops += (~keep).sum()
    # each kept pair's slot e·C + rank (distinct); a dropped pair reads the
    # zero row E·C of the outputs (a local buffer of C_local rows an expert
    # where the data ranks split the batch)
    C = min(C, T * k) if whole else C
    slot_sorted = torch.where(keep, sorted_e.long() * C + rank, E * C)
    pair_slot = torch.empty_like(slot_sorted)
    pair_slot[order] = slot_sorted                               # (token, k) order
    token_for_slot = torch.full((E * C + 1,), T, dtype=torch.long, device=x.device)
    token_for_slot[slot_sorted] = order // k                     # row E·C: dummies
    token_for_slot = token_for_slot[:E * C]

    # --- expert compute: dense batched SwiGLU over (E, C, d) ---------------
    # (this rank's experts e0 … e0+El−1 on a model group)
    xe = copy_to_group(x_flat, tp) if El < E else x_flat
    x_pad = torch.cat([xe, xe.new_zeros((1, d))], dim=0)
    xg = x_pad[token_for_slot[e0 * C:(e0 + El) * C]].reshape(El, C, d)
    h = F.silu(torch.einsum("ecd,edf->ecf", xg, p["moe_gate"])) * torch.einsum(
        "ecd,edf->ecf", xg, p["moe_up"])
    yg = torch.einsum("ecf,efd->ecd", h, p["moe_down"]).reshape(El * C, d)
    if El < E:
        yg = gather_on_use(yg, tp, 0)
    yg = torch.cat([yg, yg.new_zeros((1, d))], dim=0)

    y = _combine(yg, pair_slot.reshape(T, k), w.to(x.dtype)).reshape(B, S, d)
    if m.num_shared:
        y = y + (mlp_tp(p["shared"], x, full["shared"], tp) if active(tp)
                 else mlp(p["shared"], x))
    return y, aux


moe_ff.drops = None

"""Synthetic heterogeneous token streams and the federated Dirichlet(α)
split — port of ``repro.data.pipeline``.

Per-worker token streams follow the reference's construction: a
deterministic affine "grammar" (token_{t+1} = 31·token_t + 7 mod V) mixed
with a worker-biased stochastic component. Two heterogeneity dials, as in
the reference: the legacy ``heterogeneity`` scalar (noise toward a
worker-specific vocabulary region) and ``alpha``, under which each worker
mixes ``n_regions`` vocabulary regions by its own π ~ Dir(α), a pure
function of ``(seed, worker)``: region ~ π, then uniform within it. Every
(step) batch is a pure function of ``(seed, step)``: the draws come from a
``torch.Generator`` seeded from ``fold_in(PRNGKey(seed), step)``. The
tokens are not the reference's (parity tests carry the reference's tokens
across); the Dirichlet rows are numpy's under ``prng.key_to_seed`` of the
reference's keys, and :func:`dirichlet_partition` gives the reference's
shards for the same proportions.
"""

from __future__ import annotations

import dataclasses
from typing import Iterator, Optional

import numpy as np
import torch

from repro_torch import prng
from repro_torch.device import default_device


@dataclasses.dataclass(frozen=True)
class HeterogeneousLMData:
    """Spec for per-worker synthetic token distributions (``alpha`` None:
    the legacy ``heterogeneity`` dial)."""

    n_workers: int
    vocab_size: int
    seq_len: int
    seed: int = 0
    heterogeneity: float = 1.0  # 0 → iid workers
    alpha: Optional[float] = None  # Dirichlet non-IID dial (None → legacy)
    n_regions: int = 8             # vocab regions the Dirichlet mixes over


def make_lm_data(n_workers: int, vocab_size: int, seq_len: int, seed: int = 0,
                 heterogeneity: float = 1.0,
                 alpha: Optional[float] = None) -> HeterogeneousLMData:
    """Build a :class:`HeterogeneousLMData` spec."""
    return HeterogeneousLMData(n_workers=n_workers, vocab_size=vocab_size,
                               seq_len=seq_len, seed=seed,
                               heterogeneity=heterogeneity, alpha=alpha)


# ---------------------------------------------------------------------------
# Dirichlet(α) non-IID partitioning (the standard federated protocol)
# ---------------------------------------------------------------------------


def dirichlet_proportions(key, n_clients: int, n_classes: int,
                          alpha: Optional[float]) -> np.ndarray:
    """(n_clients, n_classes) float32 class mixtures, one Dir(α) row per
    client, from ``numpy.random.default_rng(prng.key_to_seed(key))``.
    α = ``None`` or a non-finite value gives the uniform mixture."""
    if alpha is None or not np.isfinite(alpha):
        return np.full((n_clients, n_classes), 1.0 / n_classes, np.float32)
    rng = np.random.default_rng(prng.key_to_seed(key))
    return rng.dirichlet(np.full(n_classes, float(alpha)), n_clients).astype(np.float32)


def dirichlet_partition(key, labels: np.ndarray, n_clients: int, alpha: float) -> list:
    """Partition sample indices across clients by Dirichlet label skew
    (host numpy): each class's indices, shuffled, are split across clients
    in proportion to their :func:`dirichlet_proportions` column. The
    shuffle is seeded from ``prng.bits(key)``, as the reference's, so the
    same proportions give the reference's shards. Returns ``n_clients``
    disjoint int arrays covering every index."""
    labels = np.asarray(labels)
    classes = np.unique(labels)
    props = dirichlet_proportions(key, n_clients, len(classes), alpha)
    rng = np.random.default_rng(int(prng.bits(key)))
    shards = [[] for _ in range(n_clients)]
    for c_idx, c in enumerate(classes):
        idx = np.flatnonzero(labels == c)
        rng.shuffle(idx)
        w = props[:, c_idx]
        w = w / max(w.sum(), 1e-12)
        cuts = (np.cumsum(w)[:-1] * len(idx)).astype(int)
        for client, part in enumerate(np.split(idx, cuts)):
            shards[client].append(part)
    return [np.concatenate(s) if s else np.empty((0,), int) for s in shards]


def client_weights_from_counts(counts) -> torch.Tensor:
    """Normalized client weights w_i = m_i / Σm_j (float32, on the host)
    from per-client sample counts — the weights PPMarina takes for
    unbalanced local datasets."""
    c = torch.as_tensor(np.asarray(counts), dtype=torch.float32)
    return c / torch.sum(c)


# ---------------------------------------------------------------------------
# Token streams
# ---------------------------------------------------------------------------


def _generator(data: HeterogeneousLMData, step: int) -> torch.Generator:
    key = prng.fold_in(prng.PRNGKey(data.seed), step)
    return torch.Generator().manual_seed((int(key[0]) << 32) | int(key[1]))


def _worker_mixtures(data: HeterogeneousLMData) -> torch.Tensor:
    """(n_workers, n_regions) float32: worker w's π from
    ``fold_in(PRNGKey(seed + 101), w)``, the reference's keys."""
    base = prng.PRNGKey(data.seed + 101)
    return torch.from_numpy(np.concatenate([
        dirichlet_proportions(prng.fold_in(base, w), 1, data.n_regions, data.alpha)
        for w in range(data.n_workers)]))


def worker_batches(data: HeterogeneousLMData, step: int, batch_per_worker: int,
                   device=None) -> torch.Tensor:
    """(n_workers, batch, seq_len) int64 tokens for a given global step, on
    ``cuda`` unless ``device`` names another."""
    device = default_device(device)
    gen = _generator(data, step)
    n, V, het = data.n_workers, data.vocab_size, data.heterogeneity
    shape = (n, batch_per_worker)
    if data.alpha is not None:
        pi = _worker_mixtures(data)
        region_w = V // data.n_regions
    else:
        # worker-specific preferred region of the vocabulary (→ V/2 when iid)
        w = torch.arange(n, dtype=torch.float32)[:, None]
        center = V / 2.0 + het * ((w + 0.5) / n - 0.5) * V
        width = V * (1.0 - 0.7 * het) + 1.0
    tok = torch.randint(0, V, shape, generator=gen)
    toks = [tok]
    for _ in range(data.seq_len - 1):
        nxt = (tok * 31 + 7) % V
        if data.alpha is not None:
            region = torch.multinomial(pi, batch_per_worker, replacement=True,
                                       generator=gen)
            within = torch.randint(0, region_w, shape, generator=gen)
            biased = torch.clamp(region * region_w + within, 0, V - 1)
        else:
            noise = torch.randn(shape, generator=gen) * width * 0.1
            biased = torch.clamp(center + noise, 0, V - 1).to(torch.int64)
        use_hash = torch.rand(shape, generator=gen) < 0.7
        tok = torch.where(use_hash, nxt, biased)
        toks.append(tok)
    return torch.stack(toks, dim=-1).to(device)


def lm_batch_iterator(data: HeterogeneousLMData, batch_per_worker: int,
                      start_step: int = 0, device=None) -> Iterator[torch.Tensor]:
    """Endless (n_workers, batch, seq_len) token stream, one batch per
    optimizer step from ``start_step``."""
    step = start_step
    while True:
        yield worker_batches(data, step, batch_per_worker, device)
        step += 1


def make_prefix_embeddings(key, n_workers: int, batch: int, prefix_len: int,
                           d_model: int, device=None) -> torch.Tensor:
    """Stub frontend output (vision patches / audio conditioning frames):
    (n_workers, batch, prefix_len, d_model) float32, ``prng.normal`` × 0.02
    (within 3 ulp of ``jax.random.normal``'s, so × 0.02 of the reference's),
    on ``cuda`` unless ``device`` names another."""
    device = default_device(device)
    z = prng.normal(key, (n_workers, batch, prefix_len, d_model)) * np.float32(0.02)
    return torch.from_numpy(z).to(device)

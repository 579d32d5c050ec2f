"""Synthetic heterogeneous token streams — port of ``repro.data.pipeline``
(the legacy-heterogeneity path).

Per-worker token streams follow the reference's construction: a
deterministic affine "grammar" (token_{t+1} = 31·token_t + 7 mod V) mixed
with worker-biased noise toward a worker-specific vocabulary region, so local
gradients genuinely disagree. Every (step) batch is a pure function of
``(seed, step)``: the draws come from a ``torch.Generator`` seeded from
``fold_in(PRNGKey(seed), step)``. The tokens are not the reference's (parity
tests carry the reference's tokens across). The Dirichlet ``alpha`` dial is
not ported yet.
"""

from __future__ import annotations

import dataclasses

import torch

from repro_torch import prng
from repro_torch.device import default_device


@dataclasses.dataclass(frozen=True)
class HeterogeneousLMData:
    """Spec for per-worker synthetic token distributions."""

    n_workers: int
    vocab_size: int
    seq_len: int
    seed: int = 0
    heterogeneity: float = 1.0  # 0 → iid workers


def _generator(data: HeterogeneousLMData, step: int) -> torch.Generator:
    key = prng.fold_in(prng.PRNGKey(data.seed), step)
    return torch.Generator().manual_seed((int(key[0]) << 32) | int(key[1]))


def worker_batches(data: HeterogeneousLMData, step: int, batch_per_worker: int,
                   device=None) -> torch.Tensor:
    """(n_workers, batch, seq_len) int64 tokens for a given global step, on
    ``cuda`` unless ``device`` names another."""
    device = default_device(device)
    gen = _generator(data, step)
    n, V, het = data.n_workers, data.vocab_size, data.heterogeneity
    shape = (n, batch_per_worker)
    # worker-specific preferred region of the vocabulary (→ V/2 when iid)
    w = torch.arange(n, dtype=torch.float32)[:, None]
    center = V / 2.0 + het * ((w + 0.5) / n - 0.5) * V
    width = V * (1.0 - 0.7 * het) + 1.0
    tok = torch.randint(0, V, shape, generator=gen)
    toks = [tok]
    for _ in range(data.seq_len - 1):
        nxt = (tok * 31 + 7) % V
        noise = torch.randn(shape, generator=gen) * width * 0.1
        biased = torch.clamp(center + noise, 0, V - 1).to(torch.int64)
        use_hash = torch.rand(shape, generator=gen) < 0.7
        tok = torch.where(use_hash, nxt, biased)
        toks.append(tok)
    return torch.stack(toks, dim=-1).to(device)

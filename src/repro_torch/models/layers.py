"""Primitive layers: norms, embeddings, rotary and sinusoidal positions, the
gated MLP.

Functional, as in ``repro.models.layers``: ``init_*`` builds parameter
subtrees (dicts of tensors with the reference's names and shapes), the apply
functions consume them. Random init draws from a ``torch.Generator`` on the
target device; on the ``meta`` device only shapes are made.
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

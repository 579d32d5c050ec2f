"""Causal GQA attention for training — port of the dense path of
``repro.models.attention`` (``init_attn``, ``_qkv``, ``chunked_attention``,
``attn_train``).

Training runs the chunked online-softmax formulation of the reference:
memory O(S·chunk) instead of O(S²). Sliding-window layers, MLA and the
decode / paged paths are not ported yet.
"""

from __future__ import annotations

import math
from typing import Any

import torch

from .config import ModelConfig
from .layers import init_dense, init_rmsnorm, rmsnorm, rope

PyTree = Any

_NEG_INF = -1e30


def _attend_chunk(q, k, v, mask):
    """q (B,Cq,H,hd), k/v (B,Ck,H,hd), mask (B,Cq,Ck) → (logits-max, den, num)."""
    scale = 1.0 / math.sqrt(q.shape[-1])
    logits = torch.einsum("bqhd,bkhd->bhqk", q, k).float() * scale
    logits = torch.where(mask[:, None, :, :], logits,
                         torch.tensor(_NEG_INF, device=logits.device))
    m = torch.amax(logits, dim=-1)                     # (B,H,Cq)
    p = torch.exp(logits - m[..., None])
    den = torch.sum(p, dim=-1)                         # (B,H,Cq)
    num = torch.einsum("bhqk,bkhd->bqhd", p.to(v.dtype), v)
    return m, den, num


def _merge(carry, m, den, num):
    m0, den0, num0 = carry
    m_new = torch.maximum(m0, m)
    a0 = torch.exp(m0 - m_new)
    a1 = torch.exp(m - m_new)
    den_new = den0 * a0 + den * a1
    num_new = (num0 * a0.transpose(1, 2)[..., None].to(num0.dtype)
               + num * a1.transpose(1, 2)[..., None].to(num.dtype))
    return m_new, den_new, num_new


def chunked_attention(q, k, v, positions, *, chunk: int = 1024) -> torch.Tensor:
    """Causal attention. q (B,S,H,hd), k/v (B,S,KV,hd), positions (B,S)."""
    B, S, H, hd = q.shape
    KV = k.shape[2]
    hd_v = v.shape[3]
    chunk = min(chunk, S)
    S_orig = S
    pad = (-S) % chunk
    if pad:
        # padded keys get sentinel positions no real query attends to
        q, k, v = (torch.nn.functional.pad(t, (0, 0, 0, 0, 0, pad)) for t in (q, k, v))
        positions = torch.nn.functional.pad(positions, (0, pad), value=2**30)
        S += pad
    nch = S // chunk
    rep = H // KV

    def expand(x):  # GQA: repeat kv heads to H
        return torch.repeat_interleave(x, rep, dim=2) if rep > 1 else x

    outs = []
    for qi in range(nch):
        sl_q = slice(qi * chunk, (qi + 1) * chunk)
        q_i, p_i = q[:, sl_q], positions[:, sl_q]
        carry = (
            torch.full((B, H, chunk), _NEG_INF, dtype=torch.float32, device=q.device),
            torch.zeros((B, H, chunk), dtype=torch.float32, device=q.device),
            torch.zeros((B, chunk, H, hd_v), dtype=v.dtype, device=q.device),
        )
        for kj in range(qi + 1):  # chunks past the diagonal are fully masked
            sl_k = slice(kj * chunk, (kj + 1) * chunk)
            mask = positions[:, sl_k][:, None, :] <= p_i[:, :, None]
            carry = _merge(carry, *_attend_chunk(q_i, expand(k[:, sl_k]),
                                                 expand(v[:, sl_k]), mask))
        _, den, num = carry
        den = torch.clamp(den, min=1e-30)
        outs.append(num / den.transpose(1, 2)[..., None].to(num.dtype))
    out = torch.cat(outs, dim=1)
    return out[:, :S_orig]


def init_attn(gen, cfg: ModelConfig, dtype, device):
    d, H, KV, hd = cfg.d_model, cfg.num_heads, cfg.num_kv_heads, cfg.resolved_head_dim
    p = {
        "wq": init_dense(gen, d, H * hd, dtype, device),
        "wk": init_dense(gen, d, KV * hd, dtype, device),
        "wv": init_dense(gen, d, KV * hd, dtype, device),
        "wo": init_dense(gen, H * hd, d, dtype, device),
    }
    if cfg.qkv_bias:
        p["bq"] = torch.zeros((H * hd,), dtype=dtype, device=device)
        p["bk"] = torch.zeros((KV * hd,), dtype=dtype, device=device)
        p["bv"] = torch.zeros((KV * hd,), dtype=dtype, device=device)
    if cfg.qk_norm:
        p["q_norm"] = init_rmsnorm(hd, dtype, device)
        p["k_norm"] = init_rmsnorm(hd, dtype, device)
    return p


def _qkv(p, cfg: ModelConfig, x, positions):
    B, S, _ = x.shape
    H, KV, hd = cfg.num_heads, cfg.num_kv_heads, cfg.resolved_head_dim
    q = x @ p["wq"]
    k = x @ p["wk"]
    v = x @ p["wv"]
    if cfg.qkv_bias:
        q, k, v = q + p["bq"], k + p["bk"], v + p["bv"]
    q = q.reshape(B, S, H, hd)
    k = k.reshape(B, S, KV, hd)
    v = v.reshape(B, S, KV, hd)
    if cfg.qk_norm:
        q = rmsnorm(q, p["q_norm"], cfg.norm_eps)
        k = rmsnorm(k, p["k_norm"], cfg.norm_eps)
    if cfg.pos_emb == "rope":
        q = rope(q, positions, cfg.rope_theta)
        k = rope(k, positions, cfg.rope_theta)
    elif cfg.pos_emb != "none":
        raise NotImplementedError(f"pos_emb {cfg.pos_emb!r} is not ported yet")
    return q, k, v


def attn_train(p, cfg: ModelConfig, x, positions, *, chunk: int = 1024):
    """Global causal GQA attention of one layer: x (B,S,d) → (B,S,d)."""
    B, S, _ = x.shape
    q, k, v = _qkv(p, cfg, x, positions)
    out = chunked_attention(q, k, v, positions, chunk=chunk)
    return out.reshape(B, S, -1) @ p["wo"]

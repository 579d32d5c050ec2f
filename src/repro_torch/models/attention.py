"""Causal GQA attention — port of the global-attention paths of
``repro.models.attention``: training (``init_attn``, ``_qkv``,
``chunked_attention``, ``attn_train``), dense-cache decode
(``init_attn_cache``, ``attn_decode``) and the paged-KV serving engine
(``init_paged_attn_cache``, ``_paged_write``, ``_paged_attend_multi``,
``paged_attn_decode``, ``paged_attn_prefill_chunk``).

Training runs the chunked online-softmax formulation of the reference:
memory O(S·chunk) instead of O(S²). Decode attends one query token against
the cache. The caches are written in place (the reference returns new ones):
each function still returns the cache it was given, so callers keep the
reference's ``(y, cache) = f(cache, ...)`` contract. The paged functions take
the reference's ``backend``: ``auto`` runs the kernel wrappers (the kernels on
CUDA tensors, their plain versions on CPU ones), ``ref`` the plain versions.
Sliding-window layers and MLA are not ported yet.
"""

from __future__ import annotations

import math
from typing import Any

import torch

from repro_torch.kernels import paged as paged_kernels
from repro_torch.kernels import quantize as qz
from repro_torch.kernels import ref as kref

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


# ---------------------------------------------------------------------------
# Dense-cache decode (the static-batching serving path)
# ---------------------------------------------------------------------------


def init_attn_cache(cfg: ModelConfig, B: int, max_len: int, *, dtype, device):
    KV, hd = cfg.num_kv_heads, cfg.resolved_head_dim
    return {
        "k": torch.zeros((B, max_len, KV, hd), dtype=dtype, device=device),
        "v": torch.zeros((B, max_len, KV, hd), dtype=dtype, device=device),
    }


def attn_decode(p, cfg: ModelConfig, cache, x_t, pos: int):
    """x_t (B,1,d); pos the current absolute position. Writes k_t / v_t at
    ``pos``, then attends over positions ≤ pos. Returns (y, cache)."""
    B = x_t.shape[0]
    H, KV, hd = cfg.num_heads, cfg.num_kv_heads, cfg.resolved_head_dim
    positions = torch.full((B, 1), pos, dtype=torch.int32, device=x_t.device)
    q, k_t, v_t = _qkv(p, cfg, x_t, positions)
    k, v = cache["k"], cache["v"]
    k[:, pos] = k_t[:, 0].to(k.dtype)
    v[:, pos] = v_t[:, 0].to(v.dtype)
    L = k.shape[1]
    valid = torch.arange(L, device=k.device) <= pos
    rep = H // KV
    k_e = torch.repeat_interleave(k, rep, dim=2) if rep > 1 else k
    v_e = torch.repeat_interleave(v, rep, dim=2) if rep > 1 else v
    logits = torch.einsum("bqhd,bkhd->bhqk", q, k_e).float() * kref.attn_scale(hd)
    logits = torch.where(valid[None, None, None, :], logits,
                         torch.tensor(_NEG_INF, device=logits.device))
    w = kref.softmax_ref(logits)
    out = torch.einsum("bhqk,bkhd->bqhd", w.to(v_e.dtype), v_e)
    return out.reshape(B, 1, -1) @ p["wo"], cache


# ---------------------------------------------------------------------------
# Paged-KV GQA (serving engine, DESIGN.md §8)
# ---------------------------------------------------------------------------

BACKENDS = ("auto", "ref")


def _plain(backend: str) -> bool:
    """True for ``ref`` (the plain versions); ``auto`` calls the wrappers."""
    if backend not in BACKENDS:
        raise ValueError(f"unknown backend {backend!r}, expected one of {BACKENDS}")
    return backend == "ref"


def init_paged_attn_cache(cfg: ModelConfig, npage: int, page_size: int, dtype, *,
                          quantized: bool = False, device=None):
    """One layer's KV page pool: (npage, P, KV, hd), page 0 the reserved null
    page (core/paging.py). ``quantized`` stores int8 codes plus one f32
    absmax scale per (page, row, kv-head)."""
    KV, hd = cfg.num_kv_heads, cfg.resolved_head_dim
    shape = (npage, page_size, KV, hd)
    if quantized:
        return {
            "kq": torch.zeros(shape, dtype=torch.int8, device=device),
            "vq": torch.zeros(shape, dtype=torch.int8, device=device),
            "k_scale": torch.zeros(shape[:3], dtype=torch.float32, device=device),
            "v_scale": torch.zeros(shape[:3], dtype=torch.float32, device=device),
        }
    return {"k": torch.zeros(shape, dtype=dtype, device=device),
            "v": torch.zeros(shape, dtype=dtype, device=device)}


def _paged_write(cache, k_rows, v_rows, page, row, *, backend: str):
    """Write per-token k/v rows (T, KV, hd) into the pool at (page, row), both
    (T,) indices. Idle / invalid tokens carry page 0 (the null page), so
    their writes land there without masking. int8 pools quantize each
    (token, kv-head) row and write codes and scales in place, k and v in one
    launch (``absmax_quant_write_pages``; page and row int32)."""
    if "kq" in cache:
        write = (kref.absmax_quant_write_pages_ref if _plain(backend)
                 else qz.absmax_quant_write_pages)
        write(k_rows, v_rows, cache, page, row)
    else:
        page, row = page.long(), row.long()
        cache["k"][page, row] = k_rows.to(cache["k"].dtype)
        cache["v"][page, row] = v_rows.to(cache["v"].dtype)
    return cache


def _paged_attend_multi(cache, q, tables, key_mask):
    """Chunked-prefill attention against gathered pages, plain PyTorch as in
    the reference (this path is compute-bound; the kernel covers the
    memory-bound decode). q (S, C, H, hd); tables (S, maxp); key_mask (S, C,
    L) True = visible. Returns (S, C, H, hd)."""
    H, hd = q.shape[2], q.shape[3]
    if "kq" in cache:
        k_flat = kref.paged_gather_ref(cache["kq"], tables).float()
        v_flat = kref.paged_gather_ref(cache["vq"], tables).float()
        k_flat = k_flat * kref.paged_gather_ref(cache["k_scale"], tables)[..., None]
        v_flat = v_flat * kref.paged_gather_ref(cache["v_scale"], tables)[..., None]
    else:
        k_flat = kref.paged_gather_ref(cache["k"], tables)
        v_flat = kref.paged_gather_ref(cache["v"], tables)
    rep = H // k_flat.shape[2]
    k_e = torch.repeat_interleave(k_flat, rep, dim=2) if rep > 1 else k_flat
    v_e = torch.repeat_interleave(v_flat, rep, dim=2) if rep > 1 else v_flat
    logits = torch.einsum("schd,slhd->shcl", q, k_e).float() * kref.attn_scale(hd)
    logits = torch.where(key_mask[:, None, :, :], logits,
                         torch.tensor(_NEG_INF, device=logits.device))
    w = kref.softmax_ref(logits)
    return torch.einsum("shcl,slhd->schd", w.to(v_e.dtype), v_e)


def paged_attn_decode(p, cfg: ModelConfig, cache, x_t, lengths, tables, *,
                      backend: str = "auto"):
    """Paged decode: x_t (S,1,d); lengths (S,) int32 tokens already cached per
    slot (= the rope position of x_t); tables (S, max_pages) int32. Writes
    k_t / v_t at page ``tables[s, lengths[s] // P]`` row ``lengths[s] % P``
    (idle slots point at the null page), then attends over the slot's pages
    through the paged-attention kernel (f32 / bf16 pages) or the int8 route.
    Returns (y (S,1,d), cache)."""
    S = x_t.shape[0]
    lengths = lengths.to(torch.int32)
    q, k_t, v_t = _qkv(p, cfg, x_t, lengths[:, None])
    P = (cache["kq"] if "kq" in cache else cache["k"]).shape[1]
    page = torch.gather(tables, 1, (lengths // P).long()[:, None])[:, 0]
    _paged_write(cache, k_t[:, 0], v_t[:, 0], page, lengths % P, backend=backend)
    n_valid = lengths + 1
    q0 = q[:, 0].contiguous()
    if "kq" in cache:
        attend = kref.paged_attn_decode_q8_ref if _plain(backend) else \
            paged_kernels.paged_attn_decode_q8
        out = attend(q0, cache["kq"], cache["vq"], cache["k_scale"], cache["v_scale"],
                     tables, n_valid)
    else:
        attend = kref.paged_attn_decode_ref if _plain(backend) else \
            paged_kernels.paged_attn_decode
        out = attend(q0, cache["k"], cache["v"], tables, n_valid)
    return out.reshape(S, 1, -1) @ p["wo"], cache


def paged_attn_prefill_chunk(p, cfg: ModelConfig, cache, x, start: int, table_row,
                             n_valid: int, *, backend: str = "auto"):
    """One request's prompt chunk: x (1, C, d) holds prompt tokens [start,
    start+C) with only the first ``n_valid`` real. Writes their k/v rows into
    the pages of ``table_row`` (max_pages,) int32, then attends causally over
    everything the request has cached (earlier chunks included: the writes
    land before the gather). Returns (y (1, C, d), cache)."""
    C = x.shape[1]
    offs = torch.arange(C, dtype=torch.int32, device=x.device)
    tok = start + offs
    q, k, v = _qkv(p, cfg, x, tok[None])
    P = (cache["kq"] if "kq" in cache else cache["k"]).shape[1]
    maxp = table_row.shape[0]
    # a padded token past the row's last page reads the last entry, as XLA
    # clamps an out-of-range gather; it is invalid and writes the null page
    idx = torch.clamp(tok // P, max=maxp - 1).long()
    page = torch.where(offs < n_valid, table_row[idx], torch.zeros_like(table_row[idx]))
    _paged_write(cache, k[0], v[0], page, tok % P, backend=backend)
    key_mask = (torch.arange(maxp * P, device=x.device)[None, :] <= tok[:, None])[None]
    out = _paged_attend_multi(cache, q, table_row[None], key_mask)
    return out.reshape(1, C, -1) @ p["wo"], cache

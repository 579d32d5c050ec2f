"""Attention mixers — port of ``repro.models.attention``: GQA (global and
sliding-window) and DeepSeek MLA, for training (``init_attn``, ``_qkv``,
``chunked_attention``, ``attn_train``; ``init_mla``, ``_mla_qkv``,
``mla_train``), dense-cache decode (``init_attn_cache``, ``attn_decode``;
``init_mla_cache``, ``mla_decode``) and the paged-KV serving engine
(``init_paged_attn_cache``, ``_paged_write``, ``_paged_attend_multi``,
``paged_attn_decode``, ``paged_attn_prefill_chunk``).

Training runs the chunked online-softmax formulation of the reference:
memory O(S·chunk) instead of O(S²). Sliding-window layers (``local``) visit
only the two kv chunks that can meet the window (window ≤ chunk), merged in
the reference's order. Decode attends one query token against the cache:
the full (B, S, KV, hd) cache for global attention, a ring of
min(window, max_len) slots for local attention, and for MLA the latent
(B, S, kv_lora_rank) + (B, S, rope_dim) cache with the queries absorbed
through ``w_uk``. The caches are written in place (the reference returns
new ones): each function still returns the cache it was given, so callers
keep the reference's ``(y, cache) = f(cache, ...)`` contract. The paged
functions take the reference's ``backend``: ``auto`` runs the kernel
wrappers (the kernels on CUDA tensors, their plain versions on CPU ones),
``ref`` the plain versions.
"""

from __future__ import annotations

import math
from typing import Any

import torch

from repro_torch.kernels import paged as paged_kernels
from repro_torch.kernels import quantize as qz
from repro_torch.kernels import ref as kref

from .config import MLAConfig, ModelConfig
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


def chunked_attention(q, k, v, positions, *, window: int | None = None,
                      chunk: int = 1024) -> torch.Tensor:
    """Causal (optionally banded) attention. q (B,S,H,hd), k/v (B,S,KV,hd),
    positions (B,S). With a ``window`` a query sees keys less than
    ``window`` positions back."""
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
    if window is not None:
        # the banded path only visits chunks {qi-1, qi}; with a single chunk
        # plain causal masking already covers any window
        assert window <= chunk or nch == 1, "sliding window must fit one chunk"
    rep = H // KV

    def expand(x):  # GQA: repeat kv heads to H
        return torch.repeat_interleave(x, rep, dim=2) if rep > 1 else x

    def block(i):
        return slice(i * chunk, (i + 1) * chunk)

    def mask_fn(pq, pk):
        m = pk[:, None, :] <= pq[:, :, None]
        if window is not None:
            m &= (pq[:, :, None] - pk[:, None, :]) < window
        return m

    outs = []
    for qi in range(nch):
        q_i, p_i = q[:, block(qi)], positions[:, block(qi)]
        carry = (
            torch.full((B, H, chunk), _NEG_INF, dtype=torch.float32, device=q.device),
            torch.zeros((B, H, chunk), dtype=torch.float32, device=q.device),
            torch.zeros((B, chunk, H, hd_v), dtype=v.dtype, device=q.device),
        )
        # (kv chunk, live): banded, chunk qi-1 then qi (for qi = 0 an
        # all-masked merge first, as the reference's order has it); global,
        # chunks 0 … qi (the ones past the diagonal are fully masked)
        visits = ([(max(qi - d, 0), qi - d >= 0) for d in (1, 0)] if window is not None
                  else [(kj, True) for kj in range(qi + 1)])
        for kj, live in visits:
            mask = mask_fn(p_i, positions[:, block(kj)]) & live
            carry = _merge(carry, *_attend_chunk(q_i, expand(k[:, block(kj)]),
                                                 expand(v[:, block(kj)]), mask))
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
    if cfg.pos_emb == "rope":  # sinusoidal positions are added to the embeddings
        q = rope(q, positions, cfg.rope_theta)
        k = rope(k, positions, cfg.rope_theta)
    return q, k, v


def attn_train(p, cfg: ModelConfig, x, positions, *, local: bool, chunk: int = 1024):
    """Causal GQA attention of one layer, global or sliding-window
    (``local``): x (B,S,d) → (B,S,d)."""
    B, S, _ = x.shape
    q, k, v = _qkv(p, cfg, x, positions)
    window = cfg.window if local else None
    chunk = max(chunk, window or 0)
    out = chunked_attention(q, k, v, positions, window=window, chunk=chunk)
    return out.reshape(B, S, -1) @ p["wo"]


# ---------------------------------------------------------------------------
# Dense-cache decode (the static-batching serving path)
# ---------------------------------------------------------------------------


def init_attn_cache(cfg: ModelConfig, B: int, max_len: int, *, local: bool, dtype,
                    device):
    """(B, L, KV, hd) k and v: L = max_len, or for a sliding-window layer a
    ring of min(window, max_len) slots."""
    KV, hd = cfg.num_kv_heads, cfg.resolved_head_dim
    L = min(cfg.window, max_len) if local else max_len
    return {
        "k": torch.zeros((B, L, KV, hd), dtype=dtype, device=device),
        "v": torch.zeros((B, L, KV, hd), dtype=dtype, device=device),
    }


def attn_decode(p, cfg: ModelConfig, cache, x_t, pos: int, *, local: bool):
    """x_t (B,1,d); pos the current absolute position. Writes k_t / v_t at
    ``pos`` (a ring layer: at ``pos % L``), then attends over the positions
    ≤ pos (a ring layer: within the window). Returns (y, cache)."""
    B = x_t.shape[0]
    H, KV, hd = cfg.num_heads, cfg.num_kv_heads, cfg.resolved_head_dim
    positions = torch.full((B, 1), pos, dtype=torch.int32, device=x_t.device)
    q, k_t, v_t = _qkv(p, cfg, x_t, positions)
    k, v = cache["k"], cache["v"]
    L = k.shape[1]
    slot = pos % L if local else pos
    k[:, slot] = k_t[:, 0].to(k.dtype)
    v[:, slot] = v_t[:, 0].to(v.dtype)
    idx = torch.arange(L, device=k.device)
    # ring: slot s holds the absolute position p with p % L == s, the newest
    # write at ``slot``; valid where 0 <= pos - kpos < window
    kpos = pos - (slot - idx) % L if local else idx
    valid = (kpos >= 0) & (kpos <= pos)
    if local:
        valid &= (pos - kpos) < cfg.window
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


# ---------------------------------------------------------------------------
# DeepSeek MLA
# ---------------------------------------------------------------------------


def init_mla(gen, cfg: ModelConfig, dtype, device):
    m: MLAConfig = cfg.mla
    d, H = cfg.d_model, cfg.num_heads
    qd = m.qk_nope_head_dim + m.qk_rope_head_dim
    return {
        "w_dq": init_dense(gen, d, m.q_lora_rank, dtype, device),
        "q_ln": init_rmsnorm(m.q_lora_rank, dtype, device),
        "w_uq": init_dense(gen, m.q_lora_rank, H * qd, dtype, device),
        "w_dkv": init_dense(gen, d, m.kv_lora_rank, dtype, device),
        "kv_ln": init_rmsnorm(m.kv_lora_rank, dtype, device),
        "w_kr": init_dense(gen, d, m.qk_rope_head_dim, dtype, device),
        "w_uk": init_dense(gen, m.kv_lora_rank, H * m.qk_nope_head_dim, dtype, device),
        "w_uv": init_dense(gen, m.kv_lora_rank, H * m.v_head_dim, dtype, device),
        "wo": init_dense(gen, H * m.v_head_dim, d, dtype, device),
    }


def _mla_qkv(p, cfg: ModelConfig, x, positions):
    """→ (q_nope (B,S,H,nope), q_rope (B,S,H,rd), the latent ckv (B,S,r),
    k_rope (B,S,1,rd) shared across heads)."""
    m: MLAConfig = cfg.mla
    B, S, _ = x.shape
    cq = rmsnorm(x @ p["w_dq"], p["q_ln"], cfg.norm_eps)
    q = (cq @ p["w_uq"]).reshape(B, S, cfg.num_heads, -1)
    q_nope, q_rope = q[..., :m.qk_nope_head_dim], q[..., m.qk_nope_head_dim:]
    q_rope = rope(q_rope, positions, cfg.rope_theta)
    ckv = rmsnorm(x @ p["w_dkv"], p["kv_ln"], cfg.norm_eps)
    k_rope = rope((x @ p["w_kr"])[:, :, None, :], positions, cfg.rope_theta)
    return q_nope, q_rope, ckv, k_rope


def mla_train(p, cfg: ModelConfig, x, positions, *, chunk: int = 1024):
    """MLA of one layer with the keys and values expanded per head: x
    (B,S,d) → (B,S,d)."""
    m: MLAConfig = cfg.mla
    B, S, _ = x.shape
    H = cfg.num_heads
    q_nope, q_rope, ckv, k_rope = _mla_qkv(p, cfg, x, positions)
    k_nope = (ckv @ p["w_uk"]).reshape(B, S, H, m.qk_nope_head_dim)
    v = (ckv @ p["w_uv"]).reshape(B, S, H, m.v_head_dim)
    q = torch.cat([q_nope, q_rope], dim=-1)
    k = torch.cat([k_nope, k_rope.expand(B, S, H, m.qk_rope_head_dim)], dim=-1)
    out = chunked_attention(q, k, v, positions, window=None, chunk=chunk)
    return out.reshape(B, S, -1) @ p["wo"]


def init_mla_cache(cfg: ModelConfig, B: int, max_len: int, dtype, device):
    m: MLAConfig = cfg.mla
    return {
        "ckv": torch.zeros((B, max_len, m.kv_lora_rank), dtype=dtype, device=device),
        "k_rope": torch.zeros((B, max_len, m.qk_rope_head_dim), dtype=dtype, device=device),
    }


def mla_decode(p, cfg: ModelConfig, cache, x_t, pos: int):
    """Weight-absorbed MLA decode against the latent cache: the queries
    absorbed through ``w_uk``, attention and PV in the latent space, then
    one ``w_uv`` projection per head. Returns (y, cache)."""
    m: MLAConfig = cfg.mla
    B = x_t.shape[0]
    H = cfg.num_heads
    positions = torch.full((B, 1), pos, dtype=torch.int32, device=x_t.device)
    q_nope, q_rope, ckv_t, kr_t = _mla_qkv(p, cfg, x_t, positions)
    ckv, k_rope = cache["ckv"], cache["k_rope"]
    ckv[:, pos] = ckv_t[:, 0].to(ckv.dtype)
    k_rope[:, pos] = kr_t[:, 0, 0].to(k_rope.dtype)
    w_uk = p["w_uk"].reshape(m.kv_lora_rank, H, m.qk_nope_head_dim)
    q_eff = torch.einsum("bqhd,rhd->bqhr", q_nope, w_uk)
    logits = (torch.einsum("bqhr,bkr->bhqk", q_eff, ckv)
              + torch.einsum("bqhd,bkd->bhqk", q_rope, k_rope)).float() \
        * kref.attn_scale(m.qk_nope_head_dim + m.qk_rope_head_dim)
    valid = torch.arange(ckv.shape[1], device=ckv.device) <= pos
    logits = torch.where(valid[None, None, None, :], logits,
                         torch.tensor(_NEG_INF, device=logits.device))
    w = kref.softmax_ref(logits)
    lat = torch.einsum("bhqk,bkr->bqhr", w.to(ckv.dtype), ckv)     # (B,1,H,r)
    w_uv = p["w_uv"].reshape(m.kv_lora_rank, H, m.v_head_dim)
    out = torch.einsum("bqhr,rhd->bqhd", lat, w_uv)
    return out.reshape(B, 1, -1) @ p["wo"], cache

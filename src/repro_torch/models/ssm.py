"""Recurrent mixers — port of ``repro.models.ssm``: the causal depthwise
conv, RG-LRU (RecurrentGemma / Griffin), mLSTM and sLSTM (xLSTM).

* RG-LRU is a diagonal linear recurrence. It trains through
  :func:`associative_scan`, which follows ``jax.lax.associative_scan``'s
  combine tree with tensor slicing — adjacent pairs combined, the scan of
  the pairs by recursion, then the even elements filled in — so products
  and sums round in the reference's order. It is log-depth, and autograd
  differentiates it as it is.
* mLSTM trains chunkwise (chunks of min(256, S), S a multiple of it): an
  attention-like product inside a chunk, the (hd × hd) matrix memory
  handed across chunk boundaries, the exponential gates stabilized by a
  running log-scale max; decode is one cell.
* sLSTM's gates read h_{t−1}: a loop over S of the cell, with head-wise
  recurrent matrices; its state is O(d).

The gates, states and recurrences run in float32 whatever the model's
dtype, as the reference's do; a float64 model keeps float64 throughout
(``chip_smoke.py`` checks float32 decode against it). The elementwise
functions are ``jax.nn``'s: GELU is the tanh approximation, softplus is
``logaddexp(x, 0)`` with JAX's gradient rule, SiLU is x·sigmoid(x), and the
log forget gate −softplus(−x) is ``torch.nn.functional.logsigmoid`` (the
same formula fused into one kernel: within 2.4e-7 of JAX's on [−40, 40],
its gradient within 6.2e-7 relative). Maxima split their gradient evenly
over ties (``torch.amax``, ``torch.maximum``), as JAX's do. Decode for all
three is one recurrent update, O(1) in the sequence length; like the
attention caches it writes the state in place and returns it.
"""

from __future__ import annotations

import math

import numpy as np
import torch
from torch.nn.functional import logsigmoid

from .config import ModelConfig
from .layers import init_dense, init_rmsnorm, rmsnorm

_RG_C = 8.0
#: where the stabilizer's running max starts
_M0 = -1e30
#: mLSTM chunk length (training and prefill)
MLSTM_CHUNK = 256

# ---------------------------------------------------------------------------
# jax.nn's elementwise functions
# ---------------------------------------------------------------------------

_SQRT_2_OVER_PI = float(np.sqrt(2 / np.pi).astype(np.float32))


def gelu(x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.gelu``: the tanh approximation, in the reference's form."""
    cdf = 0.5 * (1.0 + torch.tanh(_SQRT_2_OVER_PI * (x + 0.044715 * (x * x * x))))
    return x * cdf


class _Softplus(torch.autograd.Function):
    """``jax.nn.softplus`` = ``logaddexp(x, 0)``: max(x, 0) + log1p(exp(−|x|))
    (x where that is NaN), differentiated by JAX's rule
    g·exp(x − softplus(x)), a +inf replaced by 0."""

    @staticmethod
    def forward(ctx, x):
        out = torch.clamp_min(x, 0.0) + torch.log1p(torch.exp(-torch.abs(x)))
        out = torch.where(torch.isnan(x), x, out)
        ctx.save_for_backward(x, out)
        return out

    @staticmethod
    def backward(ctx, g):
        x, out = ctx.saved_tensors
        finite = lambda t: torch.where(torch.isposinf(t), torch.zeros_like(t), t)  # noqa: E731
        return g * torch.exp(finite(x) - finite(out))


def softplus(x: torch.Tensor) -> torch.Tensor:
    return _Softplus.apply(x)


def silu(x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.silu``: x·sigmoid(x)."""
    return x * torch.sigmoid(x)


def _acc_dtype(dtype) -> torch.dtype:
    """The recurrences' dtype: float32, as the reference computes them, or
    float64 for a float64 model (an exact reference to check float32
    against)."""
    return torch.float64 if dtype == torch.float64 else torch.float32


def _acc(t: torch.Tensor) -> torch.Tensor:
    return t.to(_acc_dtype(t.dtype))


def _const(value: float, like: torch.Tensor) -> torch.Tensor:
    return torch.tensor(value, dtype=like.dtype, device=like.device)


def _div(x: torch.Tensor, d: float) -> torch.Tensor:
    """x / d as a true division (a 0-d divisor on x's device: PyTorch turns
    a division by a Python scalar into a multiply by its reciprocal on
    CUDA)."""
    return x / _const(d, x)


def _sqrt_f32(n: int) -> float:
    """``jnp.sqrt(n)`` of a Python int: the square root in float32."""
    return float(np.sqrt(np.float32(n)))


# ---------------------------------------------------------------------------
# the associative scan
# ---------------------------------------------------------------------------


def _sl(t: torch.Tensor, axis: int, start, stop=None, step=None) -> torch.Tensor:
    return t[(slice(None),) * axis + (slice(start, stop, step),)]


def _interleave(a: torch.Tensor, b: torch.Tensor, axis: int) -> torch.Tensor:
    """a at the even positions of ``axis``, b at the odd ones (a has as many
    elements as b, or one more)."""
    extra = a.shape[axis] - b.shape[axis]
    head = _sl(a, axis, 0, a.shape[axis] - extra)
    out = torch.stack([head, b], dim=axis + 1).flatten(axis, axis + 1)
    return torch.cat([out, _sl(a, axis, -1)], dim=axis) if extra else out


def associative_scan(fn, elems, axis: int = 0) -> tuple:
    """``jax.lax.associative_scan(fn, elems, axis=axis)`` for a tuple of
    tensors, in its combine order: ``fn(a, b)`` combines two tuples of
    equal-shaped tensors elementwise (``a`` before ``b`` in the sequence)."""
    elems = tuple(elems)

    def scan(elems):
        n = elems[0].shape[axis]
        if n < 2:
            return elems
        pairs = fn(tuple(_sl(e, axis, 0, -1, 2) for e in elems),
                   tuple(_sl(e, axis, 1, None, 2) for e in elems))
        odd = scan(tuple(pairs))
        rest = tuple(_sl(e, axis, 2, None, 2) for e in elems)
        if n % 2 == 0:
            even = fn(tuple(_sl(e, axis, 0, -1) for e in odd), rest)
        else:
            even = fn(odd, rest)
        even = [torch.cat([_sl(e, axis, 0, 1), r], dim=axis) for e, r in zip(elems, even)]
        return tuple(_interleave(e, o, axis) for e, o in zip(even, odd))

    return scan(elems)


# ---------------------------------------------------------------------------
# Temporal conv (RG-LRU and mLSTM blocks)
# ---------------------------------------------------------------------------


def _uniform(gen, shape, lo: float, hi: float, dtype, device):
    if torch.device(device).type == "meta":
        return torch.empty(shape, dtype=dtype, device="meta")
    return (torch.rand(shape, generator=gen, device=device) * (hi - lo) + lo).to(dtype)


def init_conv1d(gen, width: int, channels: int, dtype, device):
    if torch.device(device).type == "meta":
        w = torch.empty((width, channels), dtype=dtype, device="meta")
    else:
        w = (torch.randn((width, channels), generator=gen, device=device) / width).to(dtype)
    return {"w": w, "b": torch.zeros((channels,), dtype=dtype, device=device)}


def causal_conv1d(p, x: torch.Tensor) -> torch.Tensor:
    """Depthwise causal conv. x (B,S,C); kernel (W,C)."""
    W, S = p["w"].shape[0], x.shape[1]
    pad = torch.nn.functional.pad(x, (0, 0, W - 1, 0))
    out = sum(pad[:, i:i + S, :] * p["w"][i][None, None, :] for i in range(W))
    return out + p["b"]


def conv1d_decode(p, state: torch.Tensor, x_t: torch.Tensor):
    """state (B, W-1, C) holds the last W-1 inputs; x_t (B,1,C). Returns
    (out (B,1,C), the next state)."""
    window = torch.cat([state, x_t], dim=1)  # (B, W, C)
    out = torch.einsum("bwc,wc->bc", window, p["w"]) + p["b"]
    return out[:, None, :], window[:, 1:, :]


def _write(state: dict, new: dict) -> dict:
    for k, v in new.items():
        state[k].copy_(v)
    return state


# ---------------------------------------------------------------------------
# RG-LRU
# ---------------------------------------------------------------------------


def init_rglru(gen, cfg: ModelConfig, dtype, device):
    d, w = cfg.d_model, cfg.resolved_lru_width
    return {
        "w_x": init_dense(gen, d, w, dtype, device),
        "w_y": init_dense(gen, d, w, dtype, device),
        "conv": init_conv1d(gen, cfg.conv_width, w, dtype, device),
        "w_a": init_dense(gen, w, w, dtype, device, scale=0.02),
        "w_i": init_dense(gen, w, w, dtype, device, scale=0.02),
        # Λ drawn so that a ∈ (0.9, 0.999) at r = 1 (Griffin §2.4)
        "lam": _uniform(gen, (w,), 0.7, 5.0, dtype, device),
        "w_out": init_dense(gen, w, d, dtype, device),
    }


def _rglru_gates(p, u: torch.Tensor):
    """u (B,S,w) (post-conv). Returns the per-step decay a and input b."""
    r = torch.sigmoid(_acc(u @ p["w_a"]))
    i = torch.sigmoid(_acc(u @ p["w_i"]))
    log_a = -_RG_C * softplus(_acc(p["lam"])) * r
    a = torch.exp(log_a)
    gated = torch.sqrt(torch.maximum(1.0 - torch.exp(2.0 * log_a), _const(1e-6, log_a))) * (
        i * _acc(u))
    return a, gated


def _rglru_combine(left, right):
    a1, b1 = left
    a2, b2 = right
    return a1 * a2, a2 * b1 + b2


def _rglru(p, cfg: ModelConfig, x: torch.Tensor):
    """→ (output, the scan's h (B,S,w) f32, x @ w_x)."""
    y = gelu(x @ p["w_y"])
    xw = x @ p["w_x"]
    a, b = _rglru_gates(p, causal_conv1d(p["conv"], xw))
    _, h = associative_scan(_rglru_combine, (a, b), axis=1)
    return (h.to(x.dtype) * y) @ p["w_out"], h, xw


def rglru_train(p, cfg: ModelConfig, x: torch.Tensor) -> torch.Tensor:
    """Griffin recurrent block: conv + RG-LRU gated by a GeLU branch."""
    return _rglru(p, cfg, x)[0]


def rglru_prefill(p, cfg: ModelConfig, x: torch.Tensor):
    """→ (output, the decode state after x): the scan's last h and the last
    W−1 conv inputs."""
    y, h, xw = _rglru(p, cfg, x)
    return y, {"h": h[:, -1], "conv": xw[:, -(cfg.conv_width - 1):, :]}


def init_rglru_state(cfg: ModelConfig, B: int, dtype, device):
    w = cfg.resolved_lru_width
    return {
        "h": torch.zeros((B, w), dtype=_acc_dtype(dtype), device=device),
        "conv": torch.zeros((B, cfg.conv_width - 1, w), dtype=dtype, device=device),
    }


def rglru_decode(p, cfg: ModelConfig, state, x_t: torch.Tensor):
    y = gelu(x_t @ p["w_y"])
    u, conv_state = conv1d_decode(p["conv"], state["conv"], x_t @ p["w_x"])
    a, b = _rglru_gates(p, u)
    h = a[:, 0] * state["h"] + b[:, 0]
    out = (h[:, None, :].to(x_t.dtype) * y) @ p["w_out"]
    return out, _write(state, {"h": h, "conv": conv_state})


# ---------------------------------------------------------------------------
# mLSTM (matrix memory, exponential gating) — chunkwise-parallel
# ---------------------------------------------------------------------------


def init_mlstm(gen, cfg: ModelConfig, dtype, device):
    d = cfg.d_model
    inner = int(cfg.mlstm_proj_factor * d)
    H = cfg.num_heads
    assert inner % H == 0
    return {
        "w_up": init_dense(gen, d, 2 * inner, dtype, device),
        "conv": init_conv1d(gen, cfg.conv_width, inner, dtype, device),
        "w_q": init_dense(gen, inner, inner, dtype, device),
        "w_k": init_dense(gen, inner, inner, dtype, device),
        "w_v": init_dense(gen, inner, inner, dtype, device),
        "w_if": init_dense(gen, inner, 2 * H, dtype, device, scale=0.02),
        "out_norm": init_rmsnorm(inner, dtype, device),
        "w_down": init_dense(gen, inner, d, dtype, device),
    }


def _mlstm_proj(p, cfg: ModelConfig, x: torch.Tensor):
    """→ (q, k, v (B,S,H,hd), log_i, log_f (B,S,H) f32, z, xm)."""
    B, S, _ = x.shape
    H = cfg.num_heads
    inner = p["w_q"].shape[0]
    hd = inner // H
    xm, z = torch.chunk(x @ p["w_up"], 2, dim=-1)
    c = silu(causal_conv1d(p["conv"], xm))
    q = (c @ p["w_q"]).reshape(B, S, H, hd)
    k = _div((c @ p["w_k"]).reshape(B, S, H, hd), _sqrt_f32(hd))
    v = (xm @ p["w_v"]).reshape(B, S, H, hd)
    gates = _acc(c @ p["w_if"]).reshape(B, S, H, 2)
    log_i = gates[..., 0]                 # pre-activation of the exp input gate
    log_f = logsigmoid(gates[..., 1])   # log sigmoid forget gate
    return q, k, v, log_i, log_f, z, xm


def _mlstm_chunks(p, cfg: ModelConfig, x: torch.Tensor, proj, chunk: int) -> torch.Tensor:
    B, S, _ = x.shape
    H = cfg.num_heads
    q, k, v, log_i, log_f, z, _ = proj
    hd = q.shape[3]
    chunk = min(chunk, S)
    if S % chunk:
        raise ValueError(f"mLSTM: S = {S} is not a multiple of the chunk {chunk} "
                         f"(S ≤ {MLSTM_CHUNK} or a multiple of it)")
    nch = S // chunk

    def resh(t):
        return t.reshape(B, nch, chunk, H, *t.shape[3:]).transpose(2, 3)

    qc, kc, vc = _acc(resh(q)), _acc(resh(k)), _acc(resh(v))  # (B,nch,H,chunk,hd)
    lic, lfc = resh(log_i), resh(log_f)                              # (B,nch,H,chunk)
    F = torch.cumsum(lfc, dim=-1)       # within-chunk Σ log f
    Ftot = F[..., -1]                   # (B,nch,H)
    dev = x.device
    acc = qc.dtype
    C = torch.zeros((B, H, hd, hd), dtype=acc, device=dev)
    n = torch.zeros((B, H, hd), dtype=acc, device=dev)
    m = torch.full((B, H), _M0, dtype=acc, device=dev)
    causal = torch.tril(torch.ones((chunk, chunk), dtype=torch.bool, device=dev))
    neg_inf = torch.tensor(-math.inf, dtype=acc, device=dev)
    hs = []
    for idx in range(nch):
        qi, ki, vi = qc[:, idx], kc[:, idx], vc[:, idx]
        Fi, li, ftot = F[:, idx], lic[:, idx], Ftot[:, idx]
        # log weights: inter-chunk q_t C: F_t + m_prev; intra-chunk (s ≤ t):
        # F_t − F_s + log i_s
        log_inter = Fi + m[..., None]                                   # (B,H,chunk)
        log_intra = Fi[..., :, None] - Fi[..., None, :] + li[..., None, :]
        log_intra = torch.where(causal, log_intra, neg_inf)
        m_new = torch.maximum(torch.amax(log_intra, dim=-1), log_inter)
        w_inter = torch.exp(log_inter - m_new)
        w_intra = torch.exp(log_intra - m_new[..., None])               # (B,H,chunk,chunk)

        h_inter = torch.einsum("bhtd,bhde->bhte", qi, C) * w_inter[..., None]
        n_inter = torch.einsum("bhtd,bhd->bht", qi, n) * w_inter
        scores = torch.einsum("bhtd,bhsd->bhts", qi, ki) * w_intra.to(qi.dtype)
        h_intra = torch.einsum("bhts,bhse->bhte", scores, vi)
        n_intra = torch.sum(scores, dim=-1)
        denom = torch.maximum(torch.abs(n_inter + n_intra), torch.exp(-m_new))
        hs.append((h_inter + h_intra) / denom[..., None].to(qi.dtype))

        # boundary state update (stabilized at scale m_run), as the reference
        m_run = torch.maximum(ftot + m, torch.amax(Fi * 0 + li + (ftot[..., None] - Fi),
                                                   dim=-1))
        decay = torch.exp(ftot + m - m_run)
        w_in = torch.exp(ftot[..., None] - Fi + li - m_run[..., None])  # (B,H,chunk)
        C = decay[..., None, None] * C + torch.einsum("bhs,bhsd,bhse->bhde", w_in, ki, vi)
        n = decay[..., None] * n + torch.einsum("bhs,bhsd->bhd", w_in, ki)
        m = m_run
    h = torch.stack(hs).permute(1, 0, 3, 2, 4).reshape(B, S, H * hd).to(x.dtype)
    h = rmsnorm(h, p["out_norm"], cfg.norm_eps)
    return (h * silu(z)) @ p["w_down"]


def mlstm_train(p, cfg: ModelConfig, x: torch.Tensor, *,
                chunk: int = MLSTM_CHUNK) -> torch.Tensor:
    """x (B,S,d) → (B,S,d); S ≤ ``chunk`` or a multiple of it, else
    ``ValueError`` (the reference asserts the same)."""
    return _mlstm_chunks(p, cfg, x, _mlstm_proj(p, cfg, x), chunk)


def mlstm_prefill(p, cfg: ModelConfig, x: torch.Tensor):
    """→ (output, the decode state after x). The state is not the chunk
    carry: (C, n, m) come from one whole-sequence formula (the reference's
    ``blocks._mlstm_train``), the conv state is the last W−1 inputs."""
    proj = _mlstm_proj(p, cfg, x)
    y = _mlstm_chunks(p, cfg, x, proj, MLSTM_CHUNK)
    _, k, v, log_i, log_f, _, xm = proj
    F = torch.cumsum(log_f, dim=1)  # (B,S,H)
    ftot = F[:, -1]
    m_run = torch.amax(ftot[:, None, :] - F + log_i, dim=1)
    w_in = torch.exp(ftot[:, None, :] - F + log_i - m_run[:, None, :])
    C = torch.einsum("bsh,bshd,bshe->bhde", w_in, _acc(k), _acc(v))
    n = torch.einsum("bsh,bshd->bhd", w_in, _acc(k))
    return y, {"C": C, "n": n, "m": m_run, "conv": xm[:, -(cfg.conv_width - 1):, :]}


def init_mlstm_state(cfg: ModelConfig, B: int, dtype, device):
    inner = int(cfg.mlstm_proj_factor * cfg.d_model)
    H = cfg.num_heads
    hd = inner // H
    return {
        "C": torch.zeros((B, H, hd, hd), dtype=_acc_dtype(dtype), device=device),
        "n": torch.zeros((B, H, hd), dtype=_acc_dtype(dtype), device=device),
        "m": torch.full((B, H), _M0, dtype=_acc_dtype(dtype), device=device),
        "conv": torch.zeros((B, cfg.conv_width - 1, inner), dtype=dtype, device=device),
    }


def mlstm_decode(p, cfg: ModelConfig, state, x_t: torch.Tensor):
    B = x_t.shape[0]
    H = cfg.num_heads
    inner = p["w_q"].shape[0]
    hd = inner // H
    xm, z = torch.chunk(x_t @ p["w_up"], 2, dim=-1)
    c_t, conv_state = conv1d_decode(p["conv"], state["conv"], xm)
    c_t = silu(c_t)
    q = _acc((c_t @ p["w_q"]).reshape(B, H, hd))
    k = _acc(_div((c_t @ p["w_k"]).reshape(B, H, hd), _sqrt_f32(hd)))
    v = _acc((xm @ p["w_v"]).reshape(B, H, hd))
    gates = _acc(c_t @ p["w_if"]).reshape(B, H, 2)
    log_i = gates[..., 0]
    log_f = logsigmoid(gates[..., 1])

    m_new = torch.maximum(log_f + state["m"], log_i)
    i_s = torch.exp(log_i - m_new)
    f_s = torch.exp(log_f + state["m"] - m_new)
    C = f_s[..., None, None] * state["C"] + i_s[..., None, None] * (
        k[..., :, None] * v[..., None, :])
    n = f_s[..., None] * state["n"] + i_s[..., None] * k
    num = torch.einsum("bhd,bhde->bhe", q, C)
    den = torch.maximum(torch.abs(torch.einsum("bhd,bhd->bh", q, n)), torch.exp(-m_new))
    h = (num / den[..., None]).reshape(B, 1, inner).to(x_t.dtype)
    h = rmsnorm(h, p["out_norm"], cfg.norm_eps)
    out = (h * silu(z)) @ p["w_down"]
    return out, _write(state, {"C": C, "n": n, "m": m_new, "conv": conv_state})


# ---------------------------------------------------------------------------
# sLSTM (scalar memory, recurrent gates) — sequential
# ---------------------------------------------------------------------------


def slstm_ff_width(cfg: ModelConfig) -> int:
    """The GeGLU feed-forward's width: proj factor · d rounded up to a
    multiple of 128 (1408 for xlstm-350m)."""
    return max(128, -(-int(cfg.slstm_proj_factor * cfg.d_model) // 128) * 128)


def init_slstm(gen, cfg: ModelConfig, dtype, device):
    d = cfg.d_model
    H = cfg.num_heads
    hd = d // H

    def rec():  # block-diagonal (head-wise) recurrent matrix
        if torch.device(device).type == "meta":
            return torch.empty((H, hd, hd), dtype=dtype, device="meta")
        return (torch.randn((H, hd, hd), generator=gen, device=device) * 0.02).to(dtype)

    f = slstm_ff_width(cfg)
    return {
        "w_in": init_dense(gen, d, 4 * d, dtype, device),     # z, i, f, o pre-acts
        "r_z": rec(),
        "r_i": rec(),
        "r_f": rec(),
        "r_o": rec(),
        "out_norm": init_rmsnorm(d, dtype, device),
        # GeGLU feed-forward (proj factor 4/3) folded into the block
        "ff_up": init_dense(gen, d, 2 * f, dtype, device),
        "ff_down": init_dense(gen, f, d, dtype, device),
    }


def _slstm_rec(p, dtype) -> torch.Tensor:
    """The four head-wise recurrent matrices side by side, (H, hd, 4·hd):
    one batched product a step gives the z, i, f and o terms (each output
    the same dot product over hd as the reference's four einsums)."""
    return torch.cat([p[k] for k in ("r_z", "r_i", "r_f", "r_o")], dim=-1).to(dtype)


def _slstm_cell(rec: torch.Tensor, eps: torch.Tensor, carry, pre_x: torch.Tensor):
    """carry: (c, n, h, m) each (H,B,hd), the recurrences' dtype; pre_x
    (H,B,4·hd) the input pre-activations (gate g of a head at
    [g·hd, (g+1)·hd)); rec the stacked recurrent matrices
    (:func:`_slstm_rec`), eps the 0-d floor 1e-6 of the normalizer. One
    ``baddbmm`` a step adds all four recurrent terms to the inputs.
    Returns the next carry and what the backward of the step needs:
    (z, i_s, f_s, o, f_p, lf_m, log_i, n_pre)."""
    c, n, h, m = carry
    H, B, hd = c.shape
    z_p, i_p, f_p, o_p = torch.baddbmm(pre_x, h, rec).reshape(H, B, 4, hd).unbind(2)
    z = torch.tanh(z_p)
    log_i = i_p
    log_f = logsigmoid(f_p)  # log σ(f̃)
    o = torch.sigmoid(o_p)

    lf_m = log_f + m
    m_new = torch.maximum(lf_m, log_i)
    i_s = torch.exp(log_i - m_new)
    f_s = torch.exp(lf_m - m_new)
    c_new = f_s * c + i_s * z
    n_pre = f_s * n + i_s
    n_new = torch.maximum(n_pre, eps)
    h_new = o * c_new / n_new
    return (c_new, n_new, h_new, m_new), (z, i_s, f_s, o, f_p, lf_m, log_i, n_pre)


def _max_share(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """∂max(a, b)/∂a as JAX and ``torch.maximum`` take it: 1 where a > b,
    ½ where a = b, 0 where a < b."""
    return torch.sign(a - b).add_(1.0).mul_(0.5)


class _SLSTMScan(torch.autograd.Function):
    """The sLSTM's loop over S (:func:`_slstm_cell` a step) with its
    backward written out. The loop is sequential, so a step costs its
    operations' dispatch more than their arithmetic: the forward records no
    autograd graph, every factor of the backward that does not depend on
    the recursion is computed for all S steps at once, and the recursion
    through (h, c, n, m) is ~20 operations a step. The gradients are those
    of the cell's operations (a maximum's split evenly over ties), rounded
    in another order than autograd's.

    pre (S,H,B,4·hd), rec (H,hd,4·hd), the carry (c, n, h, m) each (H,B,hd),
    eps 0-d → (hs (S,H,B,hd), c, n, h, m); the final carry takes no
    gradient."""

    @staticmethod
    def forward(ctx, pre, rec, c, n, h, m, eps):
        carry, keep, hs = (c, n, h, m), [], []
        for t in range(pre.shape[0]):
            carry, inner = _slstm_cell(rec, eps, carry, pre[t])
            hs.append(carry[2])
            keep.append((carry[0], carry[1]) + inner)
        hs_t = torch.stack(hs)
        ctx.mark_non_differentiable(*carry)
        if ctx.needs_input_grad[0] or ctx.needs_input_grad[1]:
            cs, ns, z, i_s, f_s, o, f_p, lf_m, log_i, n_pre = (torch.stack(v)
                                                                for v in zip(*keep))
            ctx.save_for_backward(
                rec, torch.cat([c[None], cs[:-1]]), torch.cat([n[None], ns[:-1]]),
                torch.cat([h[None], hs_t[:-1]]), ns, hs_t, o, z, i_s, f_s,
                i_s * (1.0 - z * z),                  # ∂c/∂z_p ÷ gc
                torch.sigmoid(-f_p),                  # ∂ log σ(f_p)/∂f_p
                cs * o * (1.0 - o),                   # ∂h/∂o_p ÷ (gh / n)
                _max_share(lf_m, log_i), _max_share(n_pre, eps))
        return (hs_t,) + carry

    @staticmethod
    def backward(ctx, g_hs, *_):
        (rec, c_prev, n_prev, h_prev, ns, hs, o, z, i_s, f_s, izd, sf, cdo, wm,
         wn) = ctx.saved_tensors
        S, H, B, hd = hs.shape
        rec_t = rec.transpose(1, 2)
        g_pre = torch.empty((S, H, B, 4, hd), dtype=hs.dtype, device=hs.device)
        zero = torch.zeros((H, B, hd), dtype=hs.dtype, device=hs.device)
        gh, gc, gn, gm = zero, zero, zero, zero
        for t in reversed(range(S)):
            gq = (gh + g_hs[t]) / ns[t]                  # h = (o·c) / n
            gc = torch.addcmul(gc, gq, o[t])
            gn = torch.addcmul(gn, gq, hs[t], value=-1.0)
            gn_pre = gn * wn[t]                          # n = max(n_pre, eps)
            gf_s = torch.addcmul(gn_pre * n_prev[t], gc, c_prev[t])
            gi_s = torch.addcmul(gn_pre, gc, z[t])
            ga, gb = gf_s * f_s[t], gi_s * i_s[t]        # the two exp's
            gm_new = gm - ga - gb                        # m = max(lf_m, log_i)
            gm = torch.addcmul(ga, gm_new, wm[t])        # ∂/∂lf_m, = ∂/∂m_prev
            gp = g_pre[t]
            torch.mul(gc, izd[t], out=gp[:, :, 0])
            torch.addcmul(gb, gm_new, 1.0 - wm[t], out=gp[:, :, 1])
            torch.mul(gm, sf[t], out=gp[:, :, 2])
            torch.mul(gq, cdo[t], out=gp[:, :, 3])
            gh = torch.bmm(gp.reshape(H, B, 4 * hd), rec_t)
            gc, gn = gc * f_s[t], gn_pre * f_s[t]
        g_pre = g_pre.reshape(S, H, B, 4 * hd)
        g_rec = torch.bmm(h_prev.permute(1, 3, 0, 2).reshape(H, hd, S * B),
                          g_pre.transpose(0, 1).reshape(H, S * B, 4 * hd))
        return g_pre, g_rec, gc, gn, gh, gm, None


def _slstm_pre(p, x: torch.Tensor, H: int) -> torch.Tensor:
    """x (B,S,d) → the input pre-activations x @ w_in (B,S,4d: z, i, f, o)
    step-major in the cell's layout, (S, H, B, 4·hd)."""
    B, S, d = x.shape
    hd = d // H
    wx = _acc(x @ p["w_in"]).reshape(B, S, 4, H, hd)
    return wx.permute(1, 3, 0, 2, 4).reshape(S, H, B, 4 * hd)


def _slstm_ff(p, cfg: ModelConfig, h: torch.Tensor) -> torch.Tensor:
    h = rmsnorm(h, p["out_norm"], cfg.norm_eps)
    a, b = torch.chunk(h @ p["ff_up"], 2, dim=-1)
    return (gelu(a) * b) @ p["ff_down"]


def _slstm(p, cfg: ModelConfig, x: torch.Tensor):
    """→ (output, the cell's final (c, n, h, m), each (B,H,hd))."""
    B, S, d = x.shape
    state = init_slstm_state(cfg, B, x.dtype, x.device)
    carry = tuple(state[k].transpose(0, 1) for k in "cnhm")
    hs, *carry = _SLSTMScan.apply(_slstm_pre(p, x, cfg.num_heads),
                                  _slstm_rec(p, carry[0].dtype), *carry,
                                  _const(1e-6, carry[0]))
    h = hs.permute(2, 0, 1, 3).reshape(B, S, d).to(x.dtype)
    return _slstm_ff(p, cfg, h), tuple(t.transpose(0, 1) for t in carry)


def slstm_train(p, cfg: ModelConfig, x: torch.Tensor) -> torch.Tensor:
    return _slstm(p, cfg, x)[0]


def slstm_prefill(p, cfg: ModelConfig, x: torch.Tensor):
    """→ (output, the cell's state after x)."""
    y, (c, n, h, m) = _slstm(p, cfg, x)
    return y, {"c": c, "n": n, "h": h, "m": m}


def init_slstm_state(cfg: ModelConfig, B: int, dtype, device):
    H = cfg.num_heads
    hd = cfg.d_model // H
    acc = _acc_dtype(dtype)
    z = lambda: torch.zeros((B, H, hd), dtype=acc, device=device)  # noqa: E731
    return {"c": z(), "n": z(), "h": z(),
            "m": torch.full((B, H, hd), _M0, dtype=acc, device=device)}


def slstm_decode(p, cfg: ModelConfig, state, x_t: torch.Tensor):
    B = x_t.shape[0]
    carry = tuple(state[k].transpose(0, 1) for k in "cnhm")
    (c, n, h, m), _ = _slstm_cell(_slstm_rec(p, carry[0].dtype), _const(1e-6, carry[0]),
                                  carry, _slstm_pre(p, x_t, cfg.num_heads)[0])
    out = _slstm_ff(p, cfg, h.transpose(0, 1).reshape(B, 1, cfg.d_model).to(x_t.dtype))
    return out, _write(state, {"c": c.transpose(0, 1), "n": n.transpose(0, 1),
                               "h": h.transpose(0, 1), "m": m.transpose(0, 1)})

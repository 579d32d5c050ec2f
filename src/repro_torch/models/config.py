"""Model configuration: one dataclass drives all 10 assigned architectures.

A model is a sequence of *segments*; each segment is a short period of
``LayerSpec``s repeated ``repeat`` times (params are stacked over the repeat
dimension and applied one slice at a time). This expresses every assigned layout:

* uniform dense stacks          — one segment, period 1
* gemma3 5 local : 1 global     — period 6 × 10 + a trailing (local, local)
* recurrentgemma (rec,rec,attn) — period 3 × 8 + trailing (rec, rec)
* llama4 alternating dense/MoE  — period 2 × 24
* xLSTM 7 mLSTM : 1 sLSTM       — period 8 × 3
* deepseek-v3 3 dense + 58 MoE  — two segments
"""

from __future__ import annotations

import dataclasses
from typing import Literal, Optional

Mixer = Literal["attn", "attn_local", "mla", "mlstm", "slstm", "rglru"]
FF = Literal["mlp", "moe", "none"]


@dataclasses.dataclass(frozen=True)
class LayerSpec:
    mixer: Mixer = "attn"
    ff: FF = "mlp"


@dataclasses.dataclass(frozen=True)
class Segment:
    period: tuple[LayerSpec, ...]
    repeat: int

    @property
    def num_layers(self) -> int:
        return len(self.period) * self.repeat


@dataclasses.dataclass(frozen=True)
class MLAConfig:
    """DeepSeek-V3 multi-head latent attention dims (arXiv:2412.19437)."""

    q_lora_rank: int = 1536
    kv_lora_rank: int = 512
    qk_nope_head_dim: int = 128
    qk_rope_head_dim: int = 64
    v_head_dim: int = 128


@dataclasses.dataclass(frozen=True)
class MoEConfig:
    num_experts: int = 8
    top_k: int = 2
    d_expert: int = 2048
    num_shared: int = 0            # shared (always-on) experts
    capacity_factor: float = 1.25  # per-expert slots = tokens*top_k/E * cf
    router_score: Literal["softmax", "sigmoid"] = "softmax"
    aux_loss_coef: float = 0.001   # load-balance loss


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    arch_type: str                       # dense|moe|ssm|hybrid|vlm|audio
    d_model: int
    num_heads: int
    num_kv_heads: int
    d_ff: int
    vocab_size: int
    segments: tuple[Segment, ...]

    head_dim: Optional[int] = None       # default d_model // num_heads
    qkv_bias: bool = False
    qk_norm: bool = False
    window: int = 1024                   # sliding window for attn_local mixers
    rope_theta: float = 10_000.0
    pos_emb: Literal["rope", "sinusoidal", "none"] = "rope"
    tie_embeddings: bool = False

    mla: Optional[MLAConfig] = None
    moe: Optional[MoEConfig] = None

    # SSM / hybrid
    lru_width: Optional[int] = None      # RG-LRU state width (default d_model)
    conv_width: int = 4                  # temporal conv in the recurrent block
    mlstm_proj_factor: float = 2.0       # mLSTM block up-projection
    slstm_proj_factor: float = 4.0 / 3.0

    # multi-token prediction (deepseek-v3); 0 = off
    mtp_depth: int = 0

    # modality frontend stub: model consumes precomputed embeddings
    frontend: Optional[Literal["vision", "audio"]] = None

    # norms
    norm_eps: float = 1e-6
    logit_softcap: float = 0.0

    # chunk width of the online-softmax attention (perf knob; must be ≥ window)
    attn_chunk: int = 1024

    # per-layer rematerialization in the training forward (saves only the
    # residual stream between layers; recomputes attention/FF in the backward)
    remat: bool = True

    @property
    def resolved_head_dim(self) -> int:
        return self.head_dim or self.d_model // self.num_heads

    @property
    def num_layers(self) -> int:
        return sum(s.num_layers for s in self.segments)

    @property
    def resolved_lru_width(self) -> int:
        return self.lru_width or self.d_model

    def supports_long_context(self) -> bool:
        """True if decode state is O(window)/O(1) per layer for every mixer —
        the sub-quadratic criterion for the long_500k shape."""
        kinds = {l.mixer for s in self.segments for l in s.period}
        return "attn" not in kinds and "mla" not in kinds


def dense_stack(n: int, mixer: Mixer = "attn", ff: FF = "mlp") -> tuple[Segment, ...]:
    return (Segment(period=(LayerSpec(mixer=mixer, ff=ff),), repeat=n),)


def reduced(cfg: ModelConfig, layers: int = 2, d_model: int = 256) -> ModelConfig:
    """Build the CPU-smoke-test variant of the same family (≤4 experts, tiny d).

    Every segment's structure survives (the period is preserved; only repeats,
    widths and expert counts shrink) so the smoke test exercises the same block
    types as the full config.
    """
    scale = d_model / cfg.d_model
    heads = max(2, min(4, cfg.num_heads))
    kv = max(1, min(heads, cfg.num_kv_heads if cfg.num_kv_heads < cfg.num_heads else heads))
    segs = []
    remaining = layers
    for s in cfg.segments:
        if remaining <= 0:
            break
        period = s.period[: max(1, min(len(s.period), remaining))]
        rep = max(1, min(s.repeat, -(-remaining // len(period))))
        rep = min(rep, max(1, remaining // len(period)) or 1)
        segs.append(Segment(period=period, repeat=rep))
        remaining -= len(period) * rep
    moe = None
    if cfg.moe is not None:
        moe = dataclasses.replace(
            cfg.moe,
            num_experts=min(4, cfg.moe.num_experts),
            top_k=min(2, cfg.moe.top_k),
            d_expert=max(32, int(cfg.moe.d_expert * scale)),
            num_shared=min(1, cfg.moe.num_shared),
            # generous capacity so CPU smoke/decode tests are drop-free
            # (capacity drops are legitimate train/serve skew at scale)
            capacity_factor=4.0,
        )
    mla = None
    if cfg.mla is not None:
        mla = MLAConfig(
            q_lora_rank=64, kv_lora_rank=32, qk_nope_head_dim=32,
            qk_rope_head_dim=16, v_head_dim=32,
        )
    return dataclasses.replace(
        cfg,
        d_model=d_model,
        num_heads=heads,
        num_kv_heads=kv,
        head_dim=None if cfg.head_dim is None else max(16, d_model // heads),
        d_ff=max(32, int(cfg.d_ff * scale)) if cfg.d_ff else 0,
        vocab_size=512,
        segments=tuple(segs),
        moe=moe,
        mla=mla,
        lru_width=None,
        window=16,
        mtp_depth=min(cfg.mtp_depth, 1),
    )

"""llama4-scout-17b-a16e [moe] — 48L d_model=5120 40H (kv=8) d_ff=8192,
vocab=202048; MoE 16 routed top-1 + 1 shared expert on every layer
(Scout interleave step 1 → 109B total / 17B active); early-fusion multimodal
in the published model — the text backbone is built here (frontend carve-out).
[hf:meta-llama/Llama-4-Scout-17B-16E]"""

from repro_torch.configs import ArchConfig
from repro_torch.models.config import LayerSpec, MoEConfig, ModelConfig, Segment


def get_config() -> ArchConfig:
    model = ModelConfig(
        name="llama4-scout-17b-a16e",
        arch_type="moe",
        d_model=5120,
        num_heads=40,
        num_kv_heads=8,
        d_ff=8192,
        vocab_size=202048,
        segments=(
            Segment(period=(LayerSpec(mixer="attn", ff="moe"),), repeat=48),
        ),
        moe=MoEConfig(
            num_experts=16,
            top_k=1,
            d_expert=8192,
            num_shared=1,
            router_score="softmax",
            capacity_factor=1.25,
        ),
        rope_theta=500_000.0,
        qk_norm=True,
    )
    # 109B total params — worker = pod on the multi-pod mesh, FSDP inside.
    return ArchConfig(model=model, worker_axes="pod", fsdp=True)

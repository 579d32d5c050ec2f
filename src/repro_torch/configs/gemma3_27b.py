"""gemma3-27b [dense] — 62L d_model=5376 32H (kv=16) d_ff=21504
vocab=262144; 5 local (window 1024) : 1 global attention, qk-norm,
head_dim=128. 62 = 6×10 + 2 → trailing (local, local) segment.
[hf:google/gemma-3 family card]"""

from repro_torch.configs import ArchConfig
from repro_torch.models.config import LayerSpec, ModelConfig, Segment


def get_config() -> ArchConfig:
    loc = LayerSpec(mixer="attn_local", ff="mlp")
    glb = LayerSpec(mixer="attn", ff="mlp")
    model = ModelConfig(
        name="gemma3-27b",
        arch_type="dense",
        d_model=5376,
        num_heads=32,
        num_kv_heads=16,
        head_dim=128,
        d_ff=21504,
        vocab_size=262144,
        segments=(
            Segment(period=(loc, loc, loc, loc, loc, glb), repeat=10),
            Segment(period=(loc, loc), repeat=1),
        ),
        window=1024,
        qk_norm=True,
        rope_theta=1_000_000.0,
        tie_embeddings=True,
    )
    return ArchConfig(model=model)

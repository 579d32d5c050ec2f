"""recurrentgemma-2b [hybrid] — 26L d_model=2560 10H (MQA kv=1) d_ff=7680,
vocab=256000; period (RG-LRU, RG-LRU, local-attn) ×8 + (RG-LRU, RG-LRU),
window 2048, lru_width=2560, tied embeddings. [arXiv:2402.19427]"""

from repro_torch.configs import ArchConfig
from repro_torch.models.config import LayerSpec, ModelConfig, Segment


def get_config() -> ArchConfig:
    rec = LayerSpec(mixer="rglru", ff="mlp")
    att = LayerSpec(mixer="attn_local", ff="mlp")
    model = ModelConfig(
        name="recurrentgemma-2b",
        arch_type="hybrid",
        d_model=2560,
        num_heads=10,
        num_kv_heads=1,
        head_dim=256,
        d_ff=7680,
        vocab_size=256000,
        segments=(
            Segment(period=(rec, rec, att), repeat=8),
            Segment(period=(rec, rec), repeat=1),
        ),
        window=2048,
        lru_width=2560,
        conv_width=4,
        tie_embeddings=True,
    )
    return ArchConfig(model=model)

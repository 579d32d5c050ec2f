"""internvl2-1b [vlm] — language backbone 24L d_model=896 14H (kv=2)
d_ff=4864 vocab=151655 (Qwen2-0.5B-style, QKV bias); the InternViT vision
encoder + MLP projector are stubbed — input_specs() provides projected patch
embeddings as a prefix. [arXiv:2404.16821]"""

from repro_torch.configs import ArchConfig
from repro_torch.models.config import ModelConfig, dense_stack


def get_config() -> ArchConfig:
    model = ModelConfig(
        name="internvl2-1b",
        arch_type="vlm",
        d_model=896,
        num_heads=14,
        num_kv_heads=2,
        d_ff=4864,
        vocab_size=151655,
        segments=dense_stack(24),
        qkv_bias=True,
        tie_embeddings=True,
        rope_theta=1_000_000.0,
        frontend="vision",
    )
    # 256 visual tokens per image (InternVL2 pixel-unshuffled 448px tiles)
    return ArchConfig(model=model, prefix_len=256)

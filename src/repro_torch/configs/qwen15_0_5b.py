"""qwen1.5-0.5b [dense] — 24L d_model=1024 16H (kv=16) d_ff=2816
vocab=151936, QKV bias, tied embeddings. [hf:Qwen/Qwen1.5-0.5B]"""

from repro_torch.configs import ArchConfig
from repro_torch.models.config import ModelConfig, dense_stack


def get_config() -> ArchConfig:
    model = ModelConfig(
        name="qwen1.5-0.5b",
        arch_type="dense",
        d_model=1024,
        num_heads=16,
        num_kv_heads=16,
        d_ff=2816,
        vocab_size=151936,
        segments=dense_stack(24),
        qkv_bias=True,
        tie_embeddings=True,
        rope_theta=1_000_000.0,
    )
    return ArchConfig(model=model)

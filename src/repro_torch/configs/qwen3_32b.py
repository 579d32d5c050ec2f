"""qwen3-32b [dense] — 64L d_model=5120 64H (kv=8) d_ff=25600
vocab=151936, qk-norm, head_dim=128. [hf:Qwen/Qwen3-8B family card]"""

from repro_torch.configs import ArchConfig
from repro_torch.models.config import ModelConfig, dense_stack


def get_config() -> ArchConfig:
    model = ModelConfig(
        name="qwen3-32b",
        arch_type="dense",
        d_model=5120,
        num_heads=64,
        num_kv_heads=8,
        head_dim=128,
        d_ff=25600,
        vocab_size=151936,
        segments=dense_stack(64),
        qk_norm=True,
        rope_theta=1_000_000.0,
    )
    return ArchConfig(model=model)

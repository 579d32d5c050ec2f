"""deepseek-coder-33b [dense] — 62L d_model=7168 56H (kv=8) d_ff=19200
vocab=32256, llama architecture (RMSNorm + SwiGLU + RoPE).
[arXiv:2401.14196]"""

from repro_torch.configs import ArchConfig
from repro_torch.models.config import ModelConfig, dense_stack


def get_config() -> ArchConfig:
    model = ModelConfig(
        name="deepseek-coder-33b",
        arch_type="dense",
        d_model=7168,
        num_heads=56,
        num_kv_heads=8,
        d_ff=19200,
        vocab_size=32256,
        segments=dense_stack(62),
        rope_theta=100_000.0,
    )
    return ArchConfig(model=model)

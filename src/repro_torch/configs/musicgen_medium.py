"""musicgen-medium [audio] — 48L d_model=1536 24H (kv=24) d_ff=6144
vocab=2048; decoder-only over EnCodec tokens, sinusoidal positions.
The EnCodec/conditioning frontend is a stub: input_specs() provides the
conditioning prefix embeddings; the token stream is EnCodec codes.
[arXiv:2306.05284]"""

from repro_torch.configs import ArchConfig
from repro_torch.models.config import ModelConfig, dense_stack


def get_config() -> ArchConfig:
    model = ModelConfig(
        name="musicgen-medium",
        arch_type="audio",
        d_model=1536,
        num_heads=24,
        num_kv_heads=24,
        d_ff=6144,
        vocab_size=2048,
        segments=dense_stack(48),
        pos_emb="sinusoidal",
        frontend="audio",
    )
    # 64-frame conditioning prefix from the stubbed frontend
    return ArchConfig(model=model, prefix_len=64)

"""xlstm-350m [ssm] — 24L d_model=1024 4H vocab=50304; xLSTM[7:1]
block ratio (7 mLSTM : 1 sLSTM), no separate FFN (d_ff=0: the blocks carry
their own projections), no position embedding. [arXiv:2405.04517]"""

from repro_torch.configs import ArchConfig
from repro_torch.models.config import LayerSpec, ModelConfig, Segment


def get_config() -> ArchConfig:
    model = ModelConfig(
        name="xlstm-350m",
        arch_type="ssm",
        d_model=1024,
        num_heads=4,
        num_kv_heads=4,
        d_ff=0,
        vocab_size=50304,
        segments=(
            Segment(
                period=tuple(
                    [LayerSpec(mixer="mlstm", ff="none")] * 7
                    + [LayerSpec(mixer="slstm", ff="none")]
                ),
                repeat=3,
            ),
        ),
        pos_emb="none",
        mlstm_proj_factor=2.0,
        slstm_proj_factor=4.0 / 3.0,
        conv_width=4,
    )
    return ArchConfig(model=model)

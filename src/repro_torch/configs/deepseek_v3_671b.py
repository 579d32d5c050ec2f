"""deepseek-v3-671b [moe] — 61L d_model=7168 128H (MLA) vocab=129280,
MoE: 1 shared + 256 routed top-8, d_expert=2048, first 3 layers dense,
MTP depth 1. [arXiv:2412.19437]"""

from repro_torch.configs import ArchConfig
from repro_torch.models.config import LayerSpec, MLAConfig, MoEConfig, ModelConfig, Segment


def get_config() -> ArchConfig:
    model = ModelConfig(
        name="deepseek-v3-671b",
        arch_type="moe",
        d_model=7168,
        num_heads=128,
        num_kv_heads=128,       # MLA is effectively MHA over latent KV
        head_dim=128,
        d_ff=18432,             # dense layers' FFN (first 3 layers)
        vocab_size=129280,
        segments=(
            Segment(period=(LayerSpec(mixer="mla", ff="mlp"),), repeat=3),
            Segment(period=(LayerSpec(mixer="mla", ff="moe"),), repeat=58),
        ),
        mla=MLAConfig(
            q_lora_rank=1536,
            kv_lora_rank=512,
            qk_nope_head_dim=128,
            qk_rope_head_dim=64,
            v_head_dim=128,
        ),
        moe=MoEConfig(
            num_experts=256,
            top_k=8,
            d_expert=2048,
            num_shared=1,
            router_score="sigmoid",
            capacity_factor=1.0,
        ),
        mtp_depth=1,
        rope_theta=10_000.0,
    )
    # 671B params: a single MARINA worker must span a full pod (DESIGN.md §3).
    return ArchConfig(model=model, worker_axes="pod", fsdp=True)

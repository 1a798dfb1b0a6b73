"""mamba2-2.7b — pure SSM, SSD (state-space duality), attention-free.
[arXiv:2405.21060; unverified]
"""
from repro_torch.configs.registry import ModelConfig

CONFIG = ModelConfig(
    name="mamba2-2.7b",
    family="ssm",
    num_layers=64,
    d_model=2560,
    num_heads=0,               # attention-free
    num_kv_heads=0,
    d_ff=0,                    # mamba2 blocks have no separate MLP
    vocab_size=50_280,
    ssm_state=128,
    ssm_expand=2,
    ssm_head_dim=64,
    ssm_groups=1,
    conv_width=4,
    source="arXiv:2405.21060; unverified",
)

"""zamba2-7b — hybrid: Mamba2 backbone + shared attention blocks.
[arXiv:2411.15242; unverified]

81 layers of Mamba2 with a *weight-shared* attention+MLP block applied every
``attn_every`` layers (Zamba2's shared transformer block pattern).
"""
from repro_torch.configs.registry import ModelConfig

CONFIG = ModelConfig(
    name="zamba2-7b",
    family="hybrid",
    num_layers=81,
    d_model=3584,
    num_heads=32,
    num_kv_heads=32,
    d_ff=14336,
    vocab_size=32_000,
    head_dim=112,
    mlp_type="swiglu",
    ssm_state=64,
    ssm_expand=2,
    ssm_head_dim=64,
    ssm_groups=2,
    conv_width=4,
    attn_every=6,
    rope_theta=10_000.0,
    source="arXiv:2411.15242; unverified",
)

"""grok-1-314b — MoE 8 experts top-2.  [hf:xai-org/grok-1; unverified]"""
from repro_torch.configs.registry import ModelConfig

CONFIG = ModelConfig(
    name="grok-1-314b",
    family="moe",
    num_layers=64,
    d_model=6144,
    num_heads=48,
    num_kv_heads=8,
    d_ff=32768,                # per-expert ffn dim
    vocab_size=131_072,
    head_dim=128,
    mlp_type="geglu",           # 3-matrix gated FFN (grok-1 linear_v/linear_1/linear)
    num_experts=8,
    experts_per_token=2,
    rope_theta=10_000.0,
    source="hf:xai-org/grok-1; unverified",
)

"""moonshot-v1-16b-a3b — MoE 64 experts top-6 (kimi/moonlight).
[hf:moonshotai/Moonlight-16B-A3B; hf]
"""
from repro_torch.configs.registry import ModelConfig

CONFIG = ModelConfig(
    name="moonshot-v1-16b-a3b",
    family="moe",
    num_layers=48,
    d_model=2048,
    num_heads=16,
    num_kv_heads=16,
    d_ff=1408,                 # per-expert ffn dim
    vocab_size=163_840,
    head_dim=128,
    mlp_type="swiglu",
    num_experts=64,
    experts_per_token=6,
    shared_expert_ff=2816,     # moonlight keeps a 2x shared expert
    rope_theta=50_000.0,
    source="hf:moonshotai/Moonlight-16B-A3B; hf",
)

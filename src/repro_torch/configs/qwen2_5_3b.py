"""qwen2.5-3b — dense, GQA kv=2, QKV bias.  [hf:Qwen/Qwen2.5-0.5B; hf]"""
from repro_torch.configs.registry import ModelConfig

CONFIG = ModelConfig(
    name="qwen2.5-3b",
    family="dense",
    num_layers=36,
    d_model=2048,
    num_heads=16,
    num_kv_heads=2,
    d_ff=11008,
    vocab_size=151_936,
    head_dim=128,
    qkv_bias=True,
    mlp_type="swiglu",
    rope_theta=1_000_000.0,
    source="hf:Qwen/Qwen2.5-0.5B; hf",
)

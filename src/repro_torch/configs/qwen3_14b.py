"""qwen3-14b — dense, GQA kv=8, qk-norm.  [hf:Qwen/Qwen3-8B; hf]"""
from repro_torch.configs.registry import ModelConfig

CONFIG = ModelConfig(
    name="qwen3-14b",
    family="dense",
    num_layers=40,
    d_model=5120,
    num_heads=40,
    num_kv_heads=8,
    d_ff=17408,
    vocab_size=151_936,
    head_dim=128,
    qk_norm=True,
    mlp_type="swiglu",
    rope_theta=1_000_000.0,
    source="hf:Qwen/Qwen3-8B; hf",
)

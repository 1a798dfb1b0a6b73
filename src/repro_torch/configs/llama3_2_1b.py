"""llama3.2-1b — small llama3, GQA kv=8.  [hf:meta-llama/Llama-3.2-1B; unverified]"""
from repro_torch.configs.registry import ModelConfig

CONFIG = ModelConfig(
    name="llama3.2-1b",
    family="dense",
    num_layers=16,
    d_model=2048,
    num_heads=32,
    num_kv_heads=8,
    d_ff=8192,
    vocab_size=128_256,
    head_dim=64,
    mlp_type="swiglu",
    tie_embeddings=True,
    rope_theta=500_000.0,
    source="hf:meta-llama/Llama-3.2-1B; unverified",
)

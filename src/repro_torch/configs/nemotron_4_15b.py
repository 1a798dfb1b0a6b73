"""nemotron-4-15b — dense, GQA kv=8, squared-ReLU MLP.  [arXiv:2402.16819; unverified]"""
from repro_torch.configs.registry import ModelConfig

CONFIG = ModelConfig(
    name="nemotron-4-15b",
    family="dense",
    num_layers=32,
    d_model=6144,
    num_heads=48,
    num_kv_heads=8,
    d_ff=24576,
    vocab_size=256_000,
    head_dim=128,
    mlp_type="relu2",
    rope_theta=10_000.0,
    source="arXiv:2402.16819; unverified",
)

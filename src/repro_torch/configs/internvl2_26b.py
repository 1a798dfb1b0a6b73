"""internvl2-26b — VLM: InternViT frontend (STUB) + InternLM2 backbone.
[arXiv:2404.16821; hf]

Only the transformer BACKBONE is modeled; ``input_specs()`` provides
precomputed patch embeddings (``vis_tokens`` positions of d_model) that the
model prepends to the token embeddings.
"""
from repro_torch.configs.registry import ModelConfig

CONFIG = ModelConfig(
    name="internvl2-26b",
    family="vlm",
    num_layers=48,
    d_model=6144,
    num_heads=48,
    num_kv_heads=8,
    d_ff=16384,
    vocab_size=92_553,
    head_dim=128,
    mlp_type="swiglu",
    rope_theta=1_000_000.0,
    vis_tokens=256,          # one image tile worth of stub patch embeddings
    source="arXiv:2404.16821; hf",
)

"""whisper-tiny — encoder-decoder, conv/mel frontend STUBBED.
[arXiv:2212.04356; unverified]

``input_specs()`` provides precomputed frame embeddings (post-conv, 1500
frames of d_model) for the encoder; the decoder is a standard transformer with
cross-attention.  num_layers = decoder layers; enc_layers = encoder layers.
"""
from repro_torch.configs.registry import ModelConfig

CONFIG = ModelConfig(
    name="whisper-tiny",
    family="audio",
    num_layers=4,
    d_model=384,
    num_heads=6,
    num_kv_heads=6,
    d_ff=1536,
    vocab_size=51_865,
    head_dim=64,
    mlp_type="gelu",
    enc_layers=4,
    enc_frames=1500,
    rope_theta=10_000.0,      # sinusoidal in the paper; rope used here uniformly
    source="arXiv:2212.04356; unverified",
)

"""Architecture registry (the port's own copy of ``repro.configs.registry``).

``get_config(arch_id)`` resolves ``--arch <id>`` everywhere (launcher, dry-run,
benchmarks, tests).  Reduced variants (for CPU smoke tests) come from
``ModelConfig.reduced()`` so the smoke test always exercises the same family
code path as the full config.
"""
from __future__ import annotations

import dataclasses
import importlib


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                  # dense | moe | ssm | hybrid | vlm | audio
    num_layers: int
    d_model: int
    num_heads: int
    num_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: int = 0            # 0 -> d_model // num_heads

    # --- attention / mlp flavour flags -----------------------------------
    qk_norm: bool = False
    qkv_bias: bool = False
    mlp_type: str = "swiglu"     # swiglu | relu2 | gelu
    tie_embeddings: bool = False
    rope_theta: float = 10_000.0
    norm_eps: float = 1e-5

    # --- MoE ---------------------------------------------------------------
    num_experts: int = 0
    experts_per_token: int = 0
    moe_capacity_factor: float = 1.25
    shared_expert_ff: int = 0    # moonshot-style always-on shared expert

    # --- SSM (mamba2 / zamba2) ----------------------------------------------
    ssm_state: int = 0
    ssm_expand: int = 2
    ssm_head_dim: int = 64
    ssm_groups: int = 1
    conv_width: int = 4
    attn_every: int = 0          # hybrid: shared attention block period (0=off)

    # --- encoder-decoder (whisper) -------------------------------------------
    enc_layers: int = 0          # >0 -> enc-dec model; num_layers = decoder layers
    enc_frames: int = 1500       # stub frontend sequence length (post-conv)

    # --- vlm ------------------------------------------------------------------
    vis_tokens: int = 0          # stub patch-embedding prefix length

    # --- long context ---------------------------------------------------------
    long_context: bool = False   # opts into the 32k train shape (train_32k)

    source: str = ""             # provenance tag from the assignment table

    # ------------------------------------------------------------------
    @property
    def resolved_head_dim(self) -> int:
        return self.head_dim or self.d_model // max(self.num_heads, 1)

    @property
    def is_attention_free(self) -> bool:
        return self.family == "ssm"

    @property
    def is_subquadratic(self) -> bool:
        """True if decode cost/state is sub-quadratic in context (SSM/hybrid)."""
        return self.family in ("ssm", "hybrid")

    @property
    def is_encdec(self) -> bool:
        return self.enc_layers > 0

    @property
    def ssm_heads(self) -> int:
        return (self.ssm_expand * self.d_model) // self.ssm_head_dim if self.ssm_state else 0

    def reduced(self) -> "ModelConfig":
        """Tiny same-family variant for CPU smoke tests (one fwd/train step)."""
        return dataclasses.replace(
            self,
            num_layers=min(self.num_layers, 2 if self.attn_every == 0 else max(self.attn_every, 2)),
            d_model=128,
            num_heads=4,
            num_kv_heads=min(max(self.num_kv_heads // max(self.num_heads // 4, 1), 1), 4)
            if self.num_kv_heads
            else 0,
            head_dim=32,
            d_ff=256 if self.d_ff else 0,
            vocab_size=512,
            num_experts=min(self.num_experts, 4),
            experts_per_token=min(self.experts_per_token, 2),
            # ample capacity at smoke scale: random-init routing is highly
            # correlated (near-uniform router logits on a correlated residual
            # stream), so production cf overflows experts and the resulting
            # batch-dependent drops break train/prefill/decode comparisons
            moe_capacity_factor=max(self.moe_capacity_factor, 4.0),
            shared_expert_ff=128 if self.shared_expert_ff else 0,
            ssm_state=min(self.ssm_state, 16),
            ssm_head_dim=32 if self.ssm_state else 64,
            attn_every=min(self.attn_every, 2) if self.attn_every else 0,
            enc_layers=min(self.enc_layers, 2),
            enc_frames=32 if self.enc_layers else 1500,
            vis_tokens=16 if self.vis_tokens else 0,
        )


_ARCH_MODULES = {
    "qwen3-14b": "qwen3_14b",
    "nemotron-4-15b": "nemotron_4_15b",
    "qwen2.5-3b": "qwen2_5_3b",
    "llama3.2-1b": "llama3_2_1b",
    "llama3.2-1b-long": "llama3_2_1b_long",
    "internvl2-26b": "internvl2_26b",
    "zamba2-7b": "zamba2_7b",
    "moonshot-v1-16b-a3b": "moonshot_v1_16b_a3b",
    "grok-1-314b": "grok1_314b",
    "mamba2-2.7b": "mamba2_2_7b",
    "whisper-tiny": "whisper_tiny",
}

ARCH_IDS = tuple(_ARCH_MODULES)


def get_config(arch_id: str) -> ModelConfig:
    if arch_id not in _ARCH_MODULES:
        raise KeyError(f"unknown arch {arch_id!r}; known: {sorted(_ARCH_MODULES)}")
    mod = importlib.import_module(f"repro_torch.configs.{_ARCH_MODULES[arch_id]}")
    return mod.CONFIG


def all_configs() -> dict[str, ModelConfig]:
    return {a: get_config(a) for a in ARCH_IDS}

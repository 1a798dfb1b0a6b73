"""Model zoo: family dispatch."""
from __future__ import annotations

from repro_torch.configs.registry import ModelConfig


def build_model(cfg: ModelConfig, impl: str = "kernel", device="cuda"):
    """``impl="kernel"`` (default): the CUDA kernels on CUDA tensors;
    ``impl="ref"``: plain PyTorch everywhere, for comparisons."""
    if cfg.family == "dense":
        from repro_torch.models.transformer import DenseTransformerLM

        return DenseTransformerLM(cfg, impl, device)
    if cfg.family == "vlm":
        from repro_torch.models.transformer import VLMTransformerLM

        return VLMTransformerLM(cfg, impl, device)
    if cfg.family == "moe":
        from repro_torch.models.moe import MoETransformerLM

        return MoETransformerLM(cfg, impl, device)
    if cfg.family == "ssm":
        from repro_torch.models.mamba2 import Mamba2LM

        return Mamba2LM(cfg, impl, device)
    if cfg.family == "hybrid":
        from repro_torch.models.hybrid import HybridLM

        return HybridLM(cfg, impl, device)
    if cfg.family == "audio":
        from repro_torch.models.encdec import EncDecLM

        return EncDecLM(cfg, impl, device)
    raise ValueError(f"unknown family {cfg.family!r}")

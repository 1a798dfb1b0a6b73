"""Assigned input-shape grid (shapes × archs; SKIP cells stay in the table).

``train_*`` shapes lower ``train_step``; ``prefill_*`` lower ``prefill_step``;
``decode_*`` / ``long_*`` lower ``serve_step`` (one new token against a KV
cache of ``seq_len``).  ``long_500k`` requires sub-quadratic attention and is
only *run* for SSM/hybrid archs; ``train_32k`` (the context-parallelism
scenario) only runs for long-context config variants (cfg.long_context) —
other archs record an explicit SKIP cell (see DESIGN.md §5).
"""
from __future__ import annotations

import dataclasses

from repro_torch.configs.registry import ModelConfig


@dataclasses.dataclass(frozen=True)
class ShapeSpec:
    name: str
    kind: str            # train | prefill | decode
    seq_len: int
    global_batch: int
    sub_quadratic_only: bool = False
    long_context_only: bool = False


SHAPES: dict[str, ShapeSpec] = {
    "train_4k": ShapeSpec("train_4k", "train", 4_096, 256),
    "train_32k": ShapeSpec("train_32k", "train", 32_768, 16, long_context_only=True),
    "prefill_32k": ShapeSpec("prefill_32k", "prefill", 32_768, 32),
    "decode_32k": ShapeSpec("decode_32k", "decode", 32_768, 128),
    "long_500k": ShapeSpec("long_500k", "decode", 524_288, 1, sub_quadratic_only=True),
}

SHAPE_IDS = tuple(SHAPES)


def supports_shape(cfg: ModelConfig, shape: ShapeSpec) -> tuple[bool, str]:
    """(runnable, reason). SKIP cells still appear in the dry-run table."""
    if shape.sub_quadratic_only and not cfg.is_subquadratic:
        return False, "long_500k needs sub-quadratic attention; this arch is full-attention"
    if shape.long_context_only and not cfg.long_context:
        return False, "train_32k needs a long-context config variant (cfg.long_context)"
    return True, ""


def cells(configs: dict[str, ModelConfig]) -> list[tuple[str, str, bool, str]]:
    """Full 40-cell grid: (arch, shape, runnable, skip_reason)."""
    out = []
    for arch, cfg in configs.items():
        for sid, spec in SHAPES.items():
            ok, why = supports_shape(cfg, spec)
            out.append((arch, sid, ok, why))
    return out

"""Deterministic synthetic training data (the port of
``repro.runtime.data.SyntheticDataset``).

The stream for global sample ``i`` depends only on (seed, i): per-sample
numpy Philox generators, exactly as in the JAX package, so both packages
produce bitwise the same batches and any host layout yields the same global
batch.  Tokens and labels are numpy int32 arrays; the embedding inputs
(``vis_embeds`` zeros for vlm, Philox ``frames`` for audio) are CPU torch
bfloat16 tensors, rounded to nearest even from fp32 by ``Tensor.to`` (the
JAX package rounds with ``ml_dtypes``; the port does not need it).

``input_specs`` (the dry-run's abstract shapes) waits for the dry-run slice.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.configs.registry import ModelConfig

#: dtype of the precomputed embedding inputs (vis_embeds / audio frames)
EMBED_DTYPE = torch.bfloat16

#: Philox stream-id word for audio frames: keyed per (seed, sample id) like
#: the token stream, on a distinct stream so frames and tokens draw
#: independent bits.
_FRAMES_STREAM = 7


def _text_len(cfg: ModelConfig, seq_len: int) -> int:
    if cfg.family == "vlm":
        return seq_len - cfg.vis_tokens
    return seq_len


@dataclasses.dataclass
class SyntheticDataset:
    """Deterministic LM data: next-token prediction over a hashed stream."""

    cfg: ModelConfig
    seq_len: int
    global_batch: int
    seed: int = 0

    def _tokens(self, sample_ids: np.ndarray) -> np.ndarray:
        st = _text_len(self.cfg, self.seq_len)
        out = np.empty((len(sample_ids), st + 1), np.int32)
        for row, sid in enumerate(sample_ids):
            g = np.random.Generator(np.random.Philox(key=self.seed * 1_000_003 + int(sid)))
            out[row] = g.integers(0, self.cfg.vocab_size, st + 1, dtype=np.int32)
        return out

    def global_ids(self, step: int) -> np.ndarray:
        start = step * self.global_batch
        return np.arange(start, start + self.global_batch, dtype=np.int64)

    def batch(self, step: int, host_id: int = 0, num_hosts: int = 1) -> dict:
        """Host-local shard of the global batch (rows host_id::num_hosts)."""
        ids = self.global_ids(step)[host_id::num_hosts]
        toks = self._tokens(ids)
        batch = {"tokens": toks[:, :-1], "labels": toks[:, 1:].copy()}
        if self.cfg.family == "vlm":
            batch["vis_embeds"] = torch.zeros(
                (len(ids), self.cfg.vis_tokens, self.cfg.d_model), dtype=EMBED_DTYPE)
        if self.cfg.family == "audio":
            frames = np.empty((len(ids), self.cfg.enc_frames, self.cfg.d_model), np.float32)
            for row, sid in enumerate(ids):
                g = np.random.Generator(np.random.Philox(
                    key=[self.seed * 1_000_003 + int(sid), _FRAMES_STREAM]))
                frames[row] = g.standard_normal((self.cfg.enc_frames, self.cfg.d_model))
            batch["frames"] = torch.from_numpy(frames).to(EMBED_DTYPE)
        return batch

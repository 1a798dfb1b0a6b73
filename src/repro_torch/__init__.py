"""``repro_torch`` — the PyTorch/CUDA port of the Galvatron reproduction.

The JAX package ``repro`` stays the reference.  This package imports
``torch`` and numpy only: never ``jax`` and nothing of ``repro`` (what it
needs from the jax-free modules there is kept here as its own copy).  Module
layout and names follow ``repro`` so each counterpart is easy to find.

Ported so far: the serving main path of the dense family —
``repro_torch.serving.build(ServeConfig)`` → continuous-batching scheduler
over the paged KV pool → ``DenseTransformerLM.forward_decode`` — running on
two hand-written CUDA kernels for ``sm_90a`` (flash-attention forward and
RMSNorm, under ``repro_torch.kernels``).  Entry points default to
``device="cuda"``; tests pass ``device="cpu"``, where every kernel wrapper
takes its plain PyTorch version.
"""

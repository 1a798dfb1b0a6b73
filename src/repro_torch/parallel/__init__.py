"""Parallel runtime pieces ported so far: per-layer recomputation
(``remat``), JAX's logical-axis rules (``axes``, ``sharding``) and the
collectives that carry them out over ``torch.distributed``
(``collectives``).  Pipelining and context parallelism wait for later
slices."""

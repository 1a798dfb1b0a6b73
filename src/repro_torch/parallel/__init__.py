"""Parallel runtime pieces ported so far: per-layer recomputation
(``remat``).  Sharding, pipelining and context parallelism wait for the
parallel-runtime slice."""

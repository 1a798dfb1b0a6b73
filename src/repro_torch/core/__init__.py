"""Galvatron core: profiler + search engine + strategy/plan contracts (the
port's copy of ``repro.core``).

Public API (paper Fig. 2):
    get_hybrid_parallel_configs  -> SearchEngine.search(...)
    construct_hybrid_parallel_model -> repro_torch.runtime.train
"""
from repro_torch.core.cluster import CLUSTERS, H100_1, ClusterSpec
from repro_torch.core.search import SearchEngine, SearchResult, serving_plan
from repro_torch.core.strategy import ExecutionPlan, LayerStrategy, uniform_plan


def get_hybrid_parallel_configs(cfg, seq_len, global_batch, **kw):
    """The paper's user-facing entry point (Fig. 2 line 9), on one H100 and
    a ``(1, 1)`` mesh unless ``cluster`` / ``mesh_shape`` say otherwise."""
    engine = SearchEngine(cfg, kw.pop("cluster", H100_1))
    return engine.search(seq_len, global_batch, **kw).plan

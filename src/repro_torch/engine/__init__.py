"""Batched query engine (counterpart of ``repro.engine``)."""
from repro_torch.engine.engine import (DEFAULT_BUCKETS, EngineStats,
                                       LocalDispatcher, QueryEngine)
from repro_torch.engine.live import LiveRepository
from repro_torch.engine.query import Pipeline, Query, SearchResult
from repro_torch.engine.replicated import ReplicatedQueryEngine, replica_mesh
from repro_torch.engine.sharded import ShardedQueryEngine, data_mesh

__all__ = ["DEFAULT_BUCKETS", "EngineStats", "LiveRepository",
           "LocalDispatcher", "Pipeline", "Query", "QueryEngine",
           "ReplicatedQueryEngine", "SearchResult", "ShardedQueryEngine",
           "data_mesh", "replica_mesh"]

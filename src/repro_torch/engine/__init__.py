"""Batched query engine (counterpart of ``repro.engine``)."""
from repro_torch.engine.engine import (DEFAULT_BUCKETS, EngineStats,
                                       LocalDispatcher, QueryEngine)
from repro_torch.engine.live import LiveRepository
from repro_torch.engine.query import Pipeline, Query, SearchResult

__all__ = ["DEFAULT_BUCKETS", "EngineStats", "LiveRepository",
           "LocalDispatcher", "Pipeline", "Query", "QueryEngine",
           "SearchResult"]

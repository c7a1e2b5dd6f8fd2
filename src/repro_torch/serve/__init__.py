"""Continuous-batching serving over packed Kratos weights (port of
`repro.serve`, slab and native paged forms, speculative self-draft
decode)."""

from repro_torch.serve.cache_pool import CachePool, PoolExhausted
from repro_torch.serve.engine import (EngineConfig, EngineSaturated,
                                      InferenceEngine, ReplicaFault)
from repro_torch.serve.metrics import ServeMetrics
from repro_torch.serve.paging import (PageLayout, PagedCachePool,
                                      prefix_supported)
from repro_torch.serve.prefix import PrefixIndex
from repro_torch.serve.registry import (ModelRegistry, PackedModel,
                                        pack_model_params)
from repro_torch.serve.scheduler import ContinuousScheduler, Request
from repro_torch.serve.speculative import DraftSpec

__all__ = ["CachePool", "ContinuousScheduler", "DraftSpec", "EngineConfig",
           "EngineSaturated", "InferenceEngine", "ModelRegistry",
           "PackedModel", "PageLayout", "PagedCachePool", "PoolExhausted",
           "PrefixIndex", "ReplicaFault", "Request", "ServeMetrics",
           "pack_model_params", "prefix_supported"]

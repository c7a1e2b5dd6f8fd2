"""Continuous-batching serving over packed Kratos weights (port of
`repro.serve`, slab form)."""

from repro_torch.serve.cache_pool import CachePool, PoolExhausted
from repro_torch.serve.engine import (EngineConfig, EngineSaturated,
                                      InferenceEngine, ReplicaFault)
from repro_torch.serve.metrics import ServeMetrics
from repro_torch.serve.registry import (ModelRegistry, PackedModel,
                                        pack_model_params)
from repro_torch.serve.scheduler import ContinuousScheduler, Request

__all__ = ["CachePool", "ContinuousScheduler", "EngineConfig",
           "EngineSaturated", "InferenceEngine", "ModelRegistry",
           "PackedModel", "PoolExhausted", "ReplicaFault", "Request",
           "ServeMetrics", "pack_model_params"]

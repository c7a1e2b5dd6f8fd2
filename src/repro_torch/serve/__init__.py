"""Continuous-batching serving over packed Kratos weights (port of
`repro.serve`, slab and native paged forms, speculative self-draft
decode, deadlines and cancellation, the QoS tier ladder and the
ineffectual-work ledger)."""

from repro_torch.serve.cache_pool import CachePool, PoolExhausted
from repro_torch.serve.engine import (EngineConfig, EngineSaturated,
                                      InferenceEngine, ReplicaFault)
from repro_torch.serve.ledger import (NULL_LEDGER, LedgerConfig, LedgerSink,
                                      hist_checksum)
from repro_torch.serve.metrics import ServeMetrics
from repro_torch.serve.paging import (PageLayout, PagedCachePool,
                                      prefix_supported)
from repro_torch.serve.prefix import PrefixIndex
from repro_torch.serve.qos import (QoSConfig, QoSController, check_tier_spec,
                                   parse_tiers)
from repro_torch.serve.registry import (ModelRegistry, PackedModel,
                                        pack_model_params)
from repro_torch.serve.scheduler import ContinuousScheduler, Request
from repro_torch.serve.speculative import DraftSpec

__all__ = ["CachePool", "ContinuousScheduler", "DraftSpec", "EngineConfig",
           "EngineSaturated", "InferenceEngine", "LedgerConfig", "LedgerSink",
           "ModelRegistry", "NULL_LEDGER", "PackedModel", "PageLayout",
           "PagedCachePool", "PoolExhausted", "PrefixIndex", "QoSConfig",
           "QoSController", "ReplicaFault", "Request", "ServeMetrics",
           "check_tier_spec", "hist_checksum", "pack_model_params",
           "parse_tiers", "prefix_supported"]

"""Continuous-batching serving over packed Kratos weights (port of
`repro.serve`, slab and native paged forms, speculative self-draft
decode, deadlines and cancellation, the QoS tier ladder, the
ineffectual-work ledger, tracing and live telemetry, the replica router
with failover and its chaos harness, the continuous and static admission
policies, the execution backend an engine is built on, and the fleet:
the cross-process control plane and the FleetRouter over it, and the
sharded and distributed backends over a torch.distributed device
mesh)."""

from repro_torch.serve.backend import (DistributedBackend, ExecutionBackend,
                                       LocalBackend, ShardedBackend,
                                       ensure_distributed)
from repro_torch.serve.cache_pool import CachePool, PoolExhausted
from repro_torch.serve.chaos import ChaosHarness, Fault, seeded_schedule
from repro_torch.serve.control import (ControlListener, Endpoint, FleetConfig,
                                       FleetState, LocalProcess,
                                       ProcessStatus, RemoteProcess,
                                       WorkerServer, connect, decode_message,
                                       encode_message)
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
from repro_torch.serve.router import FleetRequest, FleetRouter, ReplicaRouter
from repro_torch.serve.scheduler import (ContinuousScheduler, Request,
                                         StaticScheduler, replica_load)
from repro_torch.serve.speculative import DraftSpec
from repro_torch.serve.telemetry import (TelemetryConfig, TelemetryExporter,
                                         TelemetryRegistry, engine_sample,
                                         router_sample)
from repro_torch.serve.trace import (NULL_TRACER, TraceConfig, Tracer,
                                     export_chrome, export_jsonl)

__all__ = ["CachePool", "ChaosHarness", "ContinuousScheduler",
           "ControlListener", "DistributedBackend", "DraftSpec", "Endpoint",
           "EngineConfig",
           "EngineSaturated", "ExecutionBackend", "Fault", "FleetConfig",
           "FleetRequest", "FleetRouter", "FleetState", "InferenceEngine",
           "LedgerConfig", "LedgerSink", "LocalBackend", "LocalProcess",
           "ModelRegistry", "NULL_LEDGER", "NULL_TRACER", "PackedModel",
           "PageLayout", "PagedCachePool", "PoolExhausted", "PrefixIndex",
           "ProcessStatus", "QoSConfig", "QoSController", "RemoteProcess",
           "ReplicaFault", "ReplicaRouter", "Request", "ServeMetrics",
           "ShardedBackend", "StaticScheduler", "TelemetryConfig", "TelemetryExporter",
           "TelemetryRegistry", "TraceConfig", "Tracer", "WorkerServer",
           "check_tier_spec", "connect", "decode_message", "encode_message",
           "engine_sample", "ensure_distributed", "export_chrome", "export_jsonl", "hist_checksum",
           "pack_model_params", "parse_tiers", "prefix_supported",
           "replica_load", "router_sample", "seeded_schedule"]

"""Serving runtime: weight store, decode-tile cache, scheduler, metrics,
telemetry and the decode-cache capacity autotuner."""

from repro_torch.runtime.autotune import (find_knee, recommend_store_capacity,
                                          sweep_store)
from repro_torch.runtime.decode_cache import DecodeTileCache
from repro_torch.runtime.metrics import ServeMetrics
from repro_torch.runtime.scheduler import (PageAllocator, Request, Scheduler,
                                           ServeEngine, SlotPool)
from repro_torch.runtime.telemetry import (NULL_TELEMETRY, Histogram,
                                           MetricsRegistry, NullTelemetry,
                                           Telemetry, Tracer, parse_prom)
from repro_torch.runtime.weight_store import WeightStore

__all__ = ["DecodeTileCache", "Histogram", "MetricsRegistry",
           "NULL_TELEMETRY", "NullTelemetry", "PageAllocator", "Request",
           "Scheduler", "ServeEngine", "ServeMetrics", "SlotPool",
           "Telemetry", "Tracer", "WeightStore", "find_knee", "parse_prom",
           "recommend_store_capacity", "sweep_store"]

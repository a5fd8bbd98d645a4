"""Serving runtime: weight store, decode-tile cache, scheduler, metrics."""

from repro_torch.runtime.decode_cache import DecodeTileCache
from repro_torch.runtime.metrics import ServeMetrics
from repro_torch.runtime.scheduler import (PageAllocator, Request, Scheduler,
                                           ServeEngine, SlotPool)
from repro_torch.runtime.weight_store import WeightStore

__all__ = ["DecodeTileCache", "PageAllocator", "Request", "Scheduler",
           "ServeEngine", "ServeMetrics", "SlotPool", "WeightStore"]

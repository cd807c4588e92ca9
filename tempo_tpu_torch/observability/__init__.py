"""Observability of the port: a copy of the reference's metrics registry
(``metrics.py``), logging (``log.py``) and the dispatch profiler
(``profile.py``), whose execute stage is the device's own time between
CUDA events. Host code only; nothing here reaches the network."""

from .log import RateLimitedLogger, TenantTokenBucket, get_logger
from .metrics import REGISTRY, Counter, Gauge, Histogram

__all__ = ["REGISTRY", "Counter", "Gauge", "Histogram", "get_logger",
           "RateLimitedLogger", "TenantTokenBucket", "profile"]

from . import profile  # noqa: E402 -- imports metrics above

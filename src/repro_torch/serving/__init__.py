"""Serving: arrival processes, batch replay, and the flat serving engine."""
from .arrivals import make_arrivals
from .engine import ModuleStats, ServeResult, ServingEngine, resolve_module_timeout

__all__ = [
    "ModuleStats",
    "ServeResult",
    "ServingEngine",
    "make_arrivals",
    "resolve_module_timeout",
]

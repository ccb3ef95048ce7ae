"""Observability switch and registry (the part the serial path needs).

``obs.enabled`` is the module-level switch the engine's hooks read
(default ``False``: a disabled hook costs one attribute read and mutates
nothing).  ``registry`` holds the observability-only instruments, such as
the serial engine's ``engine.query_latency_s`` histogram; it is mutated
only while ``enabled`` is True.  ``PlannerStats`` is a
``registry.RegistryView`` over its own registry and counts regardless.
The span tracer is not part of this package yet.
"""

from __future__ import annotations

from repro_torch.obs.registry import (  # noqa: F401  (re-exported API)
    MetricsRegistry,
    RegistryView,
)

#: Module-level switch for the instrumentation hooks.
enabled: bool = False

#: Global registry for observability-only instruments; mutated only when
#: ``enabled`` is True.
registry = MetricsRegistry()


def snapshot() -> dict:
    """Plain-dict snapshot of the global observability registry."""
    return registry.snapshot()

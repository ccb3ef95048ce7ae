"""Metrics registry: named counters/gauges + running histograms.

One flat namespace of instruments, snapshot-able as a plain dict.  Two
instrument kinds:

- **scalars** — counters and gauges are both just named numeric cells
  (``inc`` / ``set_value`` / ``value``); the distinction is usage, not
  representation.
- **histograms** — ``observe`` keeps count, sum, min and max; the
  snapshot reports them with the mean.  Quantiles and interval diffs are
  not part of this package yet.

``RegistryView`` is a stats facade whose class-declared ``_FIELDS``
become read/write properties over ``<prefix>.<field>`` instruments, so
``stats.hits += 1`` call sites (and dataclass-style reprs and equality)
work while the registry stays the single source of truth.
``PlannerStats``, ``CacheStats`` and ``SchedMetrics`` are the views the
engine, the fragment cache and the scheduler use; a scheduler mounts all
three on one registry, so one ``snapshot`` covers the serving stack.
A view's ``reset`` zeroes its own fields (``FragmentCache.clear``).

This module is dependency-free (no torch, no numpy) so importing it from
the core modules costs nothing.
"""

from __future__ import annotations


class _Histogram:
    __slots__ = ("count", "total", "vmin", "vmax")

    def __init__(self):
        self.count = 0
        self.total = 0.0
        self.vmin: float | None = None
        self.vmax: float | None = None

    def observe(self, v: float) -> None:
        v = float(v)
        self.count += 1
        self.total += v
        if self.vmin is None or v < self.vmin:
            self.vmin = v
        if self.vmax is None or v > self.vmax:
            self.vmax = v

    def summary(self) -> dict:
        return {
            "count": self.count,
            "sum": self.total,
            "min": self.vmin if self.count else 0.0,
            "max": self.vmax if self.count else 0.0,
            "mean": self.total / self.count if self.count else 0.0,
        }


class MetricsRegistry:
    """A flat namespace of named scalar and histogram instruments."""

    def __init__(self):
        self._scalars: dict[str, float] = {}
        self._hists: dict[str, _Histogram] = {}

    # ------------------------------------------------------------ scalars
    def inc(self, name: str, n=1) -> None:
        self._scalars[name] = self._scalars.get(name, 0) + n

    def value(self, name: str, default=0):
        return self._scalars.get(name, default)

    def set_value(self, name: str, v) -> None:
        self._scalars[name] = v

    # --------------------------------------------------------- histograms
    def observe(self, name: str, v: float) -> None:
        h = self._hists.get(name)
        if h is None:
            h = self._hists[name] = _Histogram()
        h.observe(v)

    def snapshot(self) -> dict:
        """Scalars as numbers, histograms as summary dicts."""
        snap: dict = dict(self._scalars)
        for k, h in self._hists.items():
            snap[k] = h.summary()
        return snap


def _view_field(key: str):
    def _get(self):
        return self.registry.value(key)

    def _set(self, v):
        self.registry.set_value(key, v)

    return property(_get, _set)


class RegistryView:
    """Attribute-style stats facade over registry instruments.

    Subclasses declare ``_PREFIX`` and ``_FIELDS``; each field becomes a
    read/write property over the ``<prefix>.<field>`` scalar, so
    ``stats.x += 1`` / ``stats.x`` call sites read and write the registry.
    Constructing a view without a registry gives it a private one;
    components that aggregate several views pass one shared registry in.
    """

    _PREFIX = ""
    _FIELDS: tuple = ()

    def __init_subclass__(cls, **kwargs):
        super().__init_subclass__(**kwargs)
        prefix = cls.__dict__.get("_PREFIX", cls._PREFIX)
        for f in cls.__dict__.get("_FIELDS", ()):
            setattr(cls, f, _view_field(f"{prefix}.{f}"))

    def __init__(self, registry: MetricsRegistry | None = None):
        self.registry = registry if registry is not None else MetricsRegistry()

    def reset(self) -> None:
        """Zero this view's fields; other instruments keep their values."""
        for f in self._FIELDS:
            setattr(self, f, 0)

    def as_dict(self) -> dict:
        return {f: getattr(self, f) for f in self._FIELDS}

    def __repr__(self) -> str:
        body = ", ".join(f"{f}={getattr(self, f)}" for f in self._FIELDS)
        return f"{type(self).__name__}({body})"

    def __eq__(self, other) -> bool:
        if not isinstance(other, type(self)):
            return NotImplemented
        return self.as_dict() == other.as_dict()

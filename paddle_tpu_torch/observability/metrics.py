"""Thread-safe in-process metrics registry.

Reference shape: the Prometheus client-library data model (counter /
gauge / histogram families, each fanned out by label values), sized for
a serving hot loop:

- **near-zero overhead when disabled**: every mutator checks one
  registry flag first (``PD_OBS_DISABLED=1`` disables the default
  registry at import; ``Registry.disable()`` at runtime). A disabled
  ``inc()`` is one attribute load + one branch.
- **no exporter coupling**: recording only aggregates plain Python
  numbers under a per-child lock; the text/JSON exposition formats live
  in ``export.py`` and walk a consistent snapshot via ``collect()``.
- **fixed log-spaced histogram buckets**: latency spans ~5 orders of
  magnitude between a decode step and a cold compile, so buckets are
  powers of two over seconds (see :func:`log_buckets`) unless the
  caller passes explicit edges.
"""
from __future__ import annotations

import bisect
import math
import os
import threading
import time
from typing import Dict, List, Optional, Sequence, Tuple

__all__ = ["Counter", "Gauge", "Histogram", "Registry", "log_buckets",
           "default_registry", "set_default_registry", "enabled",
           "enable", "disable", "DEFAULT_LATENCY_BUCKETS"]


def log_buckets(lo: float = 1e-4, hi: float = 60.0,
                factor: float = 2.0) -> Tuple[float, ...]:
    """Fixed log-spaced bucket edges: ``lo * factor**i`` up to and
    including the first edge >= ``hi``."""
    if lo <= 0 or factor <= 1:
        raise ValueError("log_buckets needs lo > 0 and factor > 1")
    edges = [lo]
    while edges[-1] < hi:
        edges.append(edges[-1] * factor)
    return tuple(edges)


# 100us .. ~104s in powers of two: decode steps, prefill, cold compiles
# all land mid-range rather than in the first/last catch-all bucket
DEFAULT_LATENCY_BUCKETS = log_buckets(1e-4, 60.0, 2.0)


def _validate_name(name: str) -> None:
    if not name or not all(c.isalnum() or c in "_:" for c in name):
        raise ValueError(f"invalid metric name: {name!r}")
    if name[0].isdigit():
        raise ValueError(f"metric name starts with a digit: {name!r}")


class _Child:
    """One (family, label-values) time series."""

    __slots__ = ("_family", "_lock", "_value")

    def __init__(self, family: "_Family"):
        self._family = family
        self._lock = threading.Lock()
        self._value = 0.0

    @property
    def value(self) -> float:
        return self._value


class _CounterChild(_Child):
    def inc(self, amount: float = 1.0) -> None:
        if not self._family._registry._enabled:
            return
        if amount < 0:
            raise ValueError("counters only go up; use a Gauge")
        with self._lock:
            self._value += amount


class _GaugeChild(_Child):
    def set(self, value: float) -> None:
        if not self._family._registry._enabled:
            return
        with self._lock:
            self._value = float(value)

    def inc(self, amount: float = 1.0) -> None:
        if not self._family._registry._enabled:
            return
        with self._lock:
            self._value += amount

    def dec(self, amount: float = 1.0) -> None:
        self.inc(-amount)


class _HistogramChild(_Child):
    __slots__ = ("_bucket_counts", "_sum", "_count", "_observed_min",
                 "_observed_max")

    def __init__(self, family: "_Family"):
        super().__init__(family)
        self._bucket_counts = [0] * (len(family.buckets) + 1)  # +Inf last
        self._sum = 0.0
        self._count = 0
        # true extrema of the observed stream: fixed log-spaced buckets
        # are a factor-of-2 wide, so a quantile interpolated inside a
        # bucket can overstate the real p99 by the bucket ratio — the
        # readout clamps to these (see quantile())
        self._observed_min = math.inf
        self._observed_max = -math.inf

    def observe(self, value: float) -> None:
        if not self._family._registry._enabled:
            return
        idx = bisect.bisect_left(self._family.buckets, value)
        with self._lock:
            self._bucket_counts[idx] += 1
            self._sum += value
            self._count += 1
            if value < self._observed_min:
                self._observed_min = value
            if value > self._observed_max:
                self._observed_max = value

    def time(self) -> "_Timer":
        """``with hist.time(): ...`` observes the block's wall time."""
        return _Timer(self)

    def load_state(self, bucket_counts: Sequence[int], sum: float,
                   count: int, observed_min: float,
                   observed_max: float) -> None:
        """Overwrite this child's aggregate state wholesale. The merge
        path for registry views: a fabric-level registry that mirrors N
        per-replica histograms cannot replay observations one by one,
        so it copies each source child's buckets/sum/count/extrema (the
        families share bucket edges) and, for the ``replica="all"``
        row, element-wise sums them first. Requires matching bucket
        arity; respects the registry enable flag like every mutator."""
        if not self._family._registry._enabled:
            return
        if len(bucket_counts) != len(self._bucket_counts):
            raise ValueError(
                f"{self._family.name}: load_state got "
                f"{len(bucket_counts)} buckets, child has "
                f"{len(self._bucket_counts)}")
        with self._lock:
            self._bucket_counts = [int(c) for c in bucket_counts]
            self._sum = float(sum)
            self._count = int(count)
            self._observed_min = observed_min if count else math.inf
            self._observed_max = observed_max if count else -math.inf

    def state(self) -> Tuple[List[int], float, int, float, float]:
        """Consistent copy of (bucket_counts, sum, count, min, max) —
        the tuple :meth:`load_state` accepts."""
        with self._lock:
            return (list(self._bucket_counts), self._sum, self._count,
                    self._observed_min, self._observed_max)

    @property
    def count(self) -> int:
        return self._count

    @property
    def sum(self) -> float:
        return self._sum

    @property
    def observed_min(self) -> Optional[float]:
        """Smallest value ever observed (None before any observe)."""
        return self._observed_min if self._count else None

    @property
    def observed_max(self) -> Optional[float]:
        """Largest value ever observed (None before any observe). The
        exact upper bound of the stream — what bucket-interpolated
        quantile readouts must clamp to."""
        return self._observed_max if self._count else None

    def cumulative_buckets(self) -> List[Tuple[float, int]]:
        """[(le_edge, cumulative_count)] incl. the +Inf bucket."""
        with self._lock:
            counts = list(self._bucket_counts)
        out, acc = [], 0
        for edge, c in zip(self._family.buckets, counts):
            acc += c
            out.append((edge, acc))
        out.append((math.inf, acc + counts[-1]))
        return out

    def quantile(self, q: float) -> Optional[float]:
        """Estimated ``q``-quantile (0 <= q <= 1) of the observed
        stream, interpolated linearly inside the fixed buckets and
        CLAMPED to [observed_min, observed_max]. Without the clamp a
        stream living inside one log-spaced bucket reads back as that
        bucket's upper edge — overstating p99 by up to the bucket
        ratio (2x with the default edges). None before any observe."""
        if not 0.0 <= q <= 1.0:
            raise ValueError(f"quantile must be in [0, 1], got {q}")
        with self._lock:
            counts = list(self._bucket_counts)
            total = self._count
            vmin = self._observed_min
            vmax = self._observed_max
        if total == 0:
            return None
        rank = q * total
        edges = self._family.buckets
        acc = 0.0
        lo = 0.0
        for i, c in enumerate(counts):
            hi = edges[i] if i < len(edges) else vmax
            if c and acc + c >= rank:
                frac = (rank - acc) / c
                val = lo + (hi - lo) * max(frac, 0.0)
                return min(max(val, vmin), vmax)
            acc += c
            lo = hi
        return vmax


class _Timer:
    __slots__ = ("_hist", "_t0")

    def __init__(self, hist: _HistogramChild):
        self._hist = hist

    def __enter__(self):
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        self._hist.observe(time.perf_counter() - self._t0)
        return False


_CHILD_TYPES = {"counter": _CounterChild, "gauge": _GaugeChild,
                "histogram": _HistogramChild}


class _Family:
    """A named metric + its per-label-value children. The no-label
    family doubles as its own single child (``family.inc(...)`` etc.
    delegate), so unlabelled metrics need no ``.labels()`` hop."""

    def __init__(self, registry: "Registry", kind: str, name: str,
                 help: str, labelnames: Sequence[str],
                 buckets: Optional[Sequence[float]] = None):
        _validate_name(name)
        for ln in labelnames:
            _validate_name(ln)
        self._registry = registry
        self.kind = kind
        self.name = name
        self.help = help
        self.labelnames = tuple(labelnames)
        if kind == "histogram":
            edges = tuple(buckets) if buckets else DEFAULT_LATENCY_BUCKETS
            if list(edges) != sorted(edges) or len(set(edges)) != len(edges):
                raise ValueError("histogram buckets must be strictly "
                                 "increasing")
            self.buckets: Tuple[float, ...] = edges
        else:
            self.buckets = ()
        self._lock = threading.Lock()
        self._children: Dict[Tuple[str, ...], _Child] = {}
        if not self.labelnames:
            self._default = self._make_child()
        else:
            self._default = None

    def _make_child(self) -> _Child:
        return _CHILD_TYPES[self.kind](self)

    def labels(self, *labelvalues, **labelkv) -> _Child:
        if labelkv:
            if labelvalues:
                raise ValueError("pass label values either positionally "
                                 "or by keyword, not both")
            try:
                labelvalues = tuple(str(labelkv[ln])
                                    for ln in self.labelnames)
            except KeyError as e:
                raise ValueError(f"missing label {e} for {self.name}")
            if len(labelkv) != len(self.labelnames):
                extra = set(labelkv) - set(self.labelnames)
                raise ValueError(f"unknown labels {extra} for {self.name}")
        else:
            labelvalues = tuple(str(v) for v in labelvalues)
        if len(labelvalues) != len(self.labelnames):
            raise ValueError(
                f"{self.name} expects labels {self.labelnames}, got "
                f"{labelvalues}")
        child = self._children.get(labelvalues)
        if child is None:
            with self._lock:
                child = self._children.setdefault(labelvalues,
                                                  self._make_child())
        return child

    def samples(self) -> List[Tuple[Tuple[str, ...], _Child]]:
        if self._default is not None:
            return [((), self._default)]
        with self._lock:
            return sorted(self._children.items())

    # -- delegation for the unlabelled fast path ------------------------
    def _only(self) -> _Child:
        if self._default is None:
            raise ValueError(
                f"{self.name} is labelled {self.labelnames}; call "
                ".labels(...) first")
        return self._default

    def inc(self, amount: float = 1.0) -> None:
        self._only().inc(amount)

    def dec(self, amount: float = 1.0) -> None:
        self._only().dec(amount)

    def set(self, value: float) -> None:
        self._only().set(value)

    def observe(self, value: float) -> None:
        self._only().observe(value)

    def time(self):
        return self._only().time()

    @property
    def value(self) -> float:
        return self._only().value

    @property
    def count(self) -> int:
        return self._only().count

    @property
    def sum(self) -> float:
        return self._only().sum

    def cumulative_buckets(self):
        return self._only().cumulative_buckets()

    def quantile(self, q: float):
        return self._only().quantile(q)

    @property
    def observed_min(self):
        return self._only().observed_min

    @property
    def observed_max(self):
        return self._only().observed_max

    def total(self) -> float:
        """Sum across all label children (counters/gauges)."""
        return sum(c.value for _, c in self.samples())


class Counter(_Family):
    """Monotonic counter family (constructed via ``Registry.counter``)."""


class Gauge(_Family):
    """Up/down gauge family (constructed via ``Registry.gauge``)."""


class Histogram(_Family):
    """Bucketed distribution family (``Registry.histogram``)."""


_FAMILY_TYPES = {"counter": Counter, "gauge": Gauge,
                 "histogram": Histogram}


class Registry:
    """Holds metric families; the process-wide default lives in
    :func:`default_registry`. ``enabled=False`` (or PD_OBS_DISABLED=1
    for the default registry) turns every mutator into a cheap no-op
    while keeping the objects importable/bindable."""

    def __init__(self, enabled: bool = True):
        self._enabled = bool(enabled)
        self._lock = threading.Lock()
        self._families: Dict[str, _Family] = {}

    # ------------------------------------------------------------ state --
    @property
    def enabled(self) -> bool:
        return self._enabled

    def enable(self) -> None:
        self._enabled = True

    def disable(self) -> None:
        self._enabled = False

    # --------------------------------------------------------- creation --
    def _get_or_create(self, kind: str, name: str, help: str,
                       labelnames: Sequence[str],
                       buckets=None) -> _Family:
        fam = self._families.get(name)
        if fam is not None:
            if fam.kind != kind or fam.labelnames != tuple(labelnames):
                raise ValueError(
                    f"metric {name} already registered as {fam.kind} with "
                    f"labels {fam.labelnames}")
            return fam
        with self._lock:
            fam = self._families.get(name)
            if fam is None:
                fam = _FAMILY_TYPES[kind](self, kind, name, help,
                                          labelnames, buckets)
                self._families[name] = fam
        return fam

    def counter(self, name: str, help: str = "",
                labelnames: Sequence[str] = ()) -> _Family:
        return self._get_or_create("counter", name, help, labelnames)

    def gauge(self, name: str, help: str = "",
              labelnames: Sequence[str] = ()) -> _Family:
        return self._get_or_create("gauge", name, help, labelnames)

    def histogram(self, name: str, help: str = "",
                  labelnames: Sequence[str] = (),
                  buckets: Optional[Sequence[float]] = None) -> _Family:
        return self._get_or_create("histogram", name, help, labelnames,
                                   buckets)

    # ------------------------------------------------------- collection --
    def collect(self) -> List[_Family]:
        with self._lock:
            return sorted(self._families.values(), key=lambda f: f.name)

    def get(self, name: str) -> Optional[_Family]:
        return self._families.get(name)

    def unregister(self, name: str) -> None:
        with self._lock:
            self._families.pop(name, None)


_default = Registry(enabled=os.environ.get("PD_OBS_DISABLED", "0") != "1")


def default_registry() -> Registry:
    return _default


def set_default_registry(registry: Registry) -> Registry:
    """Swap the process default (tests); returns the previous one."""
    global _default
    prev, _default = _default, registry
    return prev


def enabled() -> bool:
    return _default.enabled


def enable() -> None:
    _default.enable()


def disable() -> None:
    _default.disable()

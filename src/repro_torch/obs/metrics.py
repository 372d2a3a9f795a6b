"""Labeled metric instruments: counters, gauges, histograms.

A :class:`MetricRegistry` holds named series keyed by ``(name, labels)``;
``counter``/``gauge``/``histogram`` are get-or-create, so hot callers fetch
an instrument once and then touch only a slot attribute per event — no dict
churn on the recording path.  ``snapshot()`` renders every series into a
plain JSON-safe dict (sorted by series name), which is what benchmark
reports embed and what the tracer emits as a ``metrics.snapshot`` point at
search end.

The disabled path never constructs a registry at all (instrumented modules
guard on their collector being ``None``); :data:`NULL_REGISTRY` exists for
code that wants an unconditional registry handle.
"""
from __future__ import annotations

import math
from typing import Dict, Tuple, Union

#: a series is (metric name, sorted (label, value) pairs)
SeriesKey = Tuple[str, Tuple[Tuple[str, str], ...]]


def series_name(name: str, labels: Tuple[Tuple[str, str], ...]) -> str:
    """Stable display form: ``name`` or ``name{k=v,...}`` (labels sorted)."""
    if not labels:
        return name
    return name + "{" + ",".join(f"{k}={v}" for k, v in labels) + "}"


class Counter:
    """Monotonically increasing event count."""

    __slots__ = ("value",)

    def __init__(self) -> None:
        self.value = 0

    def inc(self, n: int = 1) -> None:
        self.value += n

    def snapshot(self) -> int:
        return self.value


class Gauge:
    """Last-write-wins level (rates, sizes, ratios)."""

    __slots__ = ("value",)

    def __init__(self) -> None:
        self.value = 0.0

    def set(self, v: float) -> None:
        self.value = float(v)

    def snapshot(self) -> float:
        return self.value


class Histogram:
    """Streaming distribution: count/total/min/max plus power-of-two
    magnitude buckets (``frexp`` exponent -> count), enough to see shape
    and tails without storing observations."""

    __slots__ = ("count", "total", "min", "max", "buckets")

    def __init__(self) -> None:
        self.count = 0
        self.total = 0.0
        self.min = math.inf
        self.max = -math.inf
        self.buckets: Dict[int, int] = {}

    def observe(self, v: float) -> None:
        v = float(v)
        self.count += 1
        self.total += v
        if v < self.min:
            self.min = v
        if v > self.max:
            self.max = v
        b = math.frexp(v)[1] if v > 0.0 else 0
        self.buckets[b] = self.buckets.get(b, 0) + 1

    def snapshot(self) -> Dict[str, object]:
        return {
            "count": self.count,
            "total": self.total,
            "min": self.min if self.count else 0.0,
            "max": self.max if self.count else 0.0,
            "mean": self.total / self.count if self.count else 0.0,
            # string keys: the snapshot must JSON-serialize with sort_keys
            "buckets": {str(k): self.buckets[k]
                        for k in sorted(self.buckets)},
        }


Instrument = Union[Counter, Gauge, Histogram]


class MetricRegistry:
    """Get-or-create registry of labeled series."""

    def __init__(self) -> None:
        self._series: Dict[SeriesKey, Instrument] = {}

    def _get(self, cls, name: str, labels: Dict[str, object]) -> Instrument:
        key: SeriesKey = (name, tuple(sorted(
            (k, str(v)) for k, v in labels.items())))
        inst = self._series.get(key)
        if inst is None:
            inst = cls()
            self._series[key] = inst
        elif not isinstance(inst, cls):
            raise TypeError(
                f"metric {series_name(*key)!r} is a "
                f"{type(inst).__name__}, not a {cls.__name__} — one series, "
                f"one instrument type")
        return inst

    def counter(self, name: str, **labels) -> Counter:
        return self._get(Counter, name, labels)  # type: ignore[return-value]

    def gauge(self, name: str, **labels) -> Gauge:
        return self._get(Gauge, name, labels)  # type: ignore[return-value]

    def histogram(self, name: str, **labels) -> Histogram:
        return self._get(Histogram, name,
                         labels)  # type: ignore[return-value]

    def snapshot(self) -> Dict[str, Dict[str, object]]:
        """All series as ``{"counters": {...}, "gauges": {...},
        "histograms": {...}}``, keyed by display name, sorted."""
        out: Dict[str, Dict[str, object]] = {
            "counters": {}, "gauges": {}, "histograms": {}}
        for key in sorted(self._series):
            inst = self._series[key]
            kind = {Counter: "counters", Gauge: "gauges",
                    Histogram: "histograms"}[type(inst)]
            out[kind][series_name(*key)] = inst.snapshot()
        return out

    def __len__(self) -> int:
        return len(self._series)


class _NullInstrument:
    """Shared no-op counter/gauge/histogram (disabled-path singleton)."""

    __slots__ = ()
    value = 0

    def inc(self, n: int = 1) -> None:
        pass

    def set(self, v: float) -> None:
        pass

    def observe(self, v: float) -> None:
        pass


_NULL_INSTRUMENT = _NullInstrument()


class NullRegistry:
    """No-op :class:`MetricRegistry`: every lookup returns one shared
    do-nothing instrument and ``snapshot()`` is empty."""

    def counter(self, name: str, **labels) -> _NullInstrument:
        return _NULL_INSTRUMENT

    gauge = counter
    histogram = counter

    def snapshot(self) -> Dict[str, Dict[str, object]]:
        return {"counters": {}, "gauges": {}, "histograms": {}}

    def __len__(self) -> int:
        return 0


NULL_REGISTRY = NullRegistry()

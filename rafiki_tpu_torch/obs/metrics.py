"""Metrics plane for the port: counters, gauges, histograms, stats maps.

The port's own copy of ``rafiki_tpu/obs/metrics.py`` (the port imports
nothing of the JAX package, even its JAX-free modules): ``Counter``,
``Gauge`` (settable, or live through ``fn``), ``Histogram`` (fixed
buckets, O(log n) observe under one mutex, bucket-interpolated
``quantile`` on demand), ``StatsMap`` (the locked counter dict of the
engines and workers) and ``MetricsRegistry`` (get-or-create instruments
keyed by name and labels, ``register_stats``, a flat ``snapshot`` and
the Prometheus text exposition, format 0.0.4, that ``GET /metrics``
serves). Stdlib only: every process of the stack imports it, including
the ones pinned off the card.
"""

from __future__ import annotations

import math
import threading
from bisect import bisect_left
from typing import (Any, Callable, Dict, Iterator, List, Mapping,
                    MutableMapping, Optional, Sequence, Tuple)

#: default latency buckets (seconds): sub-ms to minutes, roughly
#: log-spaced — TTFT, queue wait, and end-to-end request latency all
#: land usefully inside this range.
DEFAULT_LATENCY_BUCKETS_S: Tuple[float, ...] = (
    0.001, 0.0025, 0.005, 0.01, 0.025, 0.05, 0.1, 0.25, 0.5,
    1.0, 2.5, 5.0, 10.0, 30.0, 60.0, 120.0)

#: Prometheus text exposition content type (version 0.0.4)
PROM_CONTENT_TYPE = "text/plain; version=0.0.4; charset=utf-8"


def _fmt_value(v: Any) -> str:
    """A sample value in exposition form (ints stay ints; floats use
    repr, which round-trips; non-numeric values are dropped upstream)."""
    if isinstance(v, bool):
        return "1" if v else "0"
    if isinstance(v, int):
        return str(v)
    f = float(v)
    if math.isinf(f):
        return "+Inf" if f > 0 else "-Inf"
    return repr(f)


def _fmt_labels(labels: Optional[Mapping[str, str]],
                extra: Optional[Mapping[str, str]] = None) -> str:
    items: List[Tuple[str, str]] = []
    for src in (labels, extra):
        if src:
            items.extend(src.items())
    if not items:
        return ""
    body = ",".join(
        '%s="%s"' % (k, str(v).replace("\\", r"\\").replace('"', r"\"")
                     .replace("\n", r"\n"))
        for k, v in items)
    return "{" + body + "}"


class Counter:
    """Monotonic counter. ``inc`` returns the new value so callers that
    also need the running total (the worker's drop logging) read it from
    the same locked update instead of a second round-trip."""

    kind = "counter"

    __slots__ = ("name", "help", "labels", "_lock", "_v")

    def __init__(self, name: str, help: str = "",
                 labels: Optional[Mapping[str, str]] = None) -> None:
        self.name = name
        self.help = help
        self.labels = dict(labels or {})
        self._lock = threading.Lock()
        self._v = 0.0

    def inc(self, n: float = 1.0) -> float:
        with self._lock:
            self._v += n
            return self._v

    @property
    def value(self) -> float:
        with self._lock:
            return self._v

    def expose(self) -> List[str]:
        return [f"{self.name}{_fmt_labels(self.labels)} "
                f"{_fmt_value(self.value)}"]

    def snapshot_items(self) -> List[Tuple[str, float]]:
        return [(self.name, self.value)]


class Gauge:
    """Settable value; ``fn`` makes it a live gauge evaluated at read
    time (the admin exposes service/slot counts this way — no second
    bookkeeping next to the source of truth)."""

    kind = "gauge"

    __slots__ = ("name", "help", "labels", "fn", "_lock", "_v")

    def __init__(self, name: str, help: str = "",
                 labels: Optional[Mapping[str, str]] = None,
                 fn: Optional[Callable[[], float]] = None) -> None:
        self.name = name
        self.help = help
        self.labels = dict(labels or {})
        self.fn = fn
        self._lock = threading.Lock()
        self._v = 0.0

    def set(self, v: float) -> None:
        with self._lock:
            self._v = float(v)

    def inc(self, n: float = 1.0) -> None:
        with self._lock:
            self._v += n

    @property
    def value(self) -> float:
        if self.fn is not None:
            try:
                return float(self.fn())
            except Exception:  # a scrape must degrade to
                return float("nan")  # NaN, never 500 the surface
        with self._lock:
            return self._v

    def expose(self) -> List[str]:
        return [f"{self.name}{_fmt_labels(self.labels)} "
                f"{_fmt_value(self.value)}"]

    def snapshot_items(self) -> List[Tuple[str, float]]:
        return [(self.name, self.value)]


class Histogram:
    """Fixed-bucket histogram: O(log n_buckets) observe under one
    mutex, cumulative Prometheus exposition, and bucket-interpolated
    quantiles computed only on demand (dashboard p50/p95) — never a
    sorted-sample scan on the request path."""

    kind = "histogram"

    __slots__ = ("name", "help", "labels", "buckets", "_lock", "_counts",
                 "_sum", "_n")

    def __init__(self, name: str, help: str = "",
                 buckets: Sequence[float] = DEFAULT_LATENCY_BUCKETS_S,
                 labels: Optional[Mapping[str, str]] = None) -> None:
        bs = sorted(float(b) for b in buckets)
        if not bs:
            raise ValueError(f"histogram {name!r} needs >= 1 bucket")
        if any(b != b or math.isinf(b) for b in bs):
            raise ValueError(f"histogram {name!r}: finite buckets only "
                             "(+Inf is implicit)")
        self.name = name
        self.help = help
        self.labels = dict(labels or {})
        self.buckets = tuple(bs)
        self._lock = threading.Lock()
        self._counts = [0] * (len(bs) + 1)  # [+Inf] is the last slot
        self._sum = 0.0
        self._n = 0

    def observe(self, v: float) -> None:
        v = float(v)
        # le semantics: v lands in the first bucket whose bound >= v
        i = bisect_left(self.buckets, v)
        with self._lock:
            self._counts[i] += 1
            self._sum += v
            self._n += 1

    @property
    def count(self) -> int:
        with self._lock:
            return self._n

    @property
    def sum(self) -> float:
        with self._lock:
            return self._sum

    def quantile(self, p: float) -> float:
        """Bucket-interpolated quantile estimate in [first bound's
        lower edge (0), last finite bound]. Coarse by construction —
        the fidelity of fixed buckets — but monotone in ``p`` and
        cheap enough for every dashboard refresh."""
        with self._lock:
            counts = list(self._counts)
            n = self._n
        if n == 0:
            return 0.0
        target = max(1, math.ceil(min(1.0, max(0.0, p)) * n))
        cum = 0
        lo = 0.0
        for i, hi in enumerate(self.buckets):
            c = counts[i]
            if cum + c >= target:
                return lo + (hi - lo) * ((target - cum) / c)
            cum += c
            lo = hi
        return self.buckets[-1]  # target lives in the +Inf bucket

    def expose(self) -> List[str]:
        with self._lock:
            counts = list(self._counts)
            total = self._n
            s = self._sum
        lines: List[str] = []
        cum = 0
        for i, b in enumerate(self.buckets):
            cum += counts[i]
            lines.append(
                f"{self.name}_bucket"
                f"{_fmt_labels(self.labels, {'le': _fmt_value(b)})} "
                f"{cum}")
        lines.append(f"{self.name}_bucket"
                     f"{_fmt_labels(self.labels, {'le': '+Inf'})} "
                     f"{total}")
        lines.append(f"{self.name}_sum{_fmt_labels(self.labels)} "
                     f"{_fmt_value(s)}")
        lines.append(f"{self.name}_count{_fmt_labels(self.labels)} "
                     f"{total}")
        return lines

    def snapshot_items(self) -> List[Tuple[str, float]]:
        with self._lock:
            total, s = self._n, self._sum
        return [(f"{self.name}_count", total), (f"{self.name}_sum", s)]


class StatsMap(MutableMapping):
    """A locked dict of numeric counters/gauges with a race-free
    snapshot — the registry-native replacement for the hand-rolled
    ``self.stats`` dicts.

    Reads keep dict ergonomics (``stats["steps"]``, ``dict(stats)``,
    iteration) so every existing test and bench stage works unchanged;
    writes go through :meth:`inc`/:meth:`set`/:meth:`max_set` so the
    ``obs-unregistered-metric`` lint rule can police bare
    ``stats[...] = ...`` writes out of the repo. Iteration and
    :meth:`snapshot` copy under the lock, which is the whole point:
    publishing a snapshot can never race a concurrent mutation into a
    ``dictionary changed size during iteration`` crash (the bug
    ``InferenceWorker._publish_stats`` used to carry).
    """

    def __init__(self, initial: Optional[Mapping[str, Any]] = None
                 ) -> None:
        self._lock = threading.Lock()
        self._d: Dict[str, Any] = dict(initial or {})

    # ---- the write API ----
    def inc(self, key: str, n: float = 1) -> float:
        with self._lock:
            v = self._d.get(key, 0) + n
            self._d[key] = v
            return v

    def set(self, key: str, v: Any) -> None:
        with self._lock:
            self._d[key] = v

    def max_set(self, key: str, v: Any) -> None:
        """Keep the running maximum (high-water marks)."""
        with self._lock:
            self._d[key] = max(self._d.get(key, v), v)

    def reset(self, keep: Optional[Mapping[str, Any]] = None) -> None:
        """Zero every key in place (the key set survives — gauges keep
        exposing), then overlay ``keep`` (capacity gauges that describe
        configuration, not traffic)."""
        with self._lock:
            for k in self._d:
                self._d[k] = 0
            if keep:
                self._d.update(keep)

    def snapshot(self) -> Dict[str, Any]:
        with self._lock:
            return dict(self._d)

    # ---- Mapping protocol (reads + duck-typed compat) ----
    def __getitem__(self, key: str) -> Any:
        with self._lock:
            return self._d[key]

    def __setitem__(self, key: str, v: Any) -> None:
        # exists for duck-typed engine compatibility only; repo code
        # uses inc/set (the lint rule flags subscript writes)
        self.set(key, v)

    def __delitem__(self, key: str) -> None:
        with self._lock:
            del self._d[key]

    def __iter__(self) -> Iterator[str]:
        return iter(self.snapshot())

    def __len__(self) -> int:
        with self._lock:
            return len(self._d)

    def __repr__(self) -> str:
        return f"StatsMap({self.snapshot()!r})"


_NAME_OK = set("abcdefghijklmnopqrstuvwxyz"
               "ABCDEFGHIJKLMNOPQRSTUVWXYZ0123456789_:")


def _check_name(name: str) -> str:
    if not name or name[0].isdigit() or any(c not in _NAME_OK
                                            for c in name):
        raise ValueError(f"invalid metric name {name!r}")
    return name


class MetricsRegistry:
    """Get-or-create instrument registry for one process.

    ``snapshot()`` flattens everything into a plain name→value dict
    (what workers publish to the hub); ``render_prometheus()`` is the
    ``GET /metrics`` body. Registered :class:`StatsMap`s (or any
    zero-arg callable returning a dict) are merged into both as
    untyped gauges — that is how the decode engine's counters surface
    without the engine knowing about HTTP.
    """

    def __init__(self) -> None:
        self._lock = threading.Lock()
        self._instruments: Dict[Tuple[str, Tuple[Tuple[str, str], ...]],
                                Any] = {}
        self._collectors: List[Tuple[str,
                                     Callable[[], Mapping[str, Any]]]] = []

    # ---- get-or-create ----
    def _get(self, cls, name: str, help: str,
             labels: Optional[Mapping[str, str]], **kw: Any):
        key = (_check_name(name),
               tuple(sorted((labels or {}).items())))
        with self._lock:
            inst = self._instruments.get(key)
            if inst is None:
                inst = cls(name, help, labels=labels, **kw)
                self._instruments[key] = inst
            elif not isinstance(inst, cls):
                raise ValueError(
                    f"metric {name!r} already registered as "
                    f"{type(inst).__name__}, requested {cls.__name__}")
            return inst

    def counter(self, name: str, help: str = "",
                labels: Optional[Mapping[str, str]] = None) -> Counter:
        return self._get(Counter, name, help, labels)

    def gauge(self, name: str, help: str = "",
              labels: Optional[Mapping[str, str]] = None,
              fn: Optional[Callable[[], float]] = None) -> Gauge:
        g = self._get(Gauge, name, help, labels, fn=fn)
        if fn is not None:
            g.fn = fn
        return g

    def histogram(self, name: str, help: str = "",
                  buckets: Sequence[float] = DEFAULT_LATENCY_BUCKETS_S,
                  labels: Optional[Mapping[str, str]] = None
                  ) -> Histogram:
        return self._get(Histogram, name, help, labels, buckets=buckets)

    def register_stats(self, stats: Any, prefix: str = "") -> None:
        """Merge a :class:`StatsMap` (or zero-arg dict callable) into
        snapshots and exposition, optionally name-prefixed."""
        fn = stats.snapshot if hasattr(stats, "snapshot") else stats
        if not callable(fn):
            raise TypeError("register_stats wants a StatsMap or a "
                            "zero-arg callable returning a dict")
        with self._lock:
            self._collectors.append((prefix, fn))

    # ---- read-out ----
    def _parts(self):
        with self._lock:
            return list(self._instruments.values()), \
                list(self._collectors)

    def snapshot(self) -> Dict[str, Any]:
        """Flat name→value view: counters/gauges by name, histograms as
        ``<name>_count``/``<name>_sum``, collectors merged (prefixed).
        First registration wins on a name collision."""
        instruments, collectors = self._parts()
        out: Dict[str, Any] = {}
        for inst in instruments:
            for k, v in inst.snapshot_items():
                out.setdefault(k, v)
        for prefix, fn in collectors:
            try:
                d = fn()
            except Exception:  # one broken collector
                continue  # must not take the whole
                # snapshot down, and logging per scrape would flood
            for k, v in d.items():
                out.setdefault(f"{prefix}{k}", v)
        return out

    def render_prometheus(self) -> str:
        """The ``GET /metrics`` body (text exposition format 0.0.4)."""
        instruments, collectors = self._parts()
        lines: List[str] = []
        seen: set = set()
        for inst in instruments:
            if inst.name not in seen:
                seen.add(inst.name)
                if inst.help:
                    lines.append(f"# HELP {inst.name} {inst.help}")
                lines.append(f"# TYPE {inst.name} {inst.kind}")
            lines.extend(inst.expose())
        for prefix, fn in collectors:
            try:
                d = fn()
            except Exception:  # a scrape
                continue  # must render what it can, not 500; per-scrape
                # logging of a persistently broken collector would flood
            for k in sorted(d):
                v = d[k]
                if not isinstance(v, (int, float)):
                    continue  # exposition is numeric-only
                name = f"{prefix}{k}"
                if any(c not in _NAME_OK for c in name) or \
                        name in seen:
                    continue
                seen.add(name)
                lines.append(f"# TYPE {name} gauge")
                lines.append(f"{name} {_fmt_value(v)}")
        return "\n".join(lines) + "\n"

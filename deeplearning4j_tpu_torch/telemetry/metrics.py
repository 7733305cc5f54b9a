"""MetricsRegistry — counters/gauges/histograms with Prometheus exposition
(the port's own copy of deeplearning4j_tpu/telemetry/metrics.py: the same
operations render byte-identical text in both packages).

Process-global registry of labeled metrics, rendered in the Prometheus
text exposition format (version 0.0.4). Pure stdlib: importing this module
touches no device, and increments are a dict lookup + float add under a
re-entrant lock — cheap enough for the cold resilience paths that use them
unconditionally (retries, breaker transitions, chaos injections; see
telemetry/__init__.py for the gating policy).

Naming follows Prometheus conventions: ``*_total`` counters,
``*_seconds``/``*_bytes`` base units, histograms exposing ``_bucket``
(cumulative, ``le`` labels), ``_sum`` and ``_count`` series.
"""
from __future__ import annotations

import math
import threading
from typing import Dict, Iterable, List, Optional, Sequence, Tuple

# default histogram buckets (seconds): spans checkpoint writes from
# sub-ms (tiny test nets) to minutes (real model zips over NFS)
DEFAULT_BUCKETS = (0.001, 0.005, 0.025, 0.1, 0.5, 1.0, 2.5, 5.0, 10.0,
                   30.0, 60.0, 120.0)

_LABEL_ESCAPES = {"\\": "\\\\", '"': '\\"', "\n": "\\n"}


def _escape_label(value: str) -> str:
    return "".join(_LABEL_ESCAPES.get(c, c) for c in str(value))


def _format_value(v: float) -> str:
    if math.isinf(v):
        return "+Inf" if v > 0 else "-Inf"
    if math.isnan(v):
        return "NaN"
    if float(v).is_integer() and abs(v) < 1e15:
        return str(int(v))
    return repr(float(v))


def _series(name: str, labelnames: Sequence[str],
            labelvalues: Sequence[str], value: float,
            extra: Optional[Tuple[str, str]] = None) -> str:
    pairs = [(n, v) for n, v in zip(labelnames, labelvalues)]
    if extra is not None:
        pairs.append(extra)
    if not pairs:
        return f"{name} {_format_value(value)}"
    inner = ",".join(f'{n}="{_escape_label(v)}"' for n, v in pairs)
    return f"{name}{{{inner}}} {_format_value(value)}"


class _Metric:
    """Base: a named family with label support. The unlabeled family IS
    its own child (``labels()`` with no labelnames returns self-like
    state), matching prometheus_client ergonomics."""

    typename = "untyped"

    def __init__(self, name: str, help: str = "",
                 labelnames: Sequence[str] = ()):
        self.name = name
        self.help = help or name
        self.labelnames = tuple(labelnames)
        self._lock = threading.RLock()
        self._children: Dict[Tuple[str, ...], "_Metric"] = {}  # guarded-by: self._lock
        self._init_value()

    def _init_value(self):
        self._value = 0.0  # guarded-by: self._lock

    def labels(self, *values, **kv) -> "_Metric":
        if kv:
            if values:
                raise ValueError("pass label values positionally OR by "
                                 "keyword, not both")
            values = tuple(kv[n] for n in self.labelnames)
        key = tuple(str(v) for v in values)
        if len(key) != len(self.labelnames):
            raise ValueError(
                f"{self.name}: expected labels {self.labelnames}, "
                f"got {key}")
        with self._lock:
            child = self._children.get(key)
            if child is None:
                child = type(self)(self.name, self.help, ())
                self._children[key] = child
            return child

    def _own_series(self) -> List[str]:
        return [_series(self.name, (), (), self._value)]

    def _child_series(self, key: Tuple[str, ...]) -> List[str]:
        child = self._children[key]
        out = []
        for line in child._own_series():
            # splice the parent's labels into the child's series
            name, rest = line.split(" ", 1)
            base, brace, inner = name.partition("{")
            pairs = [f'{n}="{_escape_label(v)}"'
                     for n, v in zip(self.labelnames, key)]
            if brace:
                inner = ",".join(pairs) + ("," + inner[:-1] if inner[:-1]
                                           else "")
                out.append(f"{base}{{{inner}}} {rest}")
            else:
                out.append(f"{base}{{{','.join(pairs)}}} {rest}")
        return out

    def render(self) -> List[str]:
        with self._lock:
            lines = [f"# HELP {self.name} {self.help}",
                     f"# TYPE {self.name} {self.typename}"]
            if self.labelnames:
                for key in sorted(self._children):
                    lines.extend(self._child_series(key))
            else:
                lines.extend(self._own_series())
            return lines

    def reset(self):
        with self._lock:
            self._init_value()
            for child in self._children.values():
                child.reset()

    def snapshot(self):
        """Machine-readable totals (flight bundles + tests)."""
        with self._lock:
            if self.labelnames:
                return {",".join(f"{n}={v}" for n, v
                                 in zip(self.labelnames, key)): c.snapshot()
                        for key, c in sorted(self._children.items())}
            return self._snapshot_own()

    def _snapshot_own(self):
        return self._value

    def child_items(self) -> List[Tuple[Dict[str, str], "_Metric"]]:
        """(labels_dict, child) pairs for programmatic readers (the SLO
        engine's selectors). An unlabeled family yields ``({}, self)`` —
        every family is uniformly a set of series."""
        with self._lock:
            if not self.labelnames:
                return [({}, self)]
            return [(dict(zip(self.labelnames, key)), child)
                    for key, child in sorted(self._children.items())]

    def _check_unlabeled(self, op: str):
        if self.labelnames:
            raise ValueError(
                f"{self.name} has labels {self.labelnames}: call "
                f".labels(...).{op}(...)")


class Counter(_Metric):
    typename = "counter"

    def inc(self, amount: float = 1.0):
        self._check_unlabeled("inc")
        if amount < 0:
            raise ValueError("counters only go up")
        with self._lock:
            self._value += amount

    @property
    def value(self) -> float:
        # torn float reads are impossible under the GIL, but a lock-free
        # read here could legally see a stale value forever on a
        # free-threaded build; the RLock is uncontended and re-entrant
        with self._lock:
            return self._value


class Gauge(_Metric):
    typename = "gauge"

    def set(self, value: float):
        self._check_unlabeled("set")
        with self._lock:
            self._value = float(value)

    def inc(self, amount: float = 1.0):
        self._check_unlabeled("inc")
        with self._lock:
            self._value += amount

    def dec(self, amount: float = 1.0):
        self.inc(-amount)

    @property
    def value(self) -> float:
        with self._lock:
            return self._value


class Histogram(_Metric):
    typename = "histogram"

    def __init__(self, name: str, help: str = "",
                 labelnames: Sequence[str] = (),
                 buckets: Iterable[float] = DEFAULT_BUCKETS):
        self._buckets = tuple(sorted(float(b) for b in buckets))
        if not self._buckets:
            raise ValueError("histogram needs at least one bucket bound")
        super().__init__(name, help, labelnames)

    def _init_value(self):
        self._counts = [0] * len(self._buckets)  # guarded-by: self._lock
        self._sum = 0.0  # guarded-by: self._lock
        self._count = 0  # guarded-by: self._lock

    def labels(self, *values, **kv) -> "Histogram":
        # children must share the parent's bucket bounds
        key_child = super().labels(*values, **kv)
        if key_child._buckets != self._buckets:  # fresh child: rebuild
            key_child._buckets = self._buckets
            key_child._init_value()
        return key_child

    def observe(self, value: float):
        self._check_unlabeled("observe")
        value = float(value)
        with self._lock:
            self._sum += value
            self._count += 1
            # per-bin counts; the renderer cumulates them into the
            # Prometheus `le` series (values above every bound land only
            # in the implicit +Inf bucket = _count)
            for i, bound in enumerate(self._buckets):
                if value <= bound:
                    self._counts[i] += 1
                    break

    @property
    def count(self) -> int:
        with self._lock:
            return self._count

    @property
    def sum(self) -> float:
        with self._lock:
            return self._sum

    def _own_series(self) -> List[str]:
        lines = []
        cum = 0
        for bound, n in zip(self._buckets, self._counts):
            cum += n
            lines.append(_series(self.name + "_bucket", (), (), cum,
                                 extra=("le", _format_value(bound))))
        lines.append(_series(self.name + "_bucket", (), (), self._count,
                             extra=("le", "+Inf")))
        lines.append(_series(self.name + "_sum", (), (), self._sum))
        lines.append(_series(self.name + "_count", (), (), self._count))
        return lines

    def _snapshot_own(self):
        return {"count": self._count, "sum": round(self._sum, 6)}

    def merge_cumulative(self, bounds: Sequence[float],
                         cumulative: Sequence[int], sum_: float,
                         count: int) -> None:
        """Fold another histogram's state into this one — the fleet
        aggregation path (telemetry/aggregate.py). ``bounds`` must match
        this family's bucket bounds EXACTLY (sorted, same length): two
        sources observing under different bucketings cannot be summed
        bin-for-bin, and a silent mismatch would fabricate latency
        quantiles — so a mismatch raises instead of guessing.
        ``cumulative`` is the Prometheus ``le`` series (without the
        implicit +Inf entry), as ``bucket_counts()`` emits it."""
        self._check_unlabeled("merge_cumulative")
        bounds = tuple(float(b) for b in bounds)
        if bounds != self._buckets:
            raise ValueError(
                f"{self.name}: bucket-boundary mismatch — registered "
                f"{self._buckets}, merging {bounds}")
        if len(cumulative) != len(bounds):
            raise ValueError(
                f"{self.name}: {len(bounds)} bounds but "
                f"{len(cumulative)} cumulative counts")
        with self._lock:
            prev = 0
            for i, cum in enumerate(cumulative):
                self._counts[i] += int(cum) - prev
                prev = int(cum)
            self._sum += float(sum_)
            self._count += int(count)

    def bucket_counts(self) -> List[Tuple[float, int]]:
        """CUMULATIVE ``(upper_bound, count)`` pairs ending with the
        implicit ``(+Inf, total_count)`` — exactly the Prometheus
        ``le`` series, as data instead of text. The SLO engine's
        histogram-threshold evaluator reads this (telemetry/slo.py);
        ``snapshot()`` stays count/sum-only."""
        with self._lock:
            out: List[Tuple[float, int]] = []
            cum = 0
            for bound, n in zip(self._buckets, self._counts):
                cum += n
                out.append((bound, cum))
            out.append((math.inf, self._count))
            return out


class MetricsRegistry:
    """Get-or-create registry; re-registering a name returns the existing
    metric (and raises on a type/label mismatch, the silent-drift guard)."""

    def __init__(self):
        self._lock = threading.RLock()
        self._metrics: Dict[str, _Metric] = {}  # guarded-by: self._lock

    def _get_or_create(self, cls, name: str, help: str,
                       labelnames: Sequence[str], **kw) -> _Metric:
        with self._lock:
            m = self._metrics.get(name)
            if m is not None:
                if not isinstance(m, cls) or (tuple(labelnames)
                                              != m.labelnames):
                    raise ValueError(
                        f"metric {name!r} already registered as "
                        f"{type(m).__name__}{m.labelnames}, requested "
                        f"{cls.__name__}{tuple(labelnames)}")
                want = kw.get("buckets")
                if (want is not None
                        and tuple(sorted(float(b) for b in want))
                        != m._buckets):
                    raise ValueError(
                        f"histogram {name!r} already registered with "
                        f"buckets {m._buckets}, requested "
                        f"{tuple(sorted(float(b) for b in want))}")
                return m
            m = cls(name, help, labelnames, **kw)
            self._metrics[name] = m
            return m

    def counter(self, name: str, help: str = "",
                labelnames: Sequence[str] = ()) -> Counter:
        return self._get_or_create(Counter, name, help, labelnames)

    def gauge(self, name: str, help: str = "",
              labelnames: Sequence[str] = ()) -> Gauge:
        return self._get_or_create(Gauge, name, help, labelnames)

    def histogram(self, name: str, help: str = "",
                  labelnames: Sequence[str] = (),
                  buckets: Iterable[float] = DEFAULT_BUCKETS) -> Histogram:
        return self._get_or_create(Histogram, name, help, labelnames,
                                   buckets=buckets)

    def render(self) -> str:
        """Prometheus text exposition (0.0.4) over every metric."""
        with self._lock:
            metrics = [self._metrics[k] for k in sorted(self._metrics)]
        lines: List[str] = []
        for m in metrics:
            lines.extend(m.render())
        return "\n".join(lines) + ("\n" if lines else "")

    def snapshot(self) -> Dict[str, object]:
        with self._lock:
            return {name: m.snapshot()
                    for name, m in sorted(self._metrics.items())}

    def reset(self) -> None:
        """Zero every registered metric's values (metrics stay registered:
        module-level call sites keep their handles valid)."""
        with self._lock:
            for m in self._metrics.values():
                m.reset()

    def get(self, name: str) -> Optional[_Metric]:
        with self._lock:
            return self._metrics.get(name)

    def families(self) -> List[_Metric]:
        """Registered metric objects, name-sorted — the programmatic
        twin of ``render()`` for readers that need types/labels/bins as
        data (the telemetry/export.py frame builder)."""
        with self._lock:
            return [self._metrics[k] for k in sorted(self._metrics)]


_registry = MetricsRegistry()


def registry() -> MetricsRegistry:
    return _registry


def counter(name: str, help: str = "",
            labelnames: Sequence[str] = ()) -> Counter:
    return _registry.counter(name, help, labelnames)


def gauge(name: str, help: str = "", labelnames: Sequence[str] = ()) -> Gauge:
    return _registry.gauge(name, help, labelnames)


def histogram(name: str, help: str = "", labelnames: Sequence[str] = (),
              buckets: Iterable[float] = DEFAULT_BUCKETS) -> Histogram:
    return _registry.histogram(name, help, labelnames, buckets=buckets)


def render_prometheus() -> str:
    return _registry.render()

"""Counter / gauge / histogram registry for the serving + tuning stack.

One ``Registry`` instance per server (the launch driver makes one and hands
it to the engine, the scheduler, the fault plan, and the tuner) absorbs the
counters that used to live as ad-hoc attributes on ``SwapStore``,
``FaultPlan`` and ``TuningCache`` — those classes keep their old attribute
names as thin read-only views over registry instruments, so every number the
stack has ever reported now also flows through one exportable place.

Instruments:

* ``Counter``   — monotonically increasing value (ints stay ints, so a
                  registry read is bit-for-bit the legacy attribute).
* ``Gauge``     — last-set value plus the lifetime ``lo``/``hi`` water
                  marks (free-page high-water = the gauge's ``lo``).
* ``Histogram`` — fixed upper-bound buckets (+inf implicit), count + sum;
                  the serving drivers use them for TTFT, inter-token
                  latency, queue wait, and swap round-trip times.

Labels are static per instrument (``registry.counter(name, state="ok")``)
— the registry key is the Prometheus-style ``name{k="v"}`` string, which
keeps the snapshot JSON flat and the text exposition trivial.

Export: ``snapshot()`` is a plain JSON-able dict; ``to_prometheus()`` is
the text exposition format; ``line()`` is the compact one-line form the
serve driver prints every ``--metrics-every N`` quanta.
"""
from __future__ import annotations

import math

# upper bounds in seconds for latency-ish histograms (CPU-interpret scale
# through real-TPU scale); +inf is implicit
TIME_BUCKETS = (1e-4, 2.5e-4, 5e-4, 1e-3, 2.5e-3, 5e-3, 1e-2, 2.5e-2,
                5e-2, 0.1, 0.25, 0.5, 1.0, 2.5, 5.0, 10.0, 30.0)
# upper bounds in scheduler quanta for queue-wait style histograms
QUANTA_BUCKETS = (0, 1, 2, 4, 8, 16, 32, 64, 128, 256)


def _key(name: str, labels: dict) -> str:
    if not labels:
        return name
    inner = ",".join(f'{k}="{v}"' for k, v in sorted(labels.items()))
    return f"{name}{{{inner}}}"


class Counter:
    __slots__ = ("name", "labels", "help", "value")

    def __init__(self, name: str, help: str = "", **labels):
        self.name, self.labels, self.help = name, labels, help
        self.value = 0

    def inc(self, n=1) -> None:
        if n < 0:
            raise ValueError(f"counter {self.name} cannot decrease by {n}")
        self.value += n

    @property
    def key(self) -> str:
        return _key(self.name, self.labels)


class Gauge:
    __slots__ = ("name", "labels", "help", "value", "lo", "hi")

    def __init__(self, name: str, help: str = "", **labels):
        self.name, self.labels, self.help = name, labels, help
        self.value = 0.0
        self.lo = math.inf      # lifetime low-water mark
        self.hi = -math.inf     # lifetime high-water mark

    def set(self, v) -> None:
        self.value = v
        if v < self.lo:
            self.lo = v
        if v > self.hi:
            self.hi = v

    def inc(self, n=1) -> None:
        self.set(self.value + n)

    def dec(self, n=1) -> None:
        self.set(self.value - n)

    @property
    def key(self) -> str:
        return _key(self.name, self.labels)


class Histogram:
    """Fixed-bucket histogram: ``buckets`` are inclusive upper bounds in
    increasing order; the +inf bucket is implicit."""
    __slots__ = ("name", "labels", "help", "buckets", "counts", "sum",
                 "count")

    def __init__(self, name: str, buckets=TIME_BUCKETS, help: str = "",
                 **labels):
        b = tuple(float(x) for x in buckets)
        if not b or any(b[i] >= b[i + 1] for i in range(len(b) - 1)):
            raise ValueError(f"histogram {name}: buckets must be strictly "
                             f"increasing, got {b}")
        self.name, self.labels, self.help = name, labels, help
        self.buckets = b
        self.counts = [0] * (len(b) + 1)      # last = +inf overflow
        self.sum = 0.0
        self.count = 0

    def observe(self, v) -> None:
        v = float(v)
        i = 0
        for i, ub in enumerate(self.buckets):
            if v <= ub:
                self.counts[i] += 1
                break
        else:
            self.counts[len(self.buckets)] += 1
        self.sum += v
        self.count += 1

    def quantile(self, q: float) -> float:
        """Bucket-resolution quantile estimate (upper bound of the bucket
        holding the q-th observation); +inf observations clamp to the last
        finite bound."""
        if not 0.0 <= q <= 1.0:
            raise ValueError(f"quantile {q}")
        if self.count == 0:
            return 0.0
        target, seen = q * self.count, 0
        for i, c in enumerate(self.counts):
            seen += c
            if seen >= target and c:
                return self.buckets[min(i, len(self.buckets) - 1)]
        return self.buckets[-1]

    @property
    def key(self) -> str:
        return _key(self.name, self.labels)


class Registry:
    """Create-or-return instrument store with JSON + Prometheus export."""

    def __init__(self):
        self._instruments: dict[str, object] = {}

    def _get(self, cls, name, labels, **kw):
        key = _key(name, labels)
        inst = self._instruments.get(key)
        if inst is None:
            inst = self._instruments[key] = cls(name, **kw, **labels)
        elif not isinstance(inst, cls):
            raise TypeError(f"{key} already registered as "
                            f"{type(inst).__name__}, not {cls.__name__}")
        return inst

    def counter(self, name: str, help: str = "", **labels) -> Counter:
        return self._get(Counter, name, labels, help=help)

    def gauge(self, name: str, help: str = "", **labels) -> Gauge:
        return self._get(Gauge, name, labels, help=help)

    def histogram(self, name: str, buckets=TIME_BUCKETS, help: str = "",
                  **labels) -> Histogram:
        return self._get(Histogram, name, labels, buckets=buckets, help=help)

    def __contains__(self, key: str) -> bool:
        return key in self._instruments

    def __len__(self) -> int:
        return len(self._instruments)

    def get(self, name: str, **labels):
        """The instrument at ``name`` (+ labels), or None."""
        return self._instruments.get(_key(name, labels))

    def value(self, name: str, default=None, **labels):
        """Counter/gauge value (histograms: their count) by name; KeyError
        unless ``default`` is given."""
        inst = self._instruments.get(_key(name, labels))
        if inst is None:
            if default is not None:
                return default
            raise KeyError(_key(name, labels))
        return inst.count if isinstance(inst, Histogram) else inst.value

    # -- export --------------------------------------------------------------

    def snapshot(self) -> dict:
        """JSON-able dict of every instrument (the --metrics-out payload)."""
        counters, gauges, hists = {}, {}, {}
        for key, inst in sorted(self._instruments.items()):
            if isinstance(inst, Counter):
                counters[key] = inst.value
            elif isinstance(inst, Gauge):
                gauges[key] = {
                    "value": inst.value,
                    "lo": None if inst.lo is math.inf else inst.lo,
                    "hi": None if inst.hi is -math.inf else inst.hi}
            else:
                hists[key] = {"buckets": list(inst.buckets),
                              "counts": list(inst.counts),
                              "sum": inst.sum, "count": inst.count,
                              "p50": inst.quantile(0.5),
                              "p99": inst.quantile(0.99)}
        return {"counters": counters, "gauges": gauges, "histograms": hists}

    def to_prometheus(self) -> str:
        """Prometheus text exposition (untyped labels-inline form)."""
        lines, typed = [], set()
        for key, inst in sorted(self._instruments.items()):
            kind = ("counter" if isinstance(inst, Counter) else
                    "gauge" if isinstance(inst, Gauge) else "histogram")
            if inst.name not in typed:
                typed.add(inst.name)
                if inst.help:
                    lines.append(f"# HELP {inst.name} {inst.help}")
                lines.append(f"# TYPE {inst.name} {kind}")
            if isinstance(inst, (Counter, Gauge)):
                lines.append(f"{key} {inst.value}")
                if isinstance(inst, Gauge) and inst.hi is not -math.inf:
                    base = dict(inst.labels)
                    lines.append(f"{_key(inst.name + '_lo', base)} {inst.lo}")
                    lines.append(f"{_key(inst.name + '_hi', base)} {inst.hi}")
            else:
                cum = 0
                for ub, c in zip(inst.buckets + (math.inf,), inst.counts):
                    cum += c
                    le = "+Inf" if ub is math.inf else repr(ub)
                    lb = dict(inst.labels, le=le)
                    lines.append(f"{_key(inst.name + '_bucket', lb)} {cum}")
                lines.append(f"{_key(inst.name + '_sum', inst.labels)} "
                             f"{inst.sum}")
                lines.append(f"{_key(inst.name + '_count', inst.labels)} "
                             f"{inst.count}")
        return "\n".join(lines) + "\n"

    def line(self, prefix: str | None = None) -> str:
        """Compact one-line summary (counters + gauges; histograms as
        count/p50) for the driver's periodic --metrics-every output."""
        parts = []
        for key, inst in sorted(self._instruments.items()):
            if prefix and not inst.name.startswith(prefix):
                continue
            if isinstance(inst, Counter):
                parts.append(f"{key}={inst.value}")
            elif isinstance(inst, Gauge):
                v = inst.value
                parts.append(f"{key}={v:g}" if isinstance(v, float)
                             else f"{key}={v}")
            else:
                parts.append(f"{key}:n={inst.count},"
                             f"p50={inst.quantile(0.5):g}")
        return " ".join(parts)

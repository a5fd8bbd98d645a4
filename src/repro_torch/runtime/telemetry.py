"""Observability primitives (port of ``repro.runtime.telemetry``):
histograms, a metrics registry, and tracing.

Lifetime-average counters cannot see a distribution: a TTFT p99
regression, a decode-stall spike or a cache-hit collapse under churn all
vanish into the mean.  This module is the telemetry layer the serving
runtime records into, with the reference's names, formats and semantics:

  * :class:`Histogram` -- fixed-bucket log-scale latency histograms with
    p50/p90/p99 estimation (one bucket is a constant *relative* error
    anywhere in the range);
  * :class:`MetricsRegistry` -- a pull-based registry: every counter /
    gauge / histogram is registered by name with a getter and rendered
    on demand as Prometheus text exposition (:meth:`MetricsRegistry.render`;
    :func:`parse_prom` validates it);
  * :class:`Tracer` -- per-request lifecycle span trees (``queued ->
    admitted -> prefill_chunk[i] -> decode -> retired``) plus scheduler /
    weight-store phase spans, exported as Chrome-trace JSON (loadable in
    ``chrome://tracing`` / Perfetto) and as JSONL events;
  * :class:`Telemetry` -- the facade the runtime threads around: a
    ``timed(phase)`` context manager that records a phase histogram and
    (when tracing) a span.

Every clock here is the host's ``time.monotonic()``.  On a CUDA device
kernels return before the device finishes them, so a phase's time is the
time to enqueue its work, unless the phase itself waits on the device
(a token readback does).  Nothing in this module waits on the device:
telemetry observes the host loop and never changes what it blocks on.

Cost discipline: the default recorder is :data:`NULL_TELEMETRY`, whose
``timed`` returns one shared no-op context manager and whose tracer
drops everything -- serving with telemetry disabled does no extra work
beyond an attribute read, and telemetry never influences scheduling, so
generated tokens are identical with it on or off (tested).
"""

from __future__ import annotations

import bisect
import contextlib
import json
import math
import re
import time

# Chrome-trace "process" ids: one per track family so Perfetto groups
# request lifecycles separately from engine phases.
PID_REQUEST = 1     # one thread (tid) per request id
PID_ENGINE = 2      # scheduler / weight-store phase spans, tid 0

_US = 1e6           # chrome trace timestamps are microseconds


# ---------------------------------------------------------------------------
# histograms
# ---------------------------------------------------------------------------

class Histogram:
    """Fixed-bucket log-scale histogram (values in seconds by default).

    Bucket upper edges are ``lo * 10**(i / per_decade)`` — geometric
    growth, so percentile estimates carry a constant *relative* error of
    one bucket ratio (``10**(1/per_decade)``, ~1.58x at the default 5
    buckets per decade) anywhere in the range.  Values at or below the
    smallest edge land in bucket 0; values above the largest edge land
    in the overflow bucket and are reported as the observed max.
    Recording is a bisect + three adds — cheap enough to stay on in the
    scheduler hot loop.
    """

    __slots__ = ("bounds", "counts", "n", "total", "min", "max")

    def __init__(self, lo: float = 1e-6, hi: float = 120.0,
                 per_decade: int = 5):
        n = int(math.ceil(per_decade * math.log10(hi / lo))) + 1
        self.bounds: tuple = tuple(lo * 10 ** (i / per_decade)
                                   for i in range(n))
        self.counts: list[int] = [0] * (n + 1)      # +1: overflow bucket
        self.n = 0
        self.total = 0.0
        self.min = math.inf
        self.max = -math.inf

    def record(self, value: float) -> None:
        v = float(value)
        self.counts[bisect.bisect_left(self.bounds, v)] += 1
        self.n += 1
        self.total += v
        if v < self.min:
            self.min = v
        if v > self.max:
            self.max = v

    def mean(self) -> float:
        return self.total / self.n if self.n else 0.0

    def percentile(self, p: float) -> float:
        """Estimated ``p``-th percentile (log-interpolated within the
        bucket holding that rank; clamped to the observed min/max, so
        the estimate always lies inside the value range)."""
        if not self.n:
            return 0.0
        rank = max(1, math.ceil(p / 100.0 * self.n))
        cum = 0
        for i, c in enumerate(self.counts):
            if cum + c >= rank:
                if i == len(self.bounds):       # overflow bucket
                    return self.max
                hi = self.bounds[i]
                lo = self.bounds[i - 1] if i else \
                    hi / (self.bounds[1] / self.bounds[0])
                frac = (rank - cum) / c
                est = lo * (hi / lo) ** frac
                return min(max(est, self.min), self.max)
            cum += c
        return self.max

    def percentiles(self, *ps: float) -> tuple:
        return tuple(self.percentile(p) for p in ps)


# ---------------------------------------------------------------------------
# pull-based metrics registry -> Prometheus text exposition
# ---------------------------------------------------------------------------

class MetricsRegistry:
    """Name -> getter registry rendered as Prometheus text exposition.

    Pull-based: registration stores a callable, not a value, so one
    registry built at startup always renders current counters.  Names
    get a ``namespace_`` prefix and must be valid Prometheus metric
    names; counters should end ``_total`` by convention (the tests
    assert monotonicity for every ``_total``/``_count``/``_bucket``
    sample across scrapes).
    """

    _NAME_RE = re.compile(r"^[a-zA-Z_:][a-zA-Z0-9_:]*$")

    def __init__(self, namespace: str = "repro"):
        self.namespace = namespace
        self._metrics: list[tuple] = []     # (name, kind, getter, help)

    def _add(self, name: str, kind: str, getter, help_: str) -> None:
        full = f"{self.namespace}_{name}"
        if not self._NAME_RE.match(full):
            raise ValueError(f"invalid metric name {full!r}")
        if any(m[0] == full for m in self._metrics):
            raise ValueError(f"metric {full!r} already registered")
        self._metrics.append((full, kind, getter, help_))

    def counter(self, name: str, getter, help_: str = "") -> None:
        self._add(name, "counter", getter, help_)

    def gauge(self, name: str, getter, help_: str = "") -> None:
        self._add(name, "gauge", getter, help_)

    def histogram(self, name: str, hist: Histogram | "callable",
                  help_: str = "") -> None:
        getter = hist if callable(hist) else (lambda: hist)
        self._add(name, "histogram", getter, help_)

    def sample(self) -> dict:
        """Scalar samples (counters + gauges) by full name — the
        interval-snapshot primitive."""
        return {name: float(getter())
                for name, kind, getter, _ in self._metrics
                if kind != "histogram"}

    def render(self) -> str:
        """Prometheus text-exposition format (0.0.4)."""
        lines = []
        for name, kind, getter, help_ in self._metrics:
            if help_:
                lines.append(f"# HELP {name} {help_}")
            lines.append(f"# TYPE {name} {kind}")
            if kind != "histogram":
                lines.append(f"{name} {_fmt_value(float(getter()))}")
                continue
            h: Histogram = getter()
            cum = 0
            for bound, c in zip(h.bounds, h.counts):
                cum += c
                lines.append(f'{name}_bucket{{le="{_fmt_value(bound)}"}} '
                             f"{cum}")
            lines.append(f'{name}_bucket{{le="+Inf"}} {h.n}')
            lines.append(f"{name}_sum {_fmt_value(h.total)}")
            lines.append(f"{name}_count {h.n}")
        return "\n".join(lines) + "\n"


def _fmt_value(v: float) -> str:
    if v == int(v) and abs(v) < 1e15:
        return str(int(v))
    return repr(float(v))


_SAMPLE_RE = re.compile(
    r"^(?P<name>[a-zA-Z_:][a-zA-Z0-9_:]*)"
    r"(?:\{(?P<labels>[^}]*)\})?"
    r"\s+(?P<value>[^\s]+)$")


def parse_prom(text: str) -> dict:
    """Parse Prometheus text exposition -> ``{(name, labels): value}``.

    ``labels`` is the raw label string (``""`` when absent), so
    histogram buckets keep distinct keys.  Raises ``ValueError`` on any
    malformed line — this is the validator CI and the tests run over
    every ``.prom`` dump, so a rendering regression cannot land.
    """
    out: dict = {}
    for lineno, line in enumerate(text.splitlines(), 1):
        line = line.strip()
        if not line or line.startswith("#"):
            continue
        m = _SAMPLE_RE.match(line)
        if m is None:
            raise ValueError(f"malformed prometheus line {lineno}: {line!r}")
        try:
            value = float(m.group("value"))
        except ValueError:
            raise ValueError(
                f"malformed prometheus value on line {lineno}: "
                f"{line!r}") from None
        out[(m.group("name"), m.group("labels") or "")] = value
    return out


# ---------------------------------------------------------------------------
# tracing: per-request span trees + engine phase spans
# ---------------------------------------------------------------------------

class Tracer:
    """Event recorder exporting Chrome-trace JSON and JSONL.

    Events live in one flat list in the Chrome ``traceEvents`` shape:
    complete spans (``ph="X"``: name, ts, dur) and instants
    (``ph="i"``).  Tracks are ``(pid, tid)`` pairs — requests get
    ``(PID_REQUEST, rid)`` so each request renders as its own lane,
    engine phases share ``(PID_ENGINE, 0)`` and nest by containment
    (the runtime is single-threaded and synchronous).  Timestamps are
    microseconds relative to tracer construction.
    """

    enabled = True

    def __init__(self):
        self.t0 = time.monotonic()
        self.events: list[dict] = []
        self._track_names: dict = {}

    def now(self) -> float:
        return time.monotonic()

    def _ts(self, t: float) -> float:
        return (t - self.t0) * _US

    def complete(self, pid: int, tid: int, name: str, t0: float,
                 t1: float, **args) -> None:
        """One complete span [t0, t1] (monotonic seconds)."""
        self.events.append({
            "ph": "X", "name": name, "pid": pid, "tid": tid,
            "ts": self._ts(t0), "dur": max((t1 - t0) * _US, 0.0),
            "args": args})

    def instant(self, pid: int, tid: int, name: str,
                t: float | None = None, **args) -> None:
        self.events.append({
            "ph": "i", "s": "t", "name": name, "pid": pid, "tid": tid,
            "ts": self._ts(self.now() if t is None else t), "args": args})

    @contextlib.contextmanager
    def span(self, pid: int, tid: int, name: str, **args):
        t0 = self.now()
        try:
            yield
        finally:
            self.complete(pid, tid, name, t0, self.now(), **args)

    def name_track(self, pid: int, tid: int, name: str) -> None:
        self._track_names[(pid, tid)] = name

    # -- export ------------------------------------------------------------
    def chrome(self) -> dict:
        """Chrome-trace JSON object (load in chrome://tracing or
        https://ui.perfetto.dev)."""
        meta = []
        pids = {pid for pid, _ in self._track_names} | \
            {e["pid"] for e in self.events}
        proc_names = {PID_REQUEST: "requests", PID_ENGINE: "engine"}
        for pid in sorted(pids):
            meta.append({"ph": "M", "name": "process_name", "pid": pid,
                         "tid": 0,
                         "args": {"name": proc_names.get(pid, str(pid))}})
        for (pid, tid), name in sorted(self._track_names.items()):
            meta.append({"ph": "M", "name": "thread_name", "pid": pid,
                         "tid": tid, "args": {"name": name}})
        return {"traceEvents": meta + self.events,
                "displayTimeUnit": "ms"}

    def write_chrome(self, path) -> None:
        with open(path, "w") as f:
            json.dump(self.chrome(), f)

    def write_jsonl(self, path) -> None:
        """One JSON event per line (grep/jq-friendly event log)."""
        with open(path, "w") as f:
            for e in self.events:
                f.write(json.dumps(e) + "\n")


class NullTracer:
    """Drops everything; ``enabled`` lets hot paths skip arg building."""

    enabled = False

    def now(self) -> float:
        return time.monotonic()

    def complete(self, *args, **kwargs) -> None:
        pass

    def instant(self, *args, **kwargs) -> None:
        pass

    def span(self, *args, **kwargs):
        return _NULL_CTX

    def name_track(self, *args, **kwargs) -> None:
        pass


NULL_TRACER = NullTracer()
_NULL_CTX = contextlib.nullcontext()


# ---------------------------------------------------------------------------
# the facade the runtime threads through
# ---------------------------------------------------------------------------

class _Timed:
    """``timed(phase)`` context: phase histogram + (if tracing) a span."""

    __slots__ = ("tel", "phase", "args", "t0")

    def __init__(self, tel: "Telemetry", phase: str, args: dict):
        self.tel = tel
        self.phase = phase
        self.args = args

    def __enter__(self):
        self.t0 = time.monotonic()
        return self

    def __exit__(self, *exc):
        t1 = time.monotonic()
        tel = self.tel
        hist = tel.phases.get(self.phase)
        if hist is None:
            hist = tel.phases[self.phase] = Histogram()
        hist.record(t1 - self.t0)
        if tel.tracer.enabled:
            tel.tracer.complete(PID_ENGINE, 0, self.phase, self.t0, t1,
                                **self.args)
        return False


class Telemetry:
    """Request tracing + phase timing, threaded through the runtime.

    ``trace=True`` records per-request lifecycle spans and engine phase
    spans into a :class:`Tracer`; ``trace=False`` keeps only the cheap
    per-phase histograms (still rendered into the Prometheus dump).
    The runtime default is :data:`NULL_TELEMETRY`, which records
    nothing at all.
    """

    def __init__(self, trace: bool = False):
        self.tracer: Tracer | NullTracer = Tracer() if trace \
            else NULL_TRACER
        self.phases: dict[str, Histogram] = {}

    @property
    def tracing(self) -> bool:
        return self.tracer.enabled

    def timed(self, phase: str, **args) -> _Timed:
        """Time a phase: records into ``phases[phase]`` and, when
        tracing, emits an engine-track span."""
        return _Timed(self, phase, args)


class NullTelemetry:
    """The no-op default: ``timed`` hands back one shared null context,
    so a disabled run's overhead is a method call returning a constant."""

    tracing = False
    tracer = NULL_TRACER
    phases: dict = {}

    def timed(self, phase: str, **args):
        return _NULL_CTX


NULL_TELEMETRY = NullTelemetry()

"""The port's served trace against the JAX ``Scheduler``, on the CPU.

* ``tests/harness.py::MIXED`` with unit-scale MLPs, served with
  ``Telemetry(trace=True)`` by both packages' ``Scheduler`` (each from a
  cold tile cache): tokens equal the port's untraced run's and the
  reference's; the multiset of ``(pid, tid, name)`` events, the request
  tracks' arguments, the Prometheus metric names, kinds, help strings and
  label sets, every counter and every histogram ``_count`` equal the
  reference's (timing sums and buckets are not compared; the reference's
  ``kernel_qblock_rounded`` is the one metric left out), on the gathered
  backend with chunked prefill, on ``cuda_paged`` against ``pallas_paged``
  run interpreted (the compiler-params alias scoped by ``monkeypatch``),
  with monolithic prefill and two-pass n-gram speculation on gathered
  pages, and with prefix sharing plus n-gram speculation on the kernel
  backend.
* The reference's ``TestServingSpans`` invariants on the port's trace:
  every request retires once on its own track, spans nest, chunk spans
  cover each prompt, counters only grow across scrapes.
"""

import collections

import numpy as np
import pytest
from jax.experimental.pallas import tpu as pltpu

import repro.runtime.telemetry as jtel
from repro_torch.runtime import NULL_TELEMETRY, Telemetry, parse_prom
from repro_torch.runtime.telemetry import PID_ENGINE, PID_REQUEST
from tests.harness import assert_tokens_identical
from tests.test_prefix_share import prefix_requests
from tests.test_speculative import repetitive_requests
from tests.test_torch_serve_gathered import make_engines, oracle, port_serve
from tests.test_torch_telemetry import drop_qblock


@pytest.fixture
def interpreted(monkeypatch):
    """Let the JAX Pallas kernel run interpreted under jax 0.9."""
    monkeypatch.setattr(pltpu, "TPUCompilerParams", pltpu.CompilerParams,
                        raising=False)


# ---------------------------------------------------------------------------
# the served trace against the JAX Scheduler
# ---------------------------------------------------------------------------

_ENGINES = {}


def engines():
    if "minitron" not in _ENGINES:
        _ENGINES["minitron"] = make_engines("minitron-8b")
    return _ENGINES["minitron"]


def _cold(engine, tel):
    """Telemetry ``tel`` on the engine and its store, a cold tile cache and
    zeroed cache and prefetch counters, so both packages start equal."""
    engine.telemetry = engine.store.telemetry = tel
    engine.cache.clear()
    engine.cache.reset_counters()
    engine.store.prefetch_dispatched = engine.store.prefetch_used = 0


def _events(tel):
    return [e for e in tel.tracer.chrome()["traceEvents"] if e["ph"] != "M"]


def _request_args(events, backend_of):
    """Each request track's events in order, with their arguments (the
    backend's name mapped to the port's)."""
    out = collections.defaultdict(list)
    for e in events:
        if e["pid"] == PID_REQUEST:
            args = dict(e["args"])
            if "backend" in args:
                args["backend"] = backend_of(args["backend"])
            out[e["tid"]].append((e["ph"], e["name"], args))
    return dict(out)


def _prom(text, parse):
    types = {tuple(line.split()[2:4]) for line in text.splitlines()
             if line.startswith("# TYPE")}
    helps = {line for line in text.splitlines() if line.startswith("# HELP")}
    return parse(text), types, helps


def served_trace(jkw, kw, reqs=None, **both):
    """Serve ``reqs`` (MIXED by default) traced in both packages and the
    port once untraced -> (port engine, port tel, JAX tel, tokens)."""
    engine, jengine, mixed = engines()
    reqs = mixed if reqs is None else reqs
    _cold(engine, NULL_TELEMETRY)
    untraced, _ = port_serve(engine, reqs, **kw, **both)
    tel, jt = Telemetry(trace=True), jtel.Telemetry(trace=True)
    _cold(jengine, jt)
    want = oracle(jengine, reqs, **jkw, **both)
    _cold(engine, tel)
    got, _ = port_serve(engine, reqs, **kw, **both)
    assert_tokens_identical(got, untraced, "telemetry on vs off")
    assert_tokens_identical(got, want, "port vs JAX")

    evs, jevs = _events(tel), _events(jt)
    assert collections.Counter((e["pid"], e["tid"], e["name"])
                               for e in evs) == \
        collections.Counter((e["pid"], e["tid"], e["name"]) for e in jevs)
    meta = [e for e in tel.tracer.chrome()["traceEvents"] if e["ph"] == "M"]
    assert meta == [e for e in jt.tracer.chrome()["traceEvents"]
                    if e["ph"] == "M"]
    assert _request_args(evs, str) == _request_args(
        jevs, lambda b: b.replace("pallas_paged", "cuda_paged"))
    assert {p: h.n for p, h in tel.phases.items()} == \
        {p: h.n for p, h in jt.phases.items()}

    text = engine.render_prom()
    jtext = drop_qblock(jengine.render_prom())
    (got_s, got_t, got_h) = _prom(text, parse_prom)
    (want_s, want_t, want_h) = _prom(jtext, jtel.parse_prom)
    assert got_s.keys() == want_s.keys()
    assert (got_t, got_h) == (want_t, want_h)
    compared = [k for k in got_s
                if not k[0].endswith(("_bucket", "_sum", "_seconds_total"))]
    assert len(compared) > 40
    assert {k: got_s[k] for k in compared} == {k: want_s[k]
                                               for k in compared}
    engine.telemetry = engine.store.telemetry = NULL_TELEMETRY
    jengine.telemetry = jengine.store.telemetry = jtel.NULL_TELEMETRY
    return engine, tel, jt, got


class TestServedTraceParity:
    def test_gathered_chunked(self):
        kw = dict(attn_backend="gathered", kv_page_size=4, prefill_chunk=3)
        engine, tel, _, _ = served_trace(kw, kw)
        assert {"prefill", "decode", "kv_gather", "kv_scatter",
                "weights.materialize"} <= set(tel.phases)
        assert engine.metrics.prefill_chunks > 0

    def test_cuda_paged_against_pallas_paged(self, interpreted):
        kw = dict(kv_page_size=8, prefill_chunk=4)
        engine, tel, _, _ = served_trace(
            dict(attn_backend="pallas_paged", **kw),
            dict(attn_backend="cuda_paged", **kw))
        assert "mixed_step" in tel.phases and "decode" not in tel.phases
        assert engine.metrics.kv_gather_bytes == 0

    def test_monolithic_prefill_and_two_pass_speculation(self):
        """Gathered pages with monolithic prefill (the ``prefill`` request
        span) and n-gram drafts verified in two passes (``spec_draft``,
        ``spec_verify``, ``spec_rollback`` around the KV copies)."""
        engine, _, _ = engines()
        kw = dict(attn_backend="gathered", kv_page_size=4)
        engine, tel, _, _ = served_trace(
            kw, kw, reqs=repetitive_requests(engine, decode=12),
            speculate="ngram")
        assert {"spec_draft", "spec_verify", "spec_rollback", "kv_gather",
                "kv_scatter"} <= set(tel.phases)
        assert engine.metrics.spec_accepted_tokens > 0
        assert any(e["name"] == "prefill" and e["pid"] == PID_REQUEST
                   for e in tel.tracer.events)

    def test_prefix_share_and_ngram_on_the_kernel_backend(self,
                                                          interpreted):
        engine, jengine, mixed = engines()
        reqs = prefix_requests(jengine) + mixed
        kw = dict(kv_page_size=8, prefill_chunk=4)
        engine, tel, _, _ = served_trace(
            dict(attn_backend="pallas_paged", **kw),
            dict(attn_backend="cuda_paged", **kw), reqs=reqs,
            prefix_share=True, speculate="ngram")
        names = collections.Counter(e["name"] for e in tel.tracer.events)
        assert names["prefix_hit"] == engine.metrics.prefix_hits > 0
        assert names["spec_draft"] > 0


# ---------------------------------------------------------------------------
# the reference's serving-span invariants on the port
# ---------------------------------------------------------------------------

REQS = [(5, 4), (11, 2), (3, 5)]


def _serve(engine, reqs, **kw):
    from repro_torch.runtime import Scheduler
    sched = Scheduler(engine, batch_size=2, buckets=(16,), **kw)
    rids = [sched.submit(np.asarray(p), g).rid for p, g in reqs]
    done = {r.rid: r for r in sched.run()}
    assert len(done) == len(reqs)
    return rids, [tuple(done[rid].generated) for rid in rids]


@pytest.fixture(scope="module")
def reqs():
    rng = np.random.default_rng(5)
    return [(rng.integers(0, 128, L), g) for L, g in REQS]


def _engine(telemetry=None):
    from repro_torch.runtime import ServeEngine
    from tests.test_torch_harness import (jax_params, reduced_jax,
                                          reduced_torch, torch_params)
    tree = jax_params(reduced_jax("minitron-8b"), seed=0)
    return ServeEngine(reduced_torch("minitron-8b"), torch_params(tree),
                       device="cpu", telemetry=telemetry)


@pytest.fixture(scope="module")
def baseline(reqs):
    return _serve(_engine(), reqs, prefill_chunk=4, kv_page_size=8,
                  attn_backend="cuda_paged")[1]


@pytest.fixture(scope="module")
def traced(reqs):
    tel = Telemetry(trace=True)
    engine = _engine(telemetry=tel)
    rids, toks = _serve(engine, reqs, prefill_chunk=4, kv_page_size=8,
                        attn_backend="cuda_paged")
    return engine, tel, rids, toks


class TestServingSpans:
    def test_tokens_identical_with_telemetry(self, baseline, traced):
        assert traced[3] == baseline

    def test_every_request_retires_exactly_once(self, traced, reqs):
        _, tel, rids, _ = traced
        by_name: dict = {}
        for e in _events(tel):
            if e["pid"] == PID_REQUEST:
                by_name.setdefault(e["name"], []).append(e)
        for name in ("queued", "request", "admitted", "retired",
                     "first_token", "decode"):
            assert sorted(e["tid"] for e in by_name[name]) == sorted(rids)

    def test_spans_nest_and_timestamps_monotone(self, traced):
        _, tel, rids, _ = traced
        evs = _events(tel)
        eps = 1.0                                         # 1 us slack
        for rid in rids:
            track = [e for e in evs
                     if e["pid"] == PID_REQUEST and e["tid"] == rid]
            get = {e["name"]: e for e in track if e["ph"] == "X"}
            req, queued = get["request"], get["queued"]
            assert req["ts"] >= 0 and req["dur"] >= 0
            assert abs(queued["ts"] - req["ts"]) <= eps
            end = req["ts"] + req["dur"] + eps
            assert queued["ts"] + queued["dur"] <= end
            for e in track:
                assert req["ts"] - eps <= e["ts"] <= end
                if e["ph"] == "X":
                    assert e["ts"] + e["dur"] <= end
            assert get["decode"]["ts"] >= queued["ts"] + queued["dur"] - eps
            ends = [e["ts"] + e.get("dur", 0.0) for e in track]
            assert all(b >= a - eps for a, b in zip(ends, ends[1:]))

    def test_chunk_spans_cover_each_prompt(self, traced, reqs):
        _, tel, rids, _ = traced
        for rid, (prompt, _) in zip(rids, reqs):
            chunks = [e for e in tel.tracer.events
                      if e.get("tid") == rid and e["ph"] == "X"
                      and e["name"] == "prefill_chunk"]
            assert sum(e["args"]["tokens"] for e in chunks) == len(prompt)
            cursors = [e["args"]["cursor"] for e in chunks]
            assert cursors == sorted(cursors)

    def test_engine_phase_spans_present(self, traced):
        _, tel, _, _ = traced
        names = {e["name"] for e in tel.tracer.events
                 if e["pid"] == PID_ENGINE and e["ph"] == "X"}
        assert {"admit", "mixed_step", "weights.materialize"} <= names
        assert {"admit", "mixed_step"} <= set(tel.phases)

    def test_latency_histograms_filled(self, traced, reqs):
        engine, _, _, _ = traced
        m = engine.metrics
        assert m.ttft_hist.n == len(reqs)
        assert m.e2e_hist.n == len(reqs)
        assert m.tpot_hist.n == sum(1 for _, g in REQS if g > 1)
        assert m.chunk_hist.n == m.prefill_chunks
        assert m.step_hist.n == m.decode_steps

    def test_prometheus_parses_and_counters_monotone(self, traced, reqs):
        engine, _, _, _ = traced
        first = parse_prom(engine.render_prom())
        _serve(engine, reqs, prefill_chunk=4, kv_page_size=8,
               attn_backend="cuda_paged")
        second = parse_prom(engine.render_prom())
        monotone = [k for k in first
                    if k[0].endswith(("_total", "_count", "_bucket"))
                    or k[1].startswith("le=")]
        assert monotone
        for k in monotone:
            assert second[k] >= first[k], k
        fams = {k[0] for k in second}
        assert {"repro_tokens_generated_total", "repro_cache_hits_total",
                "repro_store_prefetch_dispatched_total"} <= fams
        assert any(f.startswith("repro_phase_") for f in fams)
        assert not any("kernel_qblock" in f for f in fams)

"""The port's tracer and telemetry facade against the JAX package, on the
CPU.

* Tracer: with the same injected timestamps, the Chrome JSON and the
  JSONL files are byte-identical.
* Null paths: ``NULL_TELEMETRY`` is one constant with one shared null
  context, and the telemetry module holds no device synchronisation.
* The weight store's phases: the port decodes a layer's missing tiles in
  one launch, so its ``weights.decode_tile`` span covers a launch and
  counts its tiles (``tiles``); their sum equals the reference's per-tile
  span count, and every other phase span and the cache and prefetch
  counters equal the reference's.
"""

import collections
import inspect
import json

import jax
import numpy as np
import pytest
import torch

import repro.runtime as jrt
import repro.runtime.telemetry as jtel
from repro.runtime import WeightStore as JaxWeightStore
from repro_torch.runtime import (NULL_TELEMETRY, DecodeTileCache, Telemetry,
                                 Tracer, WeightStore)
from repro_torch.runtime import telemetry as ptel
from repro_torch.runtime.telemetry import (NULL_TRACER, PID_ENGINE,
                                           PID_REQUEST, NullTelemetry)


# ---------------------------------------------------------------------------
# tracer
# ---------------------------------------------------------------------------

def _clock():
    t = iter(np.arange(100.0, 200.0, 0.0015625))
    return lambda: float(next(t))


def _script(tr):
    """The same events with injected timestamps (a fixed clock for
    ``span`` and for instants without a time)."""
    tr.t0 = 100.0
    tr.now = _clock()
    tr.name_track(PID_REQUEST, 3, "request 3")
    tr.name_track(PID_REQUEST, 0, "request 0")
    tr.complete(PID_REQUEST, 3, "queued", 100.25, 100.5, prompt_len=12)
    tr.instant(PID_REQUEST, 3, "admitted", 100.5, slot=1,
               backend="gathered")
    with tr.span(PID_ENGINE, 0, "mixed_step", k=1):
        tr.instant(PID_ENGINE, 0, "inside")
        with tr.span(PID_ENGINE, 0, "weights.materialize", model="lm"):
            pass
    tr.complete(PID_REQUEST, 0, "request", 100.0, 101.0 / 3 * 3,
                tokens=4, backend="cuda_paged")
    tr.complete(PID_ENGINE, 0, "backwards", 101.0, 100.5)   # dur clamps
    tr.instant(7, 2, "other process", 102.0)


class TestTracer:
    def test_chrome_and_jsonl_identical_to_the_reference(self, tmp_path):
        tr, jtr = Tracer(), jtel.Tracer()
        _script(tr)
        _script(jtr)
        assert tr.chrome() == jtr.chrome()
        assert json.dumps(tr.chrome()) == json.dumps(jtr.chrome())
        paths = {}
        for name, t in (("port", tr), ("jax", jtr)):
            paths[name] = (tmp_path / f"{name}.json",
                           tmp_path / f"{name}.jsonl")
            t.write_chrome(paths[name][0])
            t.write_jsonl(paths[name][1])
        for a, b in zip(paths["port"], paths["jax"]):
            assert a.read_bytes() == b.read_bytes()
        assert len(paths["port"][1].read_text().splitlines()) == \
            len(tr.events) == 8

    def test_span_and_instant_round_trip(self, tmp_path):
        tr = Tracer()
        tr.name_track(PID_REQUEST, 3, "request 3")
        with tr.span(PID_ENGINE, 0, "phase", k=1):
            tr.instant(PID_REQUEST, 3, "mark")
        obj = json.loads(json.dumps(tr.chrome()))
        evs = obj["traceEvents"]
        spans = [e for e in evs if e["ph"] == "X"]
        inst = [e for e in evs if e["ph"] == "i"]
        meta = [e for e in evs if e["ph"] == "M"]
        assert len(spans) == 1 and spans[0]["name"] == "phase"
        assert spans[0]["dur"] >= 0 and spans[0]["ts"] >= 0
        assert spans[0]["args"] == {"k": 1}
        assert len(inst) == 1 and inst[0]["s"] == "t"
        assert {(m["name"], m["pid"]) for m in meta} >= {
            ("process_name", PID_REQUEST), ("process_name", PID_ENGINE),
            ("thread_name", PID_REQUEST)}
        p = tmp_path / "trace.json"
        tr.write_chrome(p)
        assert json.loads(p.read_text())["traceEvents"]
        pl = tmp_path / "trace.jsonl"
        tr.write_jsonl(pl)
        assert all(json.loads(line) for line in pl.read_text().splitlines())

    def test_instant_inside_span_window(self):
        tr = Tracer()
        with tr.span(PID_ENGINE, 0, "outer"):
            tr.instant(PID_ENGINE, 0, "inside")
        span = next(e for e in tr.events if e["ph"] == "X")
        mark = next(e for e in tr.events if e["ph"] == "i")
        assert span["ts"] <= mark["ts"] <= span["ts"] + span["dur"]


class TestNullPaths:
    def test_null_telemetry_is_free_and_silent(self):
        tel = NULL_TELEMETRY
        assert isinstance(tel, NullTelemetry)
        assert tel.tracing is False and tel.tracer is NULL_TRACER
        ctx = tel.timed("anything", slot=1)
        assert tel.timed("other") is ctx       # one shared null context
        with ctx:
            pass
        assert tel.phases == {}
        assert NullTelemetry().timed("x") is ctx
        NULL_TRACER.complete(PID_ENGINE, 0, "x", 0.0, 1.0)
        NULL_TRACER.instant(PID_ENGINE, 0, "x")
        assert NULL_TRACER.span(PID_ENGINE, 0, "x") is ctx

    def test_untraced_telemetry_keeps_histograms_only(self):
        tel = Telemetry(trace=False)
        with tel.timed("work"):
            pass
        assert tel.tracing is False
        assert tel.phases["work"].n == 1

    def test_traced_telemetry_emits_engine_span(self):
        tel = Telemetry(trace=True)
        with tel.timed("work", detail=2):
            pass
        (ev,) = tel.tracer.events
        assert ev["name"] == "work" and ev["pid"] == PID_ENGINE
        assert ev["args"] == {"detail": 2}
        assert tel.phases["work"].n == 1

    def test_telemetry_adds_no_device_synchronisation(self, monkeypatch):
        """The module reads the host clock only: it imports nothing that
        could wait on a device, and a traced timing runs with every
        device wait made to raise."""
        src = inspect.getsource(ptel)
        for word in ("torch", "synchronize", ".item(", "cuda"):
            assert word not in src.replace("CUDA device", ""), word

        def boom(*a, **k):
            raise AssertionError("telemetry waited on the device")

        monkeypatch.setattr(torch.cuda, "synchronize", boom)
        monkeypatch.setattr(torch.Tensor, "item", boom)
        tel = Telemetry(trace=True)
        with tel.timed("work", x=torch.ones(2)):
            tel.tracer.instant(PID_REQUEST, 0, "mark", t=tel.tracer.now())
        assert tel.phases["work"].n == 1 and len(tel.tracer.events) == 2


@pytest.mark.parametrize("capacity", [None, 6 * 4096])
def test_decode_tile_spans_count_the_reference_tiles(capacity):
    """Two 15-tile MLP matrices, prefetch on, materialized three times:
    the port's ``weights.decode_tile`` spans (one a launch) carry as many
    tiles as the reference has spans (one a tile); the prefetch spans and
    every other phase count alike."""
    rng = np.random.default_rng(4)
    tree = {"mlp": {"up": rng.standard_normal((256, 512)).astype(np.float32),
                    "down": rng.standard_normal((512, 256)).astype(
                        np.float32)}}
    tel, jt = Telemetry(trace=True), jtel.Telemetry(trace=True)
    store = WeightStore(DecodeTileCache(capacity), prefetch=True,
                        telemetry=tel)
    jstore = JaxWeightStore(jrt.DecodeTileCache(capacity), prefetch=True,
                            telemetry=jt)
    store.register_model("m", jax.tree_util.tree_map(torch.from_numpy,
                                                     tree))
    jstore.register_model("m", tree)
    assert [l.tiled.n_tiles for s in store.layers("m").values()
            for l in s] == [15, 15]
    for _ in range(3):
        store.materialize("m")
        jstore.materialize("m")
    spans = [e for e in tel.tracer.events if e["name"] ==
             "weights.decode_tile"]
    jspans = [e for e in jt.tracer.events if e["name"] ==
              "weights.decode_tile"]
    assert sum(e["args"]["tiles"] for e in spans) == len(jspans) > 0
    assert len(spans) <= len(jspans)

    def others(events):
        return collections.Counter(
            (e["name"], tuple(sorted(e["args"].items())))
            for e in events if e["name"] != "weights.decode_tile")

    assert others(tel.tracer.events) == others(jt.tracer.events)
    assert (store.cache.hits, store.cache.misses, store.cache.evictions,
            store.prefetch_dispatched, store.prefetch_used) == \
        (jstore.cache.hits, jstore.cache.misses, jstore.cache.evictions,
         jstore.prefetch_dispatched, jstore.prefetch_used)

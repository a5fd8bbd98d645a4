"""The port's decode-cache autotuner against the JAX package where it
meets the stores, the scheduler and the launcher, on the CPU.

* ``sweep_store`` and ``recommend_store_capacity`` return the reference's
  tuples and dicts for the same params registered in both packages'
  stores (one tiny matrix whose tile clamps the low fractions, a
  multi-tile one, a scan-stacked pair), under each eviction policy.  The
  port reads the tiles cut at registration where the reference re-tiles
  the stream.
* Capacity changes speed only: the reduced minitron serves ``MIXED`` at
  the recommended capacity and below it (evicting) to the unbounded run's
  tokens, with the hit, miss, eviction and streamed-byte counters of the
  JAX ``Scheduler`` at the same capacity.
* The launcher: ``--cache-mb auto`` with ``--trace-out``, ``--trace-jsonl``
  and ``--metrics-out`` on the CPU prints the reference's lines, writes
  files that reload, and serves the tokens of the run without them.
"""

import json

import numpy as np
import pytest
import torch

import repro.runtime as jrt
from repro.runtime import autotune as jax_autotune
from repro_torch.launch import serve as serve_launch
from repro_torch.runtime import (DecodeTileCache, WeightStore, parse_prom,
                                 recommend_store_capacity, sweep_store)
from tests.harness import assert_tokens_identical
from tests.test_torch_serve_gathered import make_engines, oracle, port_serve


# the same params in both packages' stores
def _trees(kind):
    rng = np.random.default_rng(7)
    if kind == "tiny":
        return {"mlp": {"up": rng.standard_normal((4, 16)).astype(
            np.float32)}}
    if kind == "multi-tile":
        return {"mlp": {"up": rng.standard_normal((256, 512)).astype(
            np.float32), "down": rng.standard_normal((96, 64)).astype(
            np.float32)}}
    return {"blk": {"mlp": {"gate": rng.standard_normal((2, 64, 160)).astype(
        np.float32), "down": rng.standard_normal((2, 160, 64)).astype(
        np.float32)}}}


def _stores(kind):
    tree = _trees(kind)
    store = WeightStore(DecodeTileCache())
    store.register_model("m", _to_torch(tree))
    jstore = jrt.WeightStore(jrt.DecodeTileCache())
    jstore.register_model("m", tree)
    return store, jstore


def _to_torch(tree):
    return {k: _to_torch(v) if isinstance(v, dict)
            else torch.from_numpy(v) for k, v in tree.items()}


@pytest.mark.parametrize("policy", ["lru", "lfu", "freq"])
@pytest.mark.parametrize("kind", ["tiny", "multi-tile", "stacked"])
def test_sweep_and_recommendation_equal_the_reference(kind, policy):
    store, jstore = _stores(kind)
    assert store.decoded_bytes("m") == jstore.decoded_bytes("m")
    for kw in (dict(), dict(steps=3, fractions=(0.3, 0.6, 0.95, 1.0))):
        assert sweep_store(store, "m", policy=policy, **kw) == \
            jax_autotune.sweep_store(jstore, "m", policy=policy, **kw)
    for tol in (0.02, 0.3):
        assert recommend_store_capacity(store, "m", policy=policy,
                                        tolerance=tol) == \
            jax_autotune.recommend_store_capacity(jstore, "m", policy=policy,
                                                  tolerance=tol)


# ---------------------------------------------------------------------------
# serving at the recommended capacity against the JAX Scheduler
# ---------------------------------------------------------------------------

CACHE_COUNTERS = ("hits", "misses", "evictions", "bytes_streamed",
                  "bytes_avoided")


@pytest.fixture(scope="module")
def minitron():
    return make_engines("minitron-8b")


def _at_capacity(engine, capacity):
    engine.cache.clear()
    engine.cache.reset_counters()
    engine.cache.capacity_bytes = capacity


@pytest.mark.parametrize("backend", ["gathered", "cuda_paged"])
def test_recommended_capacity_serves_the_same_tokens(minitron, backend):
    engine, jengine, reqs = minitron
    rec = recommend_store_capacity(engine.store, engine.model_id)
    assert rec == jax_autotune.recommend_store_capacity(jengine.store,
                                                        jengine.model_id)
    # cuda_paged with monolithic prefill, held to the JAX gathered run:
    # the same ticks, so the same materialize calls
    kw = dict(kv_page_size=4, prefill_chunk=3) if backend == "gathered" \
        else dict(kv_page_size=4)
    _at_capacity(engine, None)
    unbounded, _ = port_serve(engine, reqs, attn_backend=backend, **kw)
    below = rec["capacities"][max(0, rec["capacities"].index(
        rec["capacity"]) - 1)]
    assert below < rec["capacity"]
    for cap in (rec["capacity"], below):
        _at_capacity(engine, cap)
        _at_capacity(jengine, cap)
        got, _ = port_serve(engine, reqs, attn_backend=backend, **kw)
        want = oracle(jengine, reqs, attn_backend="gathered", **kw)
        assert_tokens_identical(got, unbounded, f"capacity {cap}")
        assert_tokens_identical(got, want, f"capacity {cap} vs JAX")
        st, jst = engine.cache.stats(), jengine.cache.stats()
        assert {k: st[k] for k in CACHE_COUNTERS} == \
            {k: jst[k] for k in CACHE_COUNTERS}
        assert (st["evictions"] > 0) == (cap < rec["working_set"])
    _at_capacity(engine, None)
    _at_capacity(jengine, None)


# ---------------------------------------------------------------------------
# the launcher
# ---------------------------------------------------------------------------

BASE = ["--device", "cpu", "--scale", "tiny", "--arch", "minitron-8b",
        "--requests", "4", "--prompt-len", "12", "--gen", "3",
        "--kv-page-size", "8", "--prefill-chunk", "4",
        "--attn-backend", "cuda_paged"]


class TestLauncher:
    def test_cache_auto_and_telemetry_outputs(self, tmp_path, capsys):
        plain = serve_launch.main(BASE)
        capsys.readouterr()
        out = {k: tmp_path / f for k, f in (("trace", "t.json"),
                                            ("jsonl", "t.jsonl"),
                                            ("prom", "m.prom"))}
        done = serve_launch.main(BASE + [
            "--cache-mb", "auto", "--trace-out", str(out["trace"]),
            "--trace-jsonl", str(out["jsonl"]),
            "--metrics-out", str(out["prom"])])
        text = capsys.readouterr().out
        assert [r.generated for r in done] == [r.generated for r in plain]
        assert "cache autotune: working set" in text
        assert "recommended capacity" in text and "projected hit rate" in text
        assert f"(4 request spans) -> {out['trace']}" in text
        assert f"trace events (JSONL) -> {out['jsonl']}" in text
        assert f"text exposition -> {out['prom']}" in text
        events = json.loads(out["trace"].read_text())["traceEvents"]
        lines = [json.loads(line)
                 for line in out["jsonl"].read_text().splitlines()]
        assert [e for e in events if e["ph"] != "M"] == lines
        assert sum(e["name"] == "request" for e in lines) == 4
        prom = parse_prom(out["prom"].read_text())
        assert prom[("repro_requests_completed_total", "")] == 4
        assert prom[("repro_phase_mixed_step_seconds_count", "")] > 0

    def test_metrics_out_alone_records_histograms_without_a_trace(
            self, tmp_path, capsys):
        prom = tmp_path / "m.prom"
        serve_launch.main(BASE + ["--metrics-out", str(prom)])
        text = capsys.readouterr().out
        assert "trace:" not in text and "metrics:" in text
        samples = parse_prom(prom.read_text())
        assert samples[("repro_phase_admit_seconds_count", "")] > 0

    def test_cache_auto_needs_the_compressed_path(self):
        with pytest.raises(SystemExit, match="needs the compressed"):
            serve_launch.main(BASE + ["--cache-mb", "auto",
                                      "--no-compress"])

    def test_cache_mb_takes_a_number_or_auto(self, capsys):
        with pytest.raises(SystemExit):
            serve_launch.main(BASE + ["--cache-mb", "lots"])
        assert "'auto'" in capsys.readouterr().err

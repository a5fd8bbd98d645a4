"""The port's metrics registry and Prometheus export against the JAX
package, on the CPU.

With the same counters, gauges and histograms, both packages'
``MetricsRegistry.render()`` texts are byte-identical, and so are
``ServeMetrics.render_prom`` (the reference's ``kernel_qblock_rounded``
counter, a TPU ``q_block`` count, taken out) with the decode-cache and
weight-store rows; ``parse_prom`` gives equal dicts and rejects the same
malformed lines.  The tracer is held in ``test_torch_telemetry_trace.py``
and the served trace in ``test_torch_telemetry_serve.py``.
"""

import numpy as np
import pytest

import repro.runtime as jrt
import repro.runtime.telemetry as jtel
from repro.runtime import WeightStore as JaxWeightStore
from repro.runtime.metrics import ServeMetrics as JaxServeMetrics
from repro_torch.runtime import (DecodeTileCache, Histogram, MetricsRegistry,
                                 ServeMetrics, Telemetry, WeightStore,
                                 parse_prom)

QBLOCK = "repro_kernel_qblock_rounded_total"


def drop_qblock(text):
    """The reference's exposition without its ``kernel_qblock_rounded``
    counter (HELP, TYPE and sample lines)."""
    return "".join(line for line in text.splitlines(True)
                   if "kernel_qblock_rounded" not in line)


# ---------------------------------------------------------------------------
# registry
# ---------------------------------------------------------------------------

def _fill(reg_cls, hist_cls, values):
    reg = reg_cls()
    state = dict(values)
    reg.counter("things_total", lambda: state["c"], "things done")
    reg.gauge("fullness", lambda: state["g"])
    reg.gauge("ratio", lambda: state["r"], "a float gauge")
    h = hist_cls()
    for v in state["h"]:
        h.record(v)
    reg.histogram("lat_seconds", h, "latency")
    empty = hist_cls()
    reg.histogram("empty_seconds", lambda: empty)
    return reg


REGISTRY_VALUES = [
    dict(c=7, g=0.25, r=1 / 3, h=(1e-4, 1e-4, 0.01, 5.0)),
    dict(c=0, g=-2.0, r=1e20, h=()),
    dict(c=12345678901234, g=3.0, r=1e300,
         h=(1e-9, 0.037, 0.037, 500.0, 2.5e-6)),
]


class TestRegistry:
    @pytest.mark.parametrize("values", REGISTRY_VALUES,
                             ids=["floats", "empty", "extremes"])
    def test_render_is_byte_identical(self, values):
        got = _fill(MetricsRegistry, Histogram, values).render()
        want = _fill(jtel.MetricsRegistry, jtel.Histogram, values).render()
        assert got == want
        assert parse_prom(got) == jtel.parse_prom(want)

    def test_counter_gauge_round_trip(self):
        reg = MetricsRegistry()
        state = {"c": 7, "g": 0.25}
        reg.counter("things_total", lambda: state["c"], "things done")
        reg.gauge("fullness", lambda: state["g"])
        out = parse_prom(reg.render())
        assert out[("repro_things_total", "")] == 7
        assert out[("repro_fullness", "")] == 0.25
        state["c"] = 9                      # pull-based: re-render sees it
        assert parse_prom(reg.render())[("repro_things_total", "")] == 9

    def test_histogram_render_cumulative(self):
        reg = MetricsRegistry()
        h = Histogram()
        for v in (1e-4, 1e-4, 0.01, 5.0):
            h.record(v)
        reg.histogram("lat_seconds", h, "latency")
        out = parse_prom(reg.render())
        vals = [v for k, v in out.items()
                if k[0] == "repro_lat_seconds_bucket"]
        assert vals == sorted(vals)
        assert out[("repro_lat_seconds_bucket", 'le="+Inf"')] == 4
        assert out[("repro_lat_seconds_count", "")] == 4
        assert out[("repro_lat_seconds_sum", "")] == pytest.approx(h.total)

    @pytest.mark.parametrize("cls", [MetricsRegistry, jtel.MetricsRegistry],
                             ids=["port", "jax"])
    def test_rejects_bad_and_duplicate_names(self, cls):
        reg = cls()
        with pytest.raises(ValueError):
            reg.counter("bad name", lambda: 0)
        reg.counter("ok_total", lambda: 0)
        with pytest.raises(ValueError):
            reg.counter("ok_total", lambda: 0)

    @pytest.mark.parametrize("text", [
        "this is not prometheus\n", "metric_name not_a_number\n",
        "m{le=\"1\"} 1 2\n", "1metric 3\n", "ok 1\nbad line here\n",
        "m{unclosed 1\n"])
    def test_parse_prom_rejects_the_same_malformed_text(self, text):
        with pytest.raises(ValueError):
            parse_prom(text)
        with pytest.raises(ValueError):
            jtel.parse_prom(text)

    @pytest.mark.parametrize("text", [
        "# just a comment\n\n", "a 1\nb{x=\"y\"} 2.5\n  c 1e-3  \n",
        "a NaN\nb +Inf\n", ""])
    def test_parse_prom_equal_dicts(self, text):
        got, want = parse_prom(text), jtel.parse_prom(text)
        assert got.keys() == want.keys()
        assert all(got[k] == want[k] or (np.isnan(got[k])
                                         and np.isnan(want[k]))
                   for k in got)

    def test_sample_scalars_only(self):
        reg = MetricsRegistry()
        reg.counter("a_total", lambda: 3)
        reg.histogram("h_seconds", Histogram())
        assert reg.sample() == {"repro_a_total": 3.0}

    def test_serve_metrics_exposition_is_byte_identical(self):
        """The same record calls into both packages' ServeMetrics, caches
        and stores: the exposition texts are the same bytes once the
        reference's kernel_qblock_rounded rows are taken out."""
        m, jm = ServeMetrics(), JaxServeMetrics()
        cache, jcache = DecodeTileCache(100), jrt.DecodeTileCache(100)
        tel, jt = Telemetry(), jtel.Telemetry()
        for x in (m, jm):
            x.record_admit(2, 0.125, tokens=2)
            x.record_prefill_chunk(4, 0.01, stalled=True)
            x.record_pages(3, 10)
            x.record_kv_gather(64, 0)
            x.record_prefill_gather(0, 128)
            x.record_kv_codec(400, 110)
            x.record_prefix_hit(8, 2)
            x.record_prefix_cow()
            x.record_shared_pages(2)
            x.record_kv_codec_error(0.0125)
            x.record_decode_step(3, 0.02, n_slots=4)
            x.record_spec(4, 1)
            x.record_ttft(0.05)
            x.record_completed(1)
        for c in (cache, jcache):
            for key, nb in ((1, 40), (2, 40), (1, 40), (3, 40)):
                if c.get(key) is None:
                    c.put(key, "tile", nbytes=nb, streamed_bytes=7)
        tel.phases["weights.materialize"] = Histogram()
        jt.phases["weights.materialize"] = jtel.Histogram()
        tel.phases["mixed_step"] = Histogram()
        jt.phases["mixed_step"] = jtel.Histogram()
        for t in (tel, jt):
            t.phases["weights.materialize"].record(0.003)
            for v in (0.02, 0.5, 1e-7):
                t.phases["mixed_step"].record(v)
        store, jstore = WeightStore(cache), JaxWeightStore(jcache)
        store.prefetch_dispatched = jstore.prefetch_dispatched = 5
        store.prefetch_used = jstore.prefetch_used = 4
        got = m.render_prom(cache=cache, store=store, telemetry=tel)
        want = jm.render_prom(cache=jcache, store=jstore, telemetry=jt)
        assert QBLOCK in want and "kernel_qblock" not in got
        assert got == drop_qblock(want)
        assert cache.evictions == jcache.evictions > 0

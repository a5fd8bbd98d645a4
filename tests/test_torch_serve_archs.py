"""phi3-medium-14b, h2o-danube-1.8b, gemma2-2b and mixtral-8x22b served
on the gathered backend against the JAX ``Scheduler``, on the CPU, at the
reduced widths of
``tests/test_models.py::REDUCED`` (danube, gemma2's ``local`` layers and
mixtral with a window of 16, which the longer prompts outgrow, so their
lanes roll).

Every run serves ``tests/harness.py::MIXED`` with unit-scale MLP weights
(so the binarised products are exact in both packages) and must give the
JAX run's tokens exactly, on the same settings: monolithic prefill and
lanes; page 4 with chunks of 3; page 8 with chunks of 4 under
``kv_codec="cluster"``; and wave admission for danube and gemma2 (length
buckets 8 and 32 in both, so the waves are the same).  A
chunked run is held to the JAX run of the same chunking (a 1-token final
chunk takes the decode branch in both).  mixtral serves uncompressed (no
dense MLP) at the reduced capacity factor 8.
"""

import pytest

from tests.test_torch_serve_gathered import (assert_nothing_leaked,
                                             make_engines, oracle,
                                             port_serve)
from tests.harness import assert_tokens_identical

ARCHS = ("phi3-medium-14b", "h2o-danube-1.8b", "gemma2-2b", "mixtral-8x22b")
SETTINGS = {
    "monolithic": dict(),
    "page 4 chunk 3": dict(kv_page_size=4, prefill_chunk=3),
    "page 8 chunk 4 codec": dict(kv_page_size=8, prefill_chunk=4,
                                 kv_codec="cluster"),
    "wave": dict(mode="wave"),
}
CASES = [(a, s) for a in ARCHS for s in SETTINGS
         if s != "wave" or a in ("h2o-danube-1.8b", "gemma2-2b")]

_ENGINES = {}


def engines(arch):
    if arch not in _ENGINES:
        _ENGINES[arch] = make_engines(arch)
    return _ENGINES[arch]


@pytest.mark.parametrize("arch,setting", CASES)
def test_gathered_tokens_identical_to_the_reference(arch, setting):
    engine, jengine, reqs = engines(arch)
    kw = dict(attn_backend="gathered", buckets=(8, 32), **SETTINGS[setting])
    want = oracle(jengine, reqs, **kw)
    got, sched = port_serve(engine, reqs, **kw)
    assert_tokens_identical(got, want, f"{arch} {setting}")
    m, jm = engine.metrics, jengine.metrics
    assert (m.decode_steps, m.kv_gather_bytes, m.kv_prefill_gather_bytes,
            m.prefill_chunks, m.waves) == \
        (jm.decode_steps, jm.kv_gather_bytes, jm.kv_prefill_gather_bytes,
         jm.prefill_chunks, jm.waves)
    assert engine.compressed == (arch != "mixtral-8x22b")
    assert_nothing_leaked(sched._pool)

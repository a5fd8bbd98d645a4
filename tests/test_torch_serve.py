"""The port's serving stack against the JAX reference, on the CPU.

* ``WeightStore``: the same access sequence gives the same per-tile
  hit/miss/byte/eviction/prefetch counters, and materialised weights are
  bit-identical, under every eviction policy and a bounded cache.
* ``mixed_step``: logits of one ragged chunk block and of decode steps are
  allclose (1e-4) to the reference's monolithic prefill + ``decode_step``.
* ``Scheduler`` on ``cuda_paged`` (plain versions on the CPU) serves
  ``tests/harness.py::MIXED`` to tokens identical to the JAX Scheduler's
  default run — monolithic prefill over gathered lanes, the oracle that
  ``tests/test_mixed_step.py`` uses — at pages 4 and 8 and chunks 1, 3, 4
  and 7, including 1-token final chunks.
* Rolling-window lanes beside the pools under ``cuda_paged`` (a reduced
  minitron with ``swa`` blocks) give the JAX ``pallas_paged`` run's
  tokens, chunked and monolithic.
* The port's serve launcher runs at ``--scale tiny --device cpu``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import transformer as jtransformer
from repro.runtime import ServeEngine as JaxServeEngine
from repro.runtime.decode_cache import DecodeTileCache as JaxCache
from repro.runtime.weight_store import WeightStore as JaxWeightStore
from repro_torch.launch import serve as serve_launch
from repro_torch.models import transformer
from repro_torch.models.api import cache_layout, get_model
from repro_torch.models.layers import gelu_tanh
from repro_torch.runtime import Scheduler, ServeEngine, SlotPool
from repro_torch.runtime.decode_cache import DecodeTileCache
from repro_torch.runtime.weight_store import WeightStore
from tests.harness import MIXED, assert_tokens_identical, mixed_requests
from tests.harness import run_trace as jax_serve
from tests.test_torch_harness import (jax_params, jitted, reduced_jax,
                                      reduced_torch, torch_params,
                                      unit_scale_mlp)

# ---------------------------------------------------------------------------
# WeightStore parity
# ---------------------------------------------------------------------------


def _store_tree(rng):
    """Scan-stacked MLPs with several tiles each (8 + 9 per repeat)."""
    return {"scan": {"b0": {"mlp": {
        "up": rng.standard_normal((2, 144, 512)).astype(np.float32),
        "down": rng.standard_normal((2, 512, 144)).astype(np.float32)}}},
        "embed": rng.standard_normal((10, 4)).astype(np.float32)}


@pytest.mark.parametrize("policy,tiles", [("lru", None), ("lru", 20),
                                          ("lfu", 20), ("freq", 12),
                                          ("lru", 0)])
@pytest.mark.parametrize("prefetch", [False, True])
def test_weight_store_counters_and_weights_match(rng, policy, tiles,
                                                 prefetch):
    tree = _store_tree(rng)
    cap = None if tiles is None else tiles * 8 * 128 * 4
    jstore = JaxWeightStore(JaxCache(cap, policy=policy), prefetch=prefetch)
    store = WeightStore(DecodeTileCache(cap, policy=policy),
                        prefetch=prefetch)
    assert jstore.register_model("m", tree, cluster=True) == \
        store.register_model("m", torch_params(tree), cluster=True)
    for _ in range(3):
        jw = jstore.materialize("m")
        w = store.materialize("m")
        assert store.cache.stats() == jstore.cache.stats()
        assert (store.prefetch_dispatched, store.prefetch_used) == \
            (jstore.prefetch_dispatched, jstore.prefetch_used)
        assert store.cache.keys() == jstore.cache.keys()
        for name in ("up", "down"):
            np.testing.assert_array_equal(
                w["scan"]["b0"]["mlp"][name].numpy(),
                np.asarray(jw["scan"]["b0"]["mlp"][name]))
    assert store.cache.misses > 0
    assert store.n_tiles("m") == jstore.n_tiles("m") == 34
    assert store.decoded_bytes("m") == jstore.decoded_bytes("m")


def test_cached_tiles_own_their_storage(rng):
    """A tile decoded in a batched launch is cached with storage of its
    own, so the bytes the cache charges are the bytes eviction frees."""
    store = WeightStore(DecodeTileCache(5 * 8 * 128 * 4), prefetch=True)
    store.register_model("m", torch_params(_store_tree(rng)))
    store.materialize("m")
    assert store.cache.evictions > 0 and len(store.cache) == 5
    tiles = [e.value for e in store.cache._entries.values()]
    assert all(t.untyped_storage().nbytes() == t.nbytes == 8 * 128 * 4
               for t in tiles)
    assert store.cache.resident_bytes == sum(t.nbytes for t in tiles)


# ---------------------------------------------------------------------------
# mixed_step vs monolithic prefill + decode_step
# ---------------------------------------------------------------------------


def test_gelu_keeps_the_reference_sign_everywhere():
    """In a binarised MLP only the sign of gelu survives.  The reference's
    tanh saturates at |t| >= 7.9988, making gelu exactly 0 (binarised to
    +1) for inputs below about -4.8677; torch's own gelu stays negative
    down to about -5.06.  The port's gelu_tanh keeps the reference's
    boundary and its values."""
    x = np.linspace(-12, 12, 2_000_001).astype(np.float32)
    want = np.asarray(jax.nn.gelu(jnp.asarray(x), approximate=True))
    got = gelu_tanh(torch.from_numpy(x)).numpy()
    np.testing.assert_array_equal(got >= 0, want >= 0)
    np.testing.assert_allclose(got, want, atol=1e-6, rtol=1e-5)


def test_mixed_step_logits_match_prefill_and_decode():
    jcfg, cfg = reduced_jax("minitron-8b"), reduced_torch("minitron-8b")
    tree = jax_params(jcfg, seed=1)
    params = torch_params(tree)
    rng = np.random.default_rng(4)
    prompts = [rng.integers(0, 128, n) for n in (7, 3)]
    n_dec, page, pps = 3, 4, 4
    # reference: each request alone, monolithic prefill then decode steps
    want_prefill, want_dec, dec_toks = [], [], []
    jprefill = jitted(jtransformer.prefill, jcfg)
    jdecode = jitted(jtransformer.decode_step, jcfg)
    for p in prompts:
        cache = jtransformer.init_cache(jcfg, 1, page * pps)
        logits, cache = jprefill(tree, jnp.asarray(p[None]), cache)
        want_prefill.append(np.asarray(logits[0, -1]))
        toks, rows = [int(np.argmax(logits[0, -1]))], []
        for i in range(n_dec):
            logits, cache = jdecode(
                tree, cache, jnp.asarray([[toks[-1]]]),
                len(p) + i)
            rows.append(np.asarray(logits[0, -1]))
            toks.append(int(np.argmax(logits[0, -1])))
        want_dec.append(rows)
        dec_toks.append(toks)
    # port: both prompts as one ragged chunk block, then Q=1 decode blocks
    api = get_model(cfg)
    specs = api.init_cache_specs(cfg, 1, page * pps)
    _, len_axes = cache_layout(api, cfg, page * pps)
    axes = iter(len_axes)
    cache = transformer.tree_map(
        lambda s: torch.zeros((*s.shape[:next(axes) - 1], 2 * pps + 1, page,
                               *s.shape[-2:]), dtype=s.dtype), specs)
    table = torch.arange(1, 2 * pps + 1, dtype=torch.int32).reshape(2, pps)
    toks = torch.zeros((2, 7), dtype=torch.int32)
    for s, p in enumerate(prompts):
        toks[s, :len(p)] = torch.from_numpy(p.astype(np.int32))
    kw = dict(paged_flags=(True, True), page_size=page)
    q_lens = torch.tensor([7, 3], dtype=torch.int32)
    with torch.no_grad():
        logits, cache = transformer.mixed_step(
            cfg, params, cache, table, toks,
            torch.zeros(2, dtype=torch.int32), q_lens, **kw)
        for s in range(2):
            np.testing.assert_allclose(logits[s, q_lens[s] - 1].numpy(),
                                       want_prefill[s], atol=1e-4, rtol=1e-4)
        for i in range(n_dec):
            step_toks = torch.tensor([[t[i]] for t in dec_toks],
                                     dtype=torch.int32)
            poss = torch.tensor([len(p) + i for p in prompts],
                                dtype=torch.int32)
            logits, cache = transformer.mixed_step(
                cfg, params, cache, table, step_toks, poss,
                torch.ones(2, dtype=torch.int32), **kw)
            for s in range(2):
                np.testing.assert_allclose(logits[s, 0].numpy(),
                                           want_dec[s][i], atol=1e-4,
                                           rtol=1e-4)


# ---------------------------------------------------------------------------
# Scheduler token identity vs the JAX oracle
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def engines():
    """The same compressed minitron in both packages (unit-scale MLPs, so
    the binarised products are exact in both), and the JAX oracle's
    tokens on MIXED (monolithic prefill, gathered lanes)."""
    tree = unit_scale_mlp(jax_params(reduced_jax("minitron-8b"), seed=0))
    jengine = JaxServeEngine(reduced_jax("minitron-8b"), tree)
    engine = ServeEngine(reduced_torch("minitron-8b"), torch_params(tree),
                         device="cpu")
    reqs = mixed_requests(jengine, MIXED)
    return engine, reqs, jax_serve(jengine, reqs)


def port_serve(engine, reqs, **kw):
    kw.setdefault("batch_size", 2)
    sched = Scheduler(engine, attn_backend="cuda_paged", **kw)
    rids = {sched.submit(*r).rid: i for i, r in enumerate(reqs)}
    done = sched.run()
    assert len(done) == len(reqs)
    return {rids[r.rid]: tuple(r.generated) for r in done}, sched


@pytest.mark.parametrize("chunk", [1, 3, 4, 7])
@pytest.mark.parametrize("page", [4, 8])
def test_scheduler_tokens_identical_to_jax_oracle(engines, page, chunk):
    engine, reqs, want = engines
    got, _ = port_serve(engine, reqs, kv_page_size=page,
                        prefill_chunk=chunk)
    assert_tokens_identical(got, want, f"page {page} chunk {chunk}")


def test_mixed_path_copies_no_kv_and_leaks_no_pages(engines):
    engine, reqs, want = engines
    engine.metrics = type(engine.metrics)()
    got, sched = port_serve(engine, reqs, kv_page_size=4, prefill_chunk=3,
                            prefill_budget=8)
    assert_tokens_identical(got, want, "budget 8")
    m = engine.metrics
    assert m.kv_gather_bytes == 0 and m.kv_prefill_gather_bytes == 0
    assert m.kv_gather_bytes_avoided > 0
    assert m.kv_prefill_gather_bytes_avoided > 0
    assert "prefill gather" in engine.stats_line()
    pool = sched._pool
    assert pool.allocator.n_allocated == 0 and pool.allocator.reserved == 0
    assert (pool.table == 0).all()


@pytest.mark.parametrize("kw", [
    dict(prefix_share=True),
    dict(speculate="ngram"), dict(kernel_tune="auto")])
def test_unported_flags_are_refused(engines, kw):
    """The kernel autotuner is still refused; prefix sharing and
    speculation are ported (their parity tests: test_torch_prefix_share.py,
    test_torch_speculative.py) and build a scheduler that serves them."""
    args = dict(kv_page_size=4, prefill_chunk=3, attn_backend="cuda_paged")
    args.update(kw)
    if "kernel_tune" in kw:
        with pytest.raises(NotImplementedError):
            Scheduler(engines[0], **args)
        return
    sched = Scheduler(engines[0], **args)
    assert sched.prefix_share == kw.get("prefix_share", False)
    assert (sched.drafter is not None) == ("speculate" in kw)


@pytest.fixture(scope="module")
def swa_engines():
    """A reduced minitron whose blocks are ``swa`` with a window of 8, in
    both packages (unit-scale MLPs): at any slot length past 8 its K/V
    leaves are rolling lanes, not pages."""
    over = dict(scan_pattern=("swa",), window=8)
    tree = unit_scale_mlp(jax_params(reduced_jax("minitron-8b").scaled(
        **over), seed=0))
    jengine = JaxServeEngine(reduced_jax("minitron-8b").scaled(**over), tree)
    engine = ServeEngine(reduced_torch("minitron-8b").scaled(**over),
                         torch_params(tree), device="cpu")
    return engine, jengine, mixed_requests(jengine, MIXED)


@pytest.mark.parametrize("chunk", [3, None])
def test_lane_leaves_beside_pools_serve_like_the_reference(
        swa_engines, chunk, monkeypatch):
    """Under cuda_paged, rolling-window lanes beside the page pools (here
    every leaf a lane) serve, on the mixed path and on the monolithic
    install path alike, to the tokens of the JAX ``pallas_paged`` run of
    the same chunking (its kernel interpreted; the alias of the renamed
    compiler-params class is scoped to this test)."""
    from jax.experimental.pallas import tpu as pltpu
    monkeypatch.setattr(pltpu, "TPUCompilerParams", pltpu.CompilerParams,
                        raising=False)
    engine, jengine, reqs = swa_engines
    want = jax_serve(jengine, reqs, kv_page_size=4, prefill_chunk=chunk,
                     attn_backend="pallas_paged")
    got, sched = port_serve(engine, reqs, kv_page_size=4,
                            prefill_chunk=chunk)
    assert_tokens_identical(got, want, f"swa lanes chunk {chunk}")
    assert sched._pool.paged_flags == (False, False)
    assert SlotPool(engine, 2, 32, page_size=4,
                    backend="cuda_paged").kcache["scan"]["b0"]["k"].shape \
        == (2, 2, 8, 2, 16)


def test_cuda_device_without_a_card_raises():
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    cfg = reduced_torch("minitron-8b")
    with pytest.raises(RuntimeError, match="cuda"):
        transformer.init_params(cfg, torch.Generator(), "cuda")


def test_serve_launcher_tiny_cpu(capsys):
    done = serve_launch.main(["--arch", "minitron-8b", "--scale", "tiny",
                              "--device", "cpu", "--attn-backend",
                              "cuda_paged", "--batch", "2", "--requests", "3",
                              "--prompt-len", "20", "--gen", "5",
                              "--prefill-chunk", "8", "--kv-page-size", "4"])
    assert len(done) == 3 and all(len(r.generated) == 5 for r in done)
    out = capsys.readouterr().out
    for line in ("weight store:", "served 3 requests", "decode :",
                 "kv gather (cuda_paged backend): 0 bytes",
                 "cache hit-rate:", "sample token ids:"):
        assert line in out

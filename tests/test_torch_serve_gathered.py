"""The port's scheduler on the gathered backend, monolithic prefill,
unpaged lanes and wave mode, against the JAX ``Scheduler``, on the CPU.

Every run serves ``tests/harness.py::MIXED`` with unit-scale MLP weights
(so the binarised products are exact in both packages) and must give the
JAX run's tokens exactly:

* minitron, ``attn_backend="gathered"`` x ``kv_page_size`` None/4/8 x
  monolithic or chunks of 3/4, against the JAX gathered run of the same
  configuration (a 1-token final chunk takes the decode branch there, and
  here), with the decode and install copy counters equal to the JAX
  run's;
* ``cuda_paged`` with monolithic prefill (install into the pages, then
  Q=1 mixed steps), against the JAX monolithic oracle, install bytes
  counted as copied;
* ``mode="wave"`` on both backends, same waves as the reference;
* ``kv_codec="cluster"`` on the gathered backend (decode at gather,
  re-encode at scatter) and on monolithic ``cuda_paged``, against the
  JAX gathered codec path;
* reduced deepseek (MLA + MoE) on gathered and on monolithic
  ``cuda_paged`` at capacity factor 8, and on gathered against the same
  prefill shape at the published 1.25, where tokens are dropped.

One decode step's logits after monolithic prefills agree across the
three layouts, and a kernel page shifted by one row breaks that.

Pool invariants: no page is leaked after retire, the page tables stay
disjoint at every step, a poisoned page 0 changes nothing,
``grow_pages`` keeps every buffer's ``data_ptr()`` within capacity, and
the page-copy helper copies codes and scales in both layouts.
"""

import jax
import numpy as np
import pytest
import torch

from repro.runtime import ServeEngine as JaxServeEngine
from repro.runtime.metrics import ServeMetrics as JaxServeMetrics
from repro.runtime.scheduler import SlotPool as JaxSlotPool
from repro_torch.runtime import (Request, Scheduler, ServeEngine,
                                 ServeMetrics, SlotPool)
from repro_torch.tree import tree_leaves
from tests.harness import MIXED, assert_tokens_identical, mixed_requests
from tests.harness import run_trace as jax_serve
from tests.test_torch_harness import (jax_params, reduced_jax, reduced_torch,
                                      torch_params, unit_scale_mlp)


def make_engines(arch, **over):
    tree = unit_scale_mlp(jax_params(reduced_jax(arch).scaled(**over),
                                     seed=0))
    jengine = JaxServeEngine(reduced_jax(arch).scaled(**over), tree)
    engine = ServeEngine(reduced_torch(arch).scaled(**over),
                         torch_params(tree), device="cpu")
    return engine, jengine, mixed_requests(jengine, MIXED)


@pytest.fixture(scope="module")
def minitron():
    return make_engines("minitron-8b")


@pytest.fixture(scope="module")
def deepseek():
    return make_engines("deepseek-v2-236b")


def port_serve(engine, reqs, **kw):
    engine.metrics = ServeMetrics()
    kw.setdefault("batch_size", 2)
    sched = Scheduler(engine, **kw)
    rids = {sched.submit(*r).rid: i for i, r in enumerate(reqs)}
    done = sched.run()
    assert len(done) == len(reqs)
    return {rids[r.rid]: tuple(r.generated) for r in done}, sched


def oracle(jengine, reqs, **kw):
    jengine.metrics = JaxServeMetrics()
    return jax_serve(jengine, reqs, **kw)


_MONOLITHIC = {}


def monolithic_oracle(jengine, reqs):
    """The JAX default path's tokens (gathered, monolithic prefill and
    lanes), served once per engine: the reference runs its monolithic
    prefill op by op, which takes tens of seconds for deepseek."""
    if id(jengine) not in _MONOLITHIC:
        _MONOLITHIC[id(jengine)] = oracle(jengine, reqs)
    return _MONOLITHIC[id(jengine)]


def assert_nothing_leaked(pool):
    if pool.paged:
        assert pool.allocator.n_allocated == 0
        assert pool.allocator.reserved == 0 and (pool.table == 0).all()
    assert not pool.busy()


@pytest.mark.parametrize("chunk", [None, 3, 4])
@pytest.mark.parametrize("page", [None, 4, 8])
def test_gathered_tokens_and_copies_match_the_reference(minitron, page,
                                                        chunk):
    engine, jengine, reqs = minitron
    kw = dict(attn_backend="gathered", kv_page_size=page,
              prefill_chunk=chunk)
    want = oracle(jengine, reqs, **kw)
    got, sched = port_serve(engine, reqs, **kw)
    assert_tokens_identical(got, want, f"page {page} chunk {chunk}")
    m, jm = engine.metrics, jengine.metrics
    assert (m.decode_steps, m.kv_gather_bytes, m.kv_prefill_gather_bytes,
            m.prefill_chunks, m.pages_total) == \
        (jm.decode_steps, jm.kv_gather_bytes, jm.kv_prefill_gather_bytes,
         jm.prefill_chunks, jm.pages_total)
    assert m.kv_prefill_gather_bytes == \
        len(reqs) * sched._pool.install_bytes > 0
    assert (m.kv_gather_bytes > 0) == (page is not None)
    assert_nothing_leaked(sched._pool)


@pytest.mark.parametrize("page", [4, 8])
def test_cuda_paged_monolithic_installs_then_decodes_on_the_kernel_path(
        minitron, page):
    """Monolithic admission prefills a batch-1 cache, installs it into the
    slot's pages (counted as copied), then decodes through Q=1 mixed
    steps over the pools (copying nothing a step)."""
    engine, jengine, reqs = minitron
    want = monolithic_oracle(jengine, reqs)
    got, sched = port_serve(engine, reqs, attn_backend="cuda_paged",
                            kv_page_size=page)
    assert_tokens_identical(got, want, f"cuda_paged monolithic page {page}")
    m, pool = engine.metrics, sched._pool
    assert m.kv_prefill_gather_bytes == len(reqs) * pool.install_bytes
    assert m.kv_prefill_gather_bytes_avoided == 0
    assert m.kv_gather_bytes == 0
    assert m.kv_gather_bytes_avoided == \
        m.decode_steps * pool.gather_bytes_avoided_per_step > 0
    assert_nothing_leaked(pool)


@pytest.mark.parametrize("kw", [
    dict(attn_backend="gathered"),
    dict(attn_backend="gathered", kv_page_size=4, prefill_chunk=3),
    dict(attn_backend="cuda_paged", kv_page_size=4),
    dict(attn_backend="cuda_paged", kv_page_size=8, prefill_chunk=4)])
def test_wave_mode_tokens_and_waves_match_the_reference(minitron, kw):
    """Drain-then-admit rounds of one length bucket; the in-kernel
    backend against the gathered oracle with the same prefill."""
    engine, jengine, reqs = minitron
    jkw = dict(kw, attn_backend="gathered")
    want = oracle(jengine, reqs, mode="wave", buckets=(8, 32), **jkw)
    got, sched = port_serve(engine, reqs, mode="wave", buckets=(8, 32),
                            **kw)
    assert_tokens_identical(got, want, f"wave {kw}")
    assert engine.metrics.waves == jengine.metrics.waves > 1
    assert_nothing_leaked(sched._pool)


@pytest.mark.parametrize("backend,page,chunk", [
    ("gathered", 4, None), ("gathered", 8, None), ("gathered", 4, 3),
    ("gathered", 8, 4), ("cuda_paged", 4, None), ("cuda_paged", 8, None)])
def test_codec_tokens_match_the_reference_gathered_codec_path(
        minitron, backend, page, chunk):
    engine, jengine, reqs = minitron
    want = oracle(jengine, reqs, attn_backend="gathered", kv_codec="cluster",
                  kv_page_size=page, prefill_chunk=chunk)
    got, sched = port_serve(engine, reqs, attn_backend=backend,
                            kv_codec="cluster", kv_page_size=page,
                            prefill_chunk=chunk)
    assert_tokens_identical(got, want, f"codec {backend} page {page} "
                                       f"chunk {chunk}")
    pool, m = sched._pool, engine.metrics
    assert {c.dtype for c in pool.code_pools()} == {torch.int8}
    if backend == "gathered":
        assert [tuple(s.shape) for s in pool.page_scales] == \
            [tuple(c.shape[:-2]) for c in pool.pages]
        assert m.kv_gather_bytes == jengine.metrics.kv_gather_bytes
    assert m.kv_capacity_multiplier() == pytest.approx(
        pool.page_bytes_fp / pool.page_bytes_resident)
    assert_nothing_leaked(pool)


@pytest.mark.parametrize("kw", [
    dict(attn_backend="gathered"),
    dict(attn_backend="gathered", kv_page_size=4, prefill_chunk=3),
    dict(attn_backend="gathered", kv_page_size=8, kv_codec="cluster"),
    dict(attn_backend="cuda_paged", kv_page_size=4),
    dict(attn_backend="cuda_paged", kv_page_size=4, kv_codec="cluster")])
def test_deepseek_tokens_match_the_reference(deepseek, kw):
    """MLA + MoE at capacity factor 8 (no drops): the gathered oracle of
    the same configuration; monolithic cuda_paged against the gathered
    monolithic run."""
    engine, jengine, reqs = deepseek
    want = oracle(jengine, reqs, **dict(kw, attn_backend="gathered")) \
        if kw.get("prefill_chunk") or kw.get("kv_codec") else \
        monolithic_oracle(jengine, reqs)
    got, sched = port_serve(engine, reqs, **kw)
    assert_tokens_identical(got, want, f"deepseek {kw}")
    assert_nothing_leaked(sched._pool)


@pytest.mark.parametrize("kw", [dict(), dict(kv_page_size=4,
                                             prefill_chunk=3)])
def test_deepseek_drops_match_on_the_same_prefill_shape(kw):
    """At the published capacity factor 1.25 tokens are dropped, per row
    of a block: the same prefill shape and the per-slot decode drop the
    same ones in both packages."""
    engine, jengine, reqs = make_engines("deepseek-v2-236b",
                                         capacity_factor=1.25)
    want = oracle(jengine, reqs, attn_backend="gathered", **kw)
    got, _ = port_serve(engine, reqs, attn_backend="gathered", **kw)
    assert_tokens_identical(got, want, f"deepseek cf 1.25 {kw}")


@pytest.mark.parametrize("kw", [
    dict(attn_backend="gathered", kv_page_size=4),
    dict(attn_backend="gathered", kv_page_size=4, prefill_chunk=3,
         kv_codec="cluster"),
    dict(attn_backend="cuda_paged", kv_page_size=4)])
def test_page_tables_stay_disjoint_and_page_zero_is_inert(minitron, kw,
                                                          monkeypatch):
    """Every decode step sees disjoint table rows (page 0 aside), with
    page 0 poisoned before the run; the tokens stay the oracle's."""
    engine, jengine, reqs = minitron
    want = oracle(jengine, reqs, **dict(kw, attn_backend="gathered"))
    steps = []
    decode = SlotPool.decode

    def poison(pool):
        if pool.backend == "cuda_paged":
            for p, ax in zip(tree_leaves(pool.kcache), pool._paged_axis):
                p[(slice(None),) * (ax - 1) + (0,)] = \
                    100 if pool.codec else 1e4
        else:
            for p in pool.pages:
                p[0] = 100 if pool.codec else 1e4
            for s in pool.page_scales:
                s[0] = 50.0

    def checked(pool, params):
        live = pool.table[pool.table != 0]
        assert len(live) == len(set(live.tolist()))
        for s in pool.active():       # every written position is backed
            assert (pool.table[s.index, :(s.pos - 1) // pool.page_size + 1]
                    != 0).all()
        if not steps:
            poison(pool)
        steps.append(1)
        return decode(pool, params)

    monkeypatch.setattr(SlotPool, "decode", checked)
    got, sched = port_serve(engine, reqs, **kw)
    assert steps and got == want
    assert_nothing_leaked(sched._pool)


@pytest.mark.parametrize("backend,codec", [("gathered", "none"),
                                           ("gathered", "cluster"),
                                           ("cuda_paged", "none"),
                                           ("cuda_paged", "cluster")])
def test_grow_pages_reallocates_only_past_capacity(minitron, backend, codec):
    engine = minitron[0]
    pool = SlotPool(engine, 2, 16, page_size=4, n_pages=5, page_capacity=9,
                    backend=backend, kv_codec=codec)

    def buffers():
        if backend == "cuda_paged":
            return tree_leaves(pool.kcache) + (
                tree_leaves(pool.kscales) if pool.codec else [])
        return pool.pages + pool.page_scales

    ptrs = [b.data_ptr() for b in buffers()]
    for b in buffers():
        b.fill_(3)
    pool.grow_pages(9)
    assert [b.data_ptr() for b in buffers()] == ptrs
    assert (pool.n_pages, pool.page_capacity, pool.allocator.total) == \
        (9, 9, 8)
    pool.grow_pages(12)
    assert pool.page_capacity == 18 and pool.allocator.total == 11
    assert all(p != q for p, q in zip(ptrs, (b.data_ptr()
                                             for b in buffers())))
    axes = pool._paged_axis * 2 if backend == "cuda_paged" else \
        [1] * len(buffers())
    for b, ax in zip(buffers(), axes):
        assert b.shape[ax - 1] == 18
        old = b.narrow(ax - 1, 0, 9)
        assert bool((old == 3).all()) and \
            bool((b.narrow(ax - 1, 9, 9) == 0).all())


@pytest.mark.parametrize("backend", ["gathered", "cuda_paged"])
def test_copy_page_copies_codes_and_scales(minitron, backend):
    pool = SlotPool(minitron[0], 2, 16, page_size=4, backend=backend,
                    kv_codec="cluster")
    pools = tree_leaves(pool.kcache) + tree_leaves(pool.kscales) \
        if backend == "cuda_paged" else pool.pages + pool.page_scales
    axes = pool._paged_axis * 2 if backend == "cuda_paged" else \
        [1] * len(pools)
    gen = torch.Generator().manual_seed(0)
    for p in pools:
        p.copy_(torch.randint(-100, 100, p.shape, generator=gen))
    pool._copy_page(3, 5)
    for p, ax in zip(pools, axes):
        assert torch.equal(p.select(ax - 1, 5), p.select(ax - 1, 3))
        assert not torch.equal(p.select(ax - 1, 6), p.select(ax - 1, 3))


@pytest.mark.parametrize("page", [4, 8])
@pytest.mark.parametrize("arch", ["minitron-8b", "deepseek-v2-236b"])
def test_gather_and_install_bytes_are_the_reference_formula(
        minitron, deepseek, arch, page):
    engine, jengine, _ = minitron if arch == "minitron-8b" else deepseek
    jpool = JaxSlotPool(jengine, 2, 32, page_size=page, backend="gathered")
    for backend in ("gathered", "cuda_paged"):
        pool = SlotPool(engine, 2, 32, page_size=page, backend=backend)
        want = (jpool.gather_bytes_per_step, 0) if backend == "gathered" \
            else (0, jpool.gather_bytes_per_step)
        assert (pool.gather_bytes_per_step,
                pool.gather_bytes_avoided_per_step) == want
        assert pool.install_bytes == jpool.install_bytes
    mono = SlotPool(engine, 2, 32, backend="gathered")
    jmono = JaxSlotPool(jengine, 2, 32, backend="gathered")
    assert (mono.install_bytes, mono.gather_bytes_per_step) == \
        (jmono.install_bytes, 0)
    assert [tuple(c.shape) for c in tree_leaves(mono.cache)] == \
        [tuple(c.shape) for c in
         jax.tree_util.tree_leaves(jmono.cache)]


@pytest.mark.parametrize("kw,err", [
    (dict(attn_backend="cuda_paged", kv_page_size=None), ValueError),
    (dict(attn_backend="gathered", kv_codec="cluster"), ValueError),
    (dict(attn_backend="paged"), ValueError),
    (dict(mode="batch", attn_backend="gathered"), ValueError)])
def test_bad_combinations_are_refused_as_the_reference_does(minitron, kw,
                                                            err):
    with pytest.raises(err):
        Scheduler(minitron[0], **kw)


@pytest.mark.parametrize("arch", ["minitron-8b", "deepseek-v2-236b"])
def test_first_decode_logits_agree_across_layouts(minitron, deepseek, arch):
    """Two requests prefilled monolithically and installed into a pool of
    each layout: one decode step's logits agree bit for bit between
    monolithic lanes and gathered pages (the gather is an exact copy) and
    within 1e-5 on ``cuda_paged`` (the kernel's plain version here); the
    first page of slot 0 shifted by one row in the kernel's pools (row 0
    repeated, the page's last key lost) moves them past 1e-3."""
    engine = (minitron if arch == "minitron-8b" else deepseek)[0]
    params = engine.step_params()
    rng = np.random.default_rng(0)
    reqs = [Request(i, rng.integers(0, engine.cfg.vocab_size, n,
                                    dtype=np.int32), 4)
            for i, n in enumerate((9, 5))]
    firsts = [(r, *engine.prefill_request(params, r.prompt, 16))
              for r in reqs]
    engine.metrics = ServeMetrics()

    def logits(fault=False, **kw):
        pool = SlotPool(engine, 2, 16, **kw)
        for slot, (req, tok, cache1) in zip(pool.slots, firsts):
            slot.req = req
            assert pool.reserve_for(slot, req)
            pool.install(slot, cache1, tok)
        if fault:
            page = int(pool.table[0, 0])
            for leaf, ax in zip(tree_leaves(pool.kcache), pool._paged_axis):
                rows = leaf.select(ax - 1, page).movedim(ax - 1, 0)
                rows[1:] = rows[:-1].clone()
        return pool.decode_logits(params)

    gathered = logits(backend="gathered", page_size=4)
    assert torch.equal(logits(backend="gathered"), gathered)
    kernel = logits(backend="cuda_paged", page_size=4)
    np.testing.assert_allclose(kernel.numpy(), gathered.numpy(), atol=1e-5,
                               rtol=0)
    shifted = logits(backend="cuda_paged", page_size=4, fault=True)
    assert float((shifted - gathered).abs().max()) > 1e-3


def test_serve_launcher_rejects_a_page_size_below_one():
    from repro_torch.launch import serve as serve_launch
    with pytest.raises(SystemExit):
        serve_launch.main(["--scale", "tiny", "--device", "cpu",
                           "--attn-backend", "gathered",
                           "--kv-page-size", "0"])


def test_serve_launcher_gathered_monolithic_and_wave(capsys):
    from repro_torch.launch import serve as serve_launch
    done = serve_launch.main(["--scale", "tiny", "--device", "cpu",
                              "--attn-backend", "gathered", "--mode", "wave",
                              "--batch", "2", "--requests", "3",
                              "--prompt-len", "20", "--gen", "4"])
    assert len(done) == 3 and all(len(r.generated) == 4 for r in done)
    out = capsys.readouterr().out
    assert "served 3 requests" in out and "(wave slots" in out
    assert "chunked prefill" not in out and "kv pages" not in out


def test_engine_step_entry_points_match_the_reference(minitron):
    """``prefill_request`` then the shared-position ``decode_step`` and
    the per-slot ``slot_decode``, against the JAX engine's."""
    engine, jengine, reqs = minitron
    prompt = reqs[2][0]
    tok, cache = engine.prefill_request(engine.step_params(), prompt, 32)
    jtok, jcache = jengine.prefill_request(jengine.step_params(), prompt, 32)
    assert tok == jtok
    logits, cache = engine.decode_step(engine.step_params(), cache,
                                       np.array([[tok]]), len(prompt))
    jlogits, _ = jengine.decode_step(jengine.step_params(), jcache,
                                     np.array([[tok]], np.int32),
                                     len(prompt))
    np.testing.assert_allclose(logits.numpy(), np.asarray(jlogits),
                               atol=1e-4, rtol=1e-4)
    # two slots holding the prefilled lane, decoding different tokens
    pooled = jax.tree_util.tree_map(lambda a: np.stack([np.asarray(a)] * 2),
                                    jcache)
    toks = np.array([[[5]], [[9]]], np.int32)
    poss = np.array([len(prompt), len(prompt) - 2], np.int32)
    jl, _ = jengine.slot_decode(jengine.step_params(),
                                jax.tree_util.tree_map(jax.numpy.asarray,
                                                       pooled), toks, poss)
    tl, _ = engine.slot_decode(engine.step_params(), torch_params(pooled),
                               toks, poss)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=1e-4,
                               rtol=1e-4)


@pytest.fixture(scope="module")
def swa():
    """minitron's reduced widths with an ``attn`` and an ``swa`` block of
    window 8: at the slot lengths MIXED needs, the swa block's K/V are
    rolling lanes beside the attn block's pages."""
    return make_engines("minitron-8b", scan_pattern=("attn", "swa"),
                        scan_repeats=1, window=8)


@pytest.mark.parametrize("kw", [
    dict(), dict(kv_page_size=4), dict(kv_page_size=4, prefill_chunk=3),
    dict(kv_page_size=8, prefill_chunk=4, kv_codec="cluster")])
def test_rolling_lanes_on_the_gathered_backend(swa, kw):
    """Rolling-window lanes ride beside the page pools on the gathered
    backend: prompts longer than the window roll at prefill, chunks write
    after attending, and the codec leaves the lanes raw; tokens are the
    JAX run's."""
    engine, jengine, reqs = swa
    want = oracle(jengine, reqs, attn_backend="gathered", **kw)
    got, sched = port_serve(engine, reqs, attn_backend="gathered", **kw)
    assert_tokens_identical(got, want, f"swa {kw}")
    pool = sched._pool
    if pool.paged:
        assert pool.paged_flags == (True, True, False, False)
        assert [tuple(u.shape) for u in pool.unpaged] == \
            [(2, 1, 1, 8, 2, 16)] * 2
    assert_nothing_leaked(pool)

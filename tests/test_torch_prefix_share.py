"""Prefix sharing in the port against the JAX package, on the CPU.

* The refcounted ``PageAllocator``: the lifecycle and raises of the
  reference's tests, run on both packages side by side, and seeded churn
  traces (alloc groups, extra shares, releases) driven through both with
  every return value and refcount equal step for step.
* ``PrefixIndex``: seeded register / lookup / evict / clear traces through
  both packages' index over both packages' allocator, lookups (matched
  tokens and node pages), node counts and allocator state equal step for
  step.
* Serving the reference's prefix trace (four prompts extending one
  16-token prefix, one diverging mid-prefix, two unrelated) and
  ``tests/harness.py::MIXED`` with unit-scale MLP weights, against the
  JAX ``Scheduler``: gathered x page 4/8 x chunk 3/4 x codec none/cluster,
  and ``cuda_paged`` against the JAX ``pallas_paged`` run with its kernel
  interpreted (the compiler-params alias is scoped by ``monkeypatch``).
  The counters ``prefix_hits``, ``prefix_tokens_reused``,
  ``prefill_chunks_avoided``, ``prefix_cow_copies``, ``prefix_evictions``
  and the shared-page gauge equal the JAX run's.  Tokens equal the JAX
  sharing-off run's everywhere (sharing is token-identical by contract),
  and the JAX sharing-on run's wherever that equals its own sharing-off
  run: on the gathered backend at page 4 / chunk 3 the reference's decode
  scatters a prefilling slot's lane back into the prefix pages it maps,
  and its sharing-on tokens change (ROADMAP, reference caveats); the
  port's gathered decode scatters active slots' rows only.
* Retire and readmit on a warm scheduler, the drain leaving only the
  index's references, copy-on-write never leaving a written page shared,
  the stats line, and the windowed arch's downgrade with its warning and
  note.  Stated tolerance: tokens and counters identical.
"""

import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from repro.runtime import PageAllocator as JaxPageAllocator
from repro.runtime import PrefixIndex as JaxPrefixIndex
from repro.runtime import Scheduler as JaxScheduler
from repro.runtime import scheduler as jax_sched_mod
from repro_torch.runtime import PageAllocator, Scheduler, SlotPool
from repro_torch.runtime import scheduler as sched_mod
from repro_torch.runtime.prefix_index import PrefixIndex
from repro_torch.tree import tree_leaves
from tests.harness import assert_tokens_identical
from tests.test_prefix_share import prefix_requests
from tests.test_torch_serve_gathered import (make_engines, oracle,
                                             port_serve)

COUNTERS = ("prefix_hits", "prefix_tokens_reused", "prefill_chunks_avoided",
            "prefix_cow_copies", "prefix_evictions", "shared_page_steps",
            "prefill_chunk_tokens", "decode_steps")

_ENGINES = {}


def engines(arch="minitron-8b"):
    if arch not in _ENGINES:
        _ENGINES[arch] = make_engines(arch)
    return _ENGINES[arch]


def trace(jengine):
    """The reference's prefix trace, then MIXED."""
    return prefix_requests(jengine) + engines()[2]


def counters(m):
    return {k: getattr(m, k) for k in COUNTERS}


@pytest.fixture
def interpreted(monkeypatch):
    """Let the JAX Pallas kernel run interpreted under jax 0.9."""
    monkeypatch.setattr(pltpu, "TPUCompilerParams", pltpu.CompilerParams,
                        raising=False)


# ---------------------------------------------------------------------------
# the refcounted allocator
# ---------------------------------------------------------------------------

def _state(a):
    return (a.n_free, a.n_allocated, a.reserved, a.shared_pages(),
            sorted(a._allocated), dict(sorted(a._refs.items())))


@pytest.mark.parametrize("cls", [PageAllocator, JaxPageAllocator],
                         ids=["port", "jax"])
def test_refcount_lifecycle_and_raises(cls):
    """The reference's unit checks, on either package's allocator."""
    a = cls(range(1, 5))
    assert a.reserve(1)
    pid = a.alloc()
    assert a.refcount(pid) == 1 and a.shared_pages() == 0
    assert a.share(pid) == pid
    assert a.refcount(pid) == 2 and a.shared_pages() == 1
    free, reserved = a.n_free, a.reserved
    a.share(pid)
    assert (a.n_free, a.reserved) == (free, reserved)
    a.release([pid, pid])
    assert a.refcount(pid) == 1 and a.n_allocated == 1
    a.release([pid])
    assert a.refcount(pid) == 0 and a.n_allocated == 0
    assert a.n_free == a.total
    with pytest.raises(ValueError, match="unallocated"):
        a.share(pid)
    with pytest.raises(ValueError, match="unallocated"):
        a.share(3)
    n_free = a.n_free
    with pytest.raises(ValueError, match="double free"):
        a.release([pid])
    with pytest.raises(ValueError, match="double free"):
        a.release([99])
    assert a.n_free == n_free


@pytest.mark.parametrize("seed", range(24))
def test_allocator_churn_equal_step_for_step(seed):
    """One seeded churn trace through both allocators: every returned id
    and the whole state (free and allocated sets, refcounts, reservation)
    equal after every step, and both drain to empty."""
    rng = np.random.default_rng(seed)
    pair = (PageAllocator(range(1, 25)), JaxPageAllocator(range(1, 25)))
    held: list[list[int]] = []
    for _ in range(80):
        op = rng.random()
        a = pair[0]
        if op < 0.4 and a.available() > 0:
            n = int(rng.integers(1, min(a.available(), 4) + 1))
            got = []
            for x in pair:
                assert x.reserve(n)
                got.append([x.alloc() for _ in range(n)])
            assert got[0] == got[1]
            held.append(got[0])
        elif op < 0.6 and held:
            grp = held[int(rng.integers(len(held)))]
            pid = grp[int(rng.integers(len(grp)))]
            held.append([x.share(pid) for x in pair][:1])
        elif held:
            grp = held.pop(int(rng.integers(len(held))))
            for x in pair:
                x.release(grp)
        assert _state(pair[0]) == _state(pair[1])
        assert [x.available() for x in pair] == [a.available()] * 2
    while held:
        grp = held.pop()
        for x in pair:
            x.release(grp)
    assert _state(pair[0]) == _state(pair[1])
    assert pair[0].n_allocated == 0 and not pair[0]._refs


# ---------------------------------------------------------------------------
# the prefix index
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("seed", range(24))
def test_index_trace_equal_step_for_step(seed):
    """One seeded trace of lookups, hits, slot lifecycles (map, allocate,
    register with and without the partial page, retire), evictions and a
    final clear through both packages: every lookup's matched tokens and
    node pages, every eviction count, the node and token counts and the
    allocator state equal after every step."""
    rng = np.random.default_rng(seed)
    P = int(rng.choice([2, 3, 4]))
    align = int(rng.choice([1, 2, 4]))
    allocs = (PageAllocator(range(1, 41)), JaxPageAllocator(range(1, 41)))
    idxs = (PrefixIndex(allocs[0], P, page_bytes=64),
            JaxPrefixIndex(allocs[1], P, page_bytes=64))
    for _ in range(30):
        L = int(rng.integers(1, 12))
        prompt = tuple(int(t) for t in rng.integers(0, 2, L))
        found = [ix.lookup(prompt, L - 1, align) for ix in idxs]
        (nodes, matched), (jnodes, jmatched) = found
        assert matched == jmatched
        assert [n.page for n in nodes] == [n.page for n in jnodes]
        assert [n.tokens for n in nodes] == [n.tokens for n in jnodes]
        for ix, (ns, _) in zip(idxs, found):
            ix.hit(ns)
        n_pages, n_mapped = -(-L // P), matched // P
        rows = []
        for a, (ns, _) in zip(allocs, found):
            row = [a.share(ns[j].page) for j in range(n_mapped)]
            if not a.reserve(n_pages - n_mapped):
                a.release(row)
                rows.append(None)
                continue
            rows.append(row + [a.alloc() for _ in range(n_pages - n_mapped)])
        assert rows[0] == rows[1]
        if rows[0] is not None:
            partial = bool(rng.random() < 0.7)
            made = [ix.register(prompt, row, allow_partial=partial)
                    for ix, row in zip(idxs, rows)]
            assert made[0] == made[1]
            for a, row in zip(allocs, rows):
                a.release(row)
        if rng.random() < 0.25:
            need = int(rng.integers(1, 41))
            assert idxs[0].evict_until(need) == idxs[1].evict_until(need)
        assert (idxs[0].n_nodes, idxs[0].tokens_cached) == \
            (idxs[1].n_nodes, idxs[1].tokens_cached)
        assert _state(allocs[0]) == _state(allocs[1])
    assert idxs[0].clear() == idxs[1].clear()
    assert _state(allocs[0]) == _state(allocs[1])
    assert allocs[0].n_allocated == 0


# ---------------------------------------------------------------------------
# serving against the JAX Scheduler
# ---------------------------------------------------------------------------

def _both(jengine, engine, reqs, jkw, kw):
    """JAX sharing off and on, the port on -> (port tokens, sched, JAX off,
    JAX on, JAX on metrics)."""
    off = oracle(jengine, reqs, **jkw)
    on = oracle(jengine, reqs, prefix_share=True, **jkw)
    jm = jengine.metrics
    got, sched = port_serve(engine, reqs, prefix_share=True, **kw)
    return got, sched, off, on, jm


def _check(label, got, sched, engine, off, on, jm):
    assert_tokens_identical(got, off, f"{label} vs JAX sharing off")
    if on == off:
        assert_tokens_identical(got, on, f"{label} vs JAX sharing on")
    m = engine.metrics
    assert counters(m) == counters(jm), label
    assert m.prefix_hits > 0 and m.prefix_tokens_reused > 0
    assert sched._pool.allocator.reserved == 0
    assert not sched._pool.busy()


@pytest.mark.parametrize("codec", ["none", "cluster"])
@pytest.mark.parametrize("chunk", [3, 4])
@pytest.mark.parametrize("page", [4, 8])
def test_gathered_tokens_and_counters_match_the_reference(page, chunk,
                                                          codec):
    engine, jengine, _ = engines()
    kw = dict(attn_backend="gathered", kv_page_size=page,
              prefill_chunk=chunk, kv_codec=codec)
    reqs = trace(jengine)
    got, sched, off, on, jm = _both(jengine, engine, reqs, kw, kw)
    _check(f"gathered page {page} chunk {chunk} {codec}", got, sched,
           engine, off, on, jm)
    if (page, chunk) != (4, 3):
        assert on == off
    assert engine.metrics.prefix_tokens_reused % chunk == 0


@pytest.mark.parametrize("page,chunk,codec", [(8, 4, "none"),
                                              (4, 3, "cluster"),
                                              (4, 4, "none")])
def test_cuda_paged_tokens_and_counters_match_pallas_paged(
        page, chunk, codec, interpreted):
    """The mixed step over shared pages (the kernel's plain version here)
    against the JAX ``pallas_paged`` run, its kernel interpreted."""
    engine, jengine, _ = engines()
    kw = dict(kv_page_size=page, prefill_chunk=chunk, kv_codec=codec)
    reqs = trace(jengine)
    got, sched, off, on, jm = _both(
        jengine, engine, reqs, dict(attn_backend="pallas_paged", **kw),
        dict(attn_backend="cuda_paged", **kw))
    _check(f"cuda_paged page {page} chunk {chunk} {codec}", got, sched,
           engine, off, on, jm)
    assert on == off


def test_deepseek_mla_shares_pages_on_both_backends(interpreted):
    """MLA latent pages shared and copied on write, on both backends."""
    engine, jengine, _ = engines("deepseek-v2-236b")
    reqs = prefix_requests(jengine)
    for backend, jbackend in (("gathered", "gathered"),
                              ("cuda_paged", "pallas_paged")):
        kw = dict(kv_page_size=8, prefill_chunk=4)
        got, sched, off, on, jm = _both(
            jengine, engine, reqs, dict(attn_backend=jbackend, **kw),
            dict(attn_backend=backend, **kw))
        _check(f"deepseek {backend}", got, sched, engine, off, on, jm)


def test_retire_readmit_churn_matches_the_reference():
    """The same prompts resubmitted to a warm scheduler on both packages:
    every run's tokens and the cumulative counters agree, and the warm
    pass reuses more."""
    engine, jengine, _ = engines()
    reqs = prefix_requests(jengine)
    kw = dict(batch_size=2, kv_page_size=8, prefill_chunk=4,
              prefix_share=True, attn_backend="gathered")
    runs = {}
    for name, eng, cls in (("jax", jengine, JaxScheduler),
                           ("port", engine, Scheduler)):
        eng.metrics = type(eng.metrics)()
        sched = cls(eng, buckets=(32,), **kw)
        out = []
        for _ in range(2):
            rids = {sched.submit(*r).rid: i for i, r in enumerate(reqs)}
            out.append({rids[r.rid]: tuple(r.generated)
                        for r in sched.run()})
            out.append(counters(eng.metrics))
        runs[name] = out
    assert runs["port"] == runs["jax"]
    assert runs["port"][0] == runs["port"][2]
    assert runs["port"][3]["prefix_tokens_reused"] > \
        runs["port"][1]["prefix_tokens_reused"]


def test_drain_leaves_only_index_references():
    engine, jengine, _ = engines()
    reqs = prefix_requests(jengine)
    _, sched = port_serve(engine, reqs, attn_backend="cuda_paged",
                          kv_page_size=8, prefill_chunk=4, prefix_share=True)
    pool = sched._pool
    a = pool.allocator
    assert a.reserved == 0
    assert a.n_allocated == pool.prefix.n_nodes > 0
    assert a.shared_pages() == 0
    assert all(a.refcount(n.page) == 1 for n in pool.prefix._nodes())
    assert pool.prefix.clear() > 0
    assert a.n_allocated == 0 and a.n_free == a.total
    assert (pool.table == 0).all()


@pytest.mark.parametrize("backend", ["gathered", "cuda_paged"])
def test_cow_never_leaves_a_written_page_shared(backend, monkeypatch):
    """After every copy-on-write barrier, no page backing the positions
    about to be written has another reference; the copies happened."""
    orig = SlotPool._prepare_write
    barriers = []

    def checked(pool, slot, lo, hi):
        orig(pool, slot, lo, hi)
        if pool.prefix is None:
            return
        for j in range(lo // pool.page_size, hi // pool.page_size + 1):
            pid = int(pool.table[slot.index, j])
            if pid:
                assert pool.allocator.refcount(pid) == 1, pid
                barriers.append(pid)

    monkeypatch.setattr(SlotPool, "_prepare_write", checked)
    engine, jengine, _ = engines()
    reqs = prefix_requests(jengine)
    kw = dict(attn_backend=backend, kv_page_size=8, prefill_chunk=4)
    base, _ = port_serve(engine, reqs, **kw)
    got, _ = port_serve(engine, reqs, prefix_share=True, **kw)
    assert_tokens_identical(got, base, f"cow-instrumented {backend}")
    assert barriers and engine.metrics.prefix_cow_copies > 0


def test_copy_page_copies_codes_and_scales_in_both_layouts():
    """The copy-on-write copy moves a page's codes and its scales, so the
    copy decodes to the same values (both layouts)."""
    engine = engines()[0]
    for backend in ("gathered", "cuda_paged"):
        pool = SlotPool(engine, 2, 16, page_size=4, backend=backend,
                        kv_codec="cluster", prefix_share=True)
        pools = pool.pages + pool.page_scales if backend == "gathered" \
            else [*tree_leaves(pool.kcache), *tree_leaves(pool.kscales)]
        for i, p in enumerate(pools):
            v = torch.arange(p.numel(), dtype=torch.float64) * 7 + i
            p.copy_((v % 97 - 48).reshape(p.shape))
        pool._copy_page(3, 5)
        for p, ax in zip(pools, (1,) * len(pools) if backend == "gathered"
                         else pool._paged_axis * 2):
            lead = (slice(None),) * (ax - 1)
            assert (p[lead + (5,)] == p[lead + (3,)]).all()
            assert not (p[lead + (4,)] == p[lead + (3,)]).all()


def test_metrics_and_stats_line():
    engine, jengine, _ = engines()
    port_serve(engine, prefix_requests(jengine), attn_backend="gathered",
               kv_page_size=8, prefill_chunk=4, prefix_share=True)
    m = engine.metrics
    assert m.prefix_hits > 0 and m.prefill_chunks_avoided > 0
    assert m.shared_page_steps > 0
    line = m.stats_line()
    assert "prefix" in line and "toks reused" in line and "cow)" in line


class TestGating:
    def test_requires_page_size_and_chunk(self):
        engine = engines()[0]
        with pytest.raises(ValueError, match="kv_page_size"):
            Scheduler(engine, prefix_share=True, prefill_chunk=4,
                      attn_backend="gathered")
        with pytest.raises(ValueError, match="prefill_chunk"):
            Scheduler(engine, prefix_share=True, kv_page_size=8)
        with pytest.raises(ValueError, match="page_size"):
            SlotPool(engine, 2, 16, backend="gathered", prefix_share=True)

    def test_sharing_off_by_default(self):
        engine, jengine, _ = engines()
        _, sched = port_serve(engine, prefix_requests(jengine)[:2],
                              kv_page_size=8, prefill_chunk=4)
        assert sched._pool.prefix is None
        assert engine.metrics.prefix_hits == 0

    def test_windowed_arch_downgrades_with_the_reference_note(
            self, interpreted):
        """gemma2's rolling-window lanes cannot ride a shared page: both
        packages downgrade (a RuntimeWarning once, and the same note) and
        serve the same tokens as without the flag."""
        engine, jengine, reqs = engines("gemma2-2b")
        notes = {}
        for name, eng, cls, mod in (
                ("jax", jengine, JaxScheduler, jax_sched_mod),
                ("port", engine, Scheduler, sched_mod)):
            mod._FALLBACK_WARNED.clear()
            notes[name] = []
            with pytest.warns(RuntimeWarning,
                              match="supports_prefix_share=False"):
                sched = cls(eng, kv_page_size=8, prefill_chunk=4,
                            prefix_share=True, attn_backend="gathered",
                            emit=notes[name].append)
            assert not sched.prefix_share
        assert notes["port"] == notes["jax"] and notes["port"]
        kw = dict(kv_page_size=8, prefill_chunk=4, prefix_share=True)
        want = oracle(jengine, reqs, attn_backend="pallas_paged", **kw)
        got, sched = port_serve(engine, reqs, attn_backend="cuda_paged",
                                **kw)
        assert_tokens_identical(got, want, "gemma2 downgraded")
        assert sched._pool.prefix is None

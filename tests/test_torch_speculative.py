"""Speculative decoding in the port against the JAX package, on the CPU.

* ``NGramDrafter`` proposals equal the reference's on seeded histories
  (every k and limit), and ``make_drafter`` resolves and refuses the same
  specs.
* ``ServeEngine.verify_slots`` — one batched ragged call with per-lane
  positions and ``q_lens`` — against the JAX engine's (a vmap of
  ``verify_step`` over slot lanes) on lanes prefilled by each package:
  the logits of every real row within 1e-5, on minitron, gemma2 at window
  16 (rolling lanes past the window) and deepseek (MLA latent lanes); an
  idle lane (``q_lens`` 0) keeps its cache.
* Serving with speculation, unit-scale MLP weights, against the JAX
  ``Scheduler`` on the same settings: tokens and the ``spec_*`` counters
  (rounds, drafts proposed, accepted, rejected) and the decode steps
  equal, for the n-gram drafter and the draft model (both packages' draft
  models on the same unit-scale params), on monolithic lanes, gathered
  pages (fp and codec), ``cuda_paged`` with monolithic and chunked
  prefill (against ``pallas_paged``, its kernel interpreted under the
  ``monkeypatch``-scoped compiler-params alias); gemma2's rolling lanes
  beside the pools, deepseek's MLA, rollback across page boundaries
  (page 2, ``draft_k`` 6), rollback on copy-on-write'd shared pages,
  speculation with prefix sharing on the kernel backend, chunked prefill
  interleaved, and ``draft_k`` 1, 2 and 7.  Every speculative run's
  tokens also equal plain decoding's.  Stated tolerance: tokens and
  counters identical.
"""

import dataclasses

import jax
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

import repro.models.api as jax_api
from repro.runtime import drafter as jax_drafter
from repro_torch.runtime import Scheduler, ServeMetrics
from repro_torch.runtime import scheduler as sched_mod
from repro_torch.runtime.drafter import (DraftModelDrafter, Drafter,
                                         NGramDrafter, _clamp, make_drafter)
from repro_torch.tree import tree_leaves
from tests.harness import assert_tokens_identical
from tests.test_speculative import repetitive_requests
from tests.test_torch_harness import jax_params, torch_params, unit_scale_mlp
from tests.test_torch_serve_gathered import (make_engines, oracle,
                                             port_serve)

SPEC = ("spec_rounds", "spec_draft_tokens", "spec_accepted_tokens",
        "spec_rejected_tokens", "decode_steps", "tokens_generated",
        "prefix_hits", "prefix_tokens_reused", "prefix_cow_copies")

_ENGINES = {}


def engines(arch="minitron-8b"):
    if arch not in _ENGINES:
        _ENGINES[arch] = make_engines(arch)
    return _ENGINES[arch]


def counters(m):
    return {k: getattr(m, k) for k in SPEC}


@pytest.fixture
def interpreted(monkeypatch):
    """Let the JAX Pallas kernel run interpreted under jax 0.9."""
    monkeypatch.setattr(pltpu, "TPUCompilerParams", pltpu.CompilerParams,
                        raising=False)


@pytest.fixture
def same_draft_model(monkeypatch):
    """Both packages' draft models on the same unit-scale params (seed 0 of
    the reference's draft config, MLP weights as their signs): the
    reference's drafter draws them through ``repro.models.api.get_model``,
    the port's takes them as ``params``."""
    real = jax_api.get_model

    def get_model(cfg):
        api = real(cfg)
        return dataclasses.replace(
            api, init_params=lambda c, key: unit_scale_mlp(
                jax.tree_util.tree_map(np.asarray, api.init_params(c, key))))

    monkeypatch.setattr(jax_api, "get_model", get_model)

    def port_make(spec, engine=None):
        if spec != "draft":
            return make_drafter(spec, engine)
        cfg = jax_drafter.draft_config(engine.cfg.vocab_size)
        return DraftModelDrafter(engine, params=torch_params(
            unit_scale_mlp(jax_params(cfg, seed=0))))

    monkeypatch.setattr(sched_mod, "make_drafter", port_make)


def check(arch, reqs, kw, speculate="ngram", eng=None, **spec_kw):
    """The JAX run with and without speculation and the port's run with
    it: tokens equal to both, counters equal to the JAX speculative run's
    -> the port's metrics."""
    engine, jengine = eng or engines(arch)[:2]
    jkw = dict(kw)
    jkw["attn_backend"] = jkw.get("attn_backend", "gathered").replace(
        "cuda_paged", "pallas_paged")
    kw = {"attn_backend": "gathered", **kw}
    base = oracle(jengine, reqs, **jkw)
    want = oracle(jengine, reqs, speculate=speculate, **jkw, **spec_kw)
    jm = jengine.metrics
    got, sched = port_serve(engine, reqs, speculate=speculate, **kw,
                            **spec_kw)
    label = f"{arch} {speculate} {kw} {spec_kw}"
    assert_tokens_identical(got, want, label)
    assert_tokens_identical(got, base, f"{label} vs plain decoding")
    m = engine.metrics
    assert counters(m) == counters(jm), label
    assert m.spec_rounds > 0 and m.spec_draft_tokens == \
        m.spec_accepted_tokens + m.spec_rejected_tokens
    pool = sched._pool
    if pool.paged and pool.prefix is None:
        assert pool.allocator.n_allocated == 0
    return m


# ---------------------------------------------------------------------------
# drafters
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("seed", range(12))
def test_ngram_proposals_equal_the_reference(seed):
    rng = np.random.default_rng(seed)
    vocab = int(rng.choice([2, 4, 16]))
    hists = [rng.integers(0, vocab, int(rng.integers(0, 48)))
             for _ in range(8)]
    hists.append(np.tile(rng.integers(0, vocab, 3), 5))
    port, ref = NGramDrafter(), jax_drafter.NGramDrafter()
    for k in (1, 2, 4, 7):
        limits = [int(x) for x in rng.integers(0, 6, len(hists))]
        for lim in (None, limits):
            got = port.propose(hists, k, limits=lim)
            want = ref.propose(hists, k, limits=lim)
            assert [list(g) for g in got] == [list(w) for w in want]
            assert all(g.dtype == np.int64 and len(g) <= k for g in got)


def test_make_drafter_resolves_the_reference_specs():
    engine = make_engines("minitron-8b")[0]
    assert make_drafter("off") is None and make_drafter(None) is None
    assert isinstance(make_drafter("ngram"), NGramDrafter)
    d = make_drafter("draft", engine)
    assert isinstance(d, DraftModelDrafter)
    # the draft model rides the shared weight store: its MLP tiles are
    # registered beside the target's, as model "draft"
    assert d.store is engine.store and d._raw is None
    assert engine.store.models() == ["lm", "draft"]
    assert set(engine.store.layers("draft")) == \
        set(engine.store.layers("lm")) >= {"scan/b0/mlp/up"}
    params = d._params()
    assert params["scan"]["b0"]["mlp"]["up"].device == engine.device
    assert [len(x) for x in d.propose([np.arange(5), []], 3)] == [3, 0]
    with pytest.raises(ValueError, match="unknown speculate"):
        make_drafter("medusa")
    with pytest.raises(ValueError, match="needs an engine"):
        make_drafter("draft")


# ---------------------------------------------------------------------------
# verify_slots against the reference's
# ---------------------------------------------------------------------------

def _stack_port(caches):
    stacked = [torch.stack(ls) for ls in zip(*map(tree_leaves, caches))]
    return sched_mod._unflatten(caches[0], stacked)


@pytest.mark.parametrize("arch", ["minitron-8b", "gemma2-2b",
                                  "deepseek-v2-236b"])
def test_verify_slots_logits_match_the_reference(arch):
    """Three lanes prefilled to 20, 9 and 14 tokens by each package, then
    one ragged block of 5 / 2 / 0 tokens verified: every real row's logits
    within 1e-5 of the JAX engine's, and the idle lane's cache kept."""
    engine, jengine, _ = engines(arch)
    params, jparams = engine.step_params(), jengine.step_params()
    rng = np.random.default_rng(11)
    lens, q_lens = [20, 9, 14], np.array([5, 2, 0], np.int32)
    slot_len = 32
    prompts = [rng.integers(0, engine.cfg.vocab_size, n) for n in lens]
    pooled = _stack_port([engine.prefill_request(params, p, slot_len)[1]
                          for p in prompts])
    jpooled = jax.tree_util.tree_map(
        lambda *ls: jax.numpy.stack(ls),
        *[jengine.prefill_request(jparams, p, slot_len)[1] for p in prompts])
    toks = rng.integers(0, engine.cfg.vocab_size, (3, 1, 5)).astype(np.int32)
    poss = np.array(lens, np.int32)
    idle = [leaf[2].clone() for leaf in tree_leaves(pooled)]
    got, _ = engine.verify_slots(params, pooled, toks, poss, q_lens)
    want, _ = jengine.verify_slots(jparams, jpooled, jax.numpy.asarray(toks),
                                   jax.numpy.asarray(poss), q_lens,
                                   commit=False)
    want = np.asarray(want)
    assert got.shape == want.shape == (3, 1, 5, engine.cfg.vocab_size)
    for s, n in enumerate(q_lens):
        np.testing.assert_allclose(got[s, 0, :n].numpy(), want[s, 0, :n],
                                   rtol=0, atol=1e-5)
    assert all(torch.equal(leaf[2], was)
               for leaf, was in zip(tree_leaves(pooled), idle))


# ---------------------------------------------------------------------------
# serving against the JAX Scheduler
# ---------------------------------------------------------------------------

LAYOUTS = {
    "monolithic lanes": dict(),
    "gathered page 4": dict(kv_page_size=4),
    "gathered page 4 codec": dict(kv_page_size=4, kv_codec="cluster"),
    "cuda_paged page 4 monolithic": dict(attn_backend="cuda_paged",
                                         kv_page_size=4),
    "cuda_paged page 4 chunk 3": dict(attn_backend="cuda_paged",
                                      kv_page_size=4, prefill_chunk=3),
    "cuda_paged page 4 chunk 3 codec": dict(
        attn_backend="cuda_paged", kv_page_size=4, prefill_chunk=3,
        kv_codec="cluster"),
}


@pytest.mark.parametrize("layout", LAYOUTS)
def test_ngram_tokens_and_counters_match_the_reference(layout, interpreted):
    """Chunked prefill under the codec decodes 16 tokens a request here,
    not 24: past that the two packages' pools part by one code (see
    ``test_chunked_codec_pools_part_by_rounding_only``)."""
    engine = engines()[0]
    decode = 16 if "chunk 3 codec" in layout else 24
    m = check("minitron-8b", repetitive_requests(engine, decode=decode),
              LAYOUTS[layout])
    # the fp runs accept drafts on this trace; the codec ones (in both
    # packages) reject every one
    assert (m.spec_accepted_tokens > 0) == ("codec" not in layout)


@pytest.mark.parametrize("layout", ["monolithic lanes",
                                    "gathered page 4 codec",
                                    "cuda_paged page 4 chunk 3"])
def test_draft_model_tokens_and_counters_match_the_reference(
        layout, interpreted, same_draft_model):
    """A fresh engine pair each: the first draft model registers in the
    store on both sides (a second one on the same store serves raw, in
    both packages)."""
    engine, jengine, _ = make_engines("minitron-8b")
    check("minitron-8b", repetitive_requests(engine), LAYOUTS[layout],
          speculate="draft", eng=(engine, jengine))
    assert "draft" in engine.store.models()


@pytest.mark.parametrize("layout", ["gathered page 4",
                                    "cuda_paged page 4 monolithic",
                                    "cuda_paged page 4 chunk 3"])
@pytest.mark.parametrize("arch", ["gemma2-2b", "deepseek-v2-236b"])
def test_archs_match_the_reference(arch, layout, interpreted, monkeypatch):
    """gemma2 at window 16: its local blocks are rolling lanes beside the
    global blocks' pools, snapshotted before each speculative mixed step
    and restored after it under ``cuda_paged``; deepseek: MLA latent
    pools at Q = 1 + draft_k."""
    calls = []
    for name in ("spec_snapshot", "spec_restore"):
        real = getattr(sched_mod.SlotPool, name)
        monkeypatch.setattr(
            sched_mod.SlotPool, name,
            lambda self, *a, _real=real, _name=name: (
                calls.append(_name), _real(self, *a))[1])
    engine = engines(arch)[0]
    check(arch, repetitive_requests(engine), LAYOUTS[layout])
    lanes = arch == "gemma2-2b" and "cuda_paged" in layout
    assert bool(calls) == lanes
    if lanes:
        assert "spec_restore" in calls and calls.count("spec_snapshot") \
            >= calls.count("spec_restore")


@pytest.mark.parametrize("backend", ["gathered", "cuda_paged"])
def test_rollback_across_page_boundaries(backend, interpreted):
    """draft_k 6 on 2-token pages: every verify block spans pages, and the
    last rows of a block land on a page allocated for it."""
    engine = engines()[0]
    check("minitron-8b", repetitive_requests(engine, decode=16),
          dict(attn_backend=backend, kv_page_size=2), draft_k=6)


@pytest.mark.parametrize("backend", ["gathered", "cuda_paged"])
def test_rollback_on_cow_shared_pages(backend, interpreted):
    """Prefix sharing + speculation: identical prompts map shared pages,
    and every draft write goes through the copy-on-write barrier."""
    engine = engines()[0]
    rng = np.random.default_rng(9)
    shared = rng.integers(0, engine.cfg.vocab_size, 12)
    reqs = [(shared, 12), (shared, 12), (shared, 8)]
    m = check("minitron-8b", reqs,
              dict(attn_backend=backend, kv_page_size=4, prefill_chunk=4,
                   prefix_share=True), draft_k=6)
    assert m.prefix_hits > 0


def test_prefix_share_on_kernel_backend_with_the_codec(interpreted):
    """14-token prompts on 4-token pages: the partial boundary page is
    registered, so the first slot's first decode write copies it."""
    engine = engines()[0]
    rng = np.random.default_rng(9)
    shared = rng.integers(0, engine.cfg.vocab_size, 14)
    m = check("minitron-8b", [(shared, 12), (shared, 12), (shared, 9)],
              dict(attn_backend="cuda_paged", kv_page_size=4,
                   prefill_chunk=4, prefix_share=True, kv_codec="cluster"))
    assert m.prefix_hits > 0 and m.prefix_cow_copies > 0


@pytest.mark.parametrize("backend", ["gathered", "cuda_paged"])
def test_chunked_prefill_interleaved(backend, interpreted):
    engine = engines()[0]
    check("minitron-8b", repetitive_requests(engine, n=5),
          dict(attn_backend=backend, kv_page_size=4, prefill_chunk=3))


@pytest.mark.parametrize("draft_k", [1, 2, 7])
def test_any_draft_depth(draft_k, interpreted):
    engine = engines()[0]
    check("minitron-8b", repetitive_requests(engine, n=3),
          dict(attn_backend="cuda_paged", kv_page_size=4, prefill_chunk=3),
          draft_k=draft_k)


def test_chunked_codec_pools_part_by_rounding_only(interpreted):
    """Why the chunked codec runs above stop at 16 tokens: serving the
    repetitive trace's request 1 to 24 tokens, the packages' tokens part
    at token 19, with and without speculation, on either backend.  Up to
    there their code pools hold the same codes but one, off by one, and
    scales within 1e-6 relative: the K/V agree to an ulp, and one value
    on a rounding boundary rounds to the next code (ROADMAP, reference
    caveats).  The port's speculative run keeps its own plain tokens."""
    from repro.runtime import Scheduler as JaxScheduler
    engine, jengine, _ = engines()
    req = repetitive_requests(engine)[1]
    kw = dict(kv_page_size=8, prefill_chunk=4, kv_codec="cluster",
              attn_backend="gathered", batch_size=1)
    jsched, sched = JaxScheduler(jengine, buckets=(64,), **kw), \
        Scheduler(engine, **kw)
    for sc in (jsched, sched):
        sc.submit(*req)
    want, got = jsched.run()[0].generated, sched.run()[0].generated
    first = next(i for i, (a, b) in enumerate(zip(want, got)) if a != b)
    assert first == 19
    seen = req[0].shape[0] + first          # positions written by then
    codes = scales = 0
    for jp, p, jsc, sc in zip(jsched._pool.pages, sched._pool.pages,
                              jsched._pool.page_scales,
                              sched._pool.page_scales):
        for pos in range(seen):
            page, row = 1 + pos // 8, pos % 8
            a = np.asarray(jp)[page][..., row, :, :].astype(int)
            b = p.numpy()[page][..., row, :, :].astype(int)
            codes += int((a != b).sum())
            assert np.abs(a - b).max() <= 1
            sa, sb = np.asarray(jsc)[page][..., row], \
                sc.numpy()[page][..., row]
            scales = max(scales, float(np.max(np.abs(sa - sb) / sa)))
    assert codes == 1 and scales < 1e-6
    for backend in ("gathered", "cuda_paged"):
        kw = dict(attn_backend=backend, kv_page_size=4, prefill_chunk=3,
                  kv_codec="cluster")
        reqs = repetitive_requests(engine)
        plain, _ = port_serve(engine, reqs, **kw)
        spec, _ = port_serve(engine, reqs, speculate="ngram", **kw)
        assert_tokens_identical(spec, plain, f"{backend} codec spec")


def test_garbage_drafts_leave_the_tokens(monkeypatch):
    """A drafter that always proposes the last vocab id: every draft is
    rejected and the tokens stay plain decoding's."""
    engine, jengine, reqs = engines()

    class Garbage(Drafter):
        def propose(self, histories, k, limits=None):
            return [_clamp(np.full(k, engine.cfg.vocab_size - 1, np.int64),
                           k, None if limits is None else limits[i])
                    for i in range(len(histories))]

    monkeypatch.setattr(sched_mod, "make_drafter",
                        lambda spec, eng=None: Garbage())
    base = oracle(jengine, reqs)
    got, _ = port_serve(engine, reqs, speculate="ngram",
                        attn_backend="gathered")
    assert_tokens_identical(got, base, "garbage drafts")
    assert engine.metrics.spec_rejected_tokens > 0


class TestWiring:
    def test_metrics_and_stats_line(self):
        engine = engines()[0]
        port_serve(engine, repetitive_requests(engine), speculate="ngram",
                   attn_backend="gathered")
        m = engine.metrics
        assert m.spec_rounds > 0 and m.decode_steps < m.slot_steps
        assert 0.0 < m.spec_acceptance_rate() <= 1.0
        assert "drafts accepted" in m.stats_line()
        assert ServeMetrics().spec_acceptance_rate() == 0.0

    def test_speculation_off_by_default(self):
        sched = Scheduler(engines()[0], kv_page_size=4)
        assert sched.drafter is None and sched.speculate == "off"

    def test_bad_draft_k_rejected(self):
        with pytest.raises(ValueError, match="draft_k"):
            Scheduler(engines()[0], kv_page_size=4, speculate="ngram",
                      draft_k=0)

    def test_kernel_tune_still_refused(self):
        with pytest.raises(NotImplementedError, match="kernel_tune"):
            Scheduler(engines()[0], kv_page_size=4, kernel_tune="auto")

"""mamba2-780m's SSD mixer and recurrentgemma's RG-LRU in the port against
the JAX reference, on the CPU, at the reduced widths of
``tests/test_models.py::REDUCED``.

* Block level, within ``ATOL``/``RTOL`` 1e-5 (both compute in f32 and
  differ in summation order; the RG-LRU's associative scan pairs its
  elements as ``jax.lax.associative_scan`` does and is held bit for bit):
  ``ssd_chunked`` from zeros and from a state, ``_causal_conv`` with a
  carried state and ragged ``q_lens``, and ``ssm_apply`` and
  ``rglru_apply`` in each branch -- prefill filling a cache, one-token
  decode, a chunk resumed from the cache at ``pos``, and a ragged block
  whose ``q_lens`` has a 0 lane, which must leave that lane's cache bit
  for bit as it was.
* Serving: ``tests/harness.py::MIXED`` with unit-scale MLPs (so the
  binarised products are exact in both packages) and embeddings scaled
  by 30 (so n-gram drafts are accepted) gives the JAX ``Scheduler``'s
  tokens and step counts exactly on gathered monolithic,
  page 4 chunk 3 (the same chunking on both sides: the compressed
  recurrentgemma's monolithic and chunked runs differ by rounding, ROADMAP
  caveats), wave admission and n-gram speculation over repetitive prompts
  (accepted and rejected drafts; the tokens are the plain run's, so the
  recurrent state advanced by accepted tokens only), and a ``cuda_paged``
  request downgrades to ``gathered`` with the reference's warning and
  note.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import rglru as jrglru
from repro.models import ssm as jssm
from repro.runtime import scheduler as jax_sched_mod
from repro.runtime.scheduler import Scheduler as JaxScheduler
from repro.runtime.scheduler import ServeEngine as JaxServeEngine
from repro_torch.models import rglru, ssm
from repro_torch.runtime import Scheduler, ServeEngine
from repro_torch.runtime import scheduler as sched_mod
from tests.harness import MIXED, assert_tokens_identical, mixed_requests
from tests.test_speculative import repetitive_requests
from tests.test_torch_harness import (jax_params, reduced_jax, reduced_torch,
                                      torch_params, unit_scale_mlp)
from tests.test_torch_serve_gathered import (assert_nothing_leaked, oracle,
                                             port_serve)

ATOL = RTOL = 1e-5


def J(a):
    return jnp.asarray(np.asarray(a))


def T(a):
    return torch.from_numpy(np.array(a))


def close(got, want):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), atol=ATOL,
                               rtol=RTOL)


def _mixer(arch, block="b0", seed=1):
    """The mixer params of block ``block`` of the reduced arch's first scan
    repeat, in both packages."""
    jcfg, cfg = reduced_jax(arch), reduced_torch(arch)
    tree = jax_params(jcfg, seed=seed)
    p = jax.tree_util.tree_map(lambda a: a[0], tree["scan"][block]["mixer"])
    return jcfg, cfg, p, torch_params(p)


def _cache(spec_fn, jspec_fn, cfg, jcfg, b, seed):
    """A random cache in both packages (numpy-seeded, the spec's dtypes)."""
    rng = np.random.default_rng(seed)
    jc = {k: np.asarray(rng.standard_normal(s.shape), s.dtype)
          for k, s in jspec_fn(jcfg, b).items()}
    tc = {k: T(v) for k, v in jc.items()}
    assert {k: tuple(v.shape) for k, v in spec_fn(cfg, b).items()} == \
        {k: v.shape for k, v in jc.items()}
    return {k: J(v) for k, v in jc.items()}, tc


# ---------------------------------------------------------------------------
# block level
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("seeded", [False, True])
def test_ssd_chunked_equals_the_reference(seeded):
    """Three chunks of 8 over 4 heads, 2 groups (heads repeat per group),
    from zeros and from a seeded state."""
    rng = np.random.default_rng(0)
    b, s, h, p, g, n = 2, 24, 4, 8, 2, 6
    x = rng.standard_normal((b, s, h, p)).astype(np.float32)
    dt = np.log1p(np.exp(rng.standard_normal((b, s, h)))).astype(np.float32)
    a_log = rng.standard_normal(h).astype(np.float32) * 0.5
    bb = rng.standard_normal((b, s, g, n)).astype(np.float32)
    cc = rng.standard_normal((b, s, g, n)).astype(np.float32)
    init = rng.standard_normal((b, h, p, n)).astype(np.float32) \
        if seeded else None
    want_y, want_h = jssm.ssd_chunked(
        J(x), J(dt), J(a_log), J(bb), J(cc), 8,
        init=None if init is None else J(init))
    got_y, got_h = ssm.ssd_chunked(T(x), T(dt), T(a_log), T(bb), T(cc), 8,
                                   init=None if init is None else T(init))
    close(got_y, want_y)
    close(got_h, want_h)


def test_segsum_is_the_cumsum_difference():
    a = np.random.default_rng(1).standard_normal((3, 7)).astype(np.float32)
    got, want = ssm._segsum(T(a)).numpy(), np.asarray(jssm._segsum(J(a)))
    assert (np.isneginf(got) == np.isneginf(want)).all()
    fin = np.isfinite(want)
    close(got[fin], want[fin])


@pytest.mark.parametrize("q_lens", [None, [5, 0, 2]])
def test_causal_conv_equals_the_reference(q_lens):
    rng = np.random.default_rng(2)
    x = rng.standard_normal((3, 5, 6)).astype(np.float32)
    w = rng.standard_normal((4, 6)).astype(np.float32)
    state = rng.standard_normal((3, 3, 6)).astype(np.float32)
    want, want_st = jssm._causal_conv(J(x), J(w), J(state), q_lens=q_lens)
    got, got_st = ssm._causal_conv(T(x), T(w), T(state), q_lens=q_lens)
    close(got, want)
    close(got_st, want_st)
    if q_lens is not None:      # a 0 lane carries its state out unchanged
        assert torch.equal(got_st[1], T(state)[1])


MIXERS = {
    "ssm": ("mamba2-780m", "b0", ssm.ssm_apply, jssm.ssm_apply,
            ssm.ssm_cache_spec, jssm.ssm_cache_spec),
    "rglru": ("recurrentgemma-2b", "b0", rglru.rglru_apply,
              jrglru.rglru_apply, rglru.rglru_cache_spec,
              jrglru.rglru_cache_spec),
}
# prefill fills a fresh cache; decode is one token; resume a 7-token chunk
# at pos 9 (past the reduced ssm_chunk of 16 once padded: one chunk);
# ragged a 5-wide block with q_lens 5, 0, 3
BRANCHES = {"prefill": (20, False, None), "decode": (1, True, None),
            "resume": (7, True, None), "ragged": (5, True, [5, 0, 3])}


@pytest.mark.parametrize("branch", BRANCHES)
@pytest.mark.parametrize("kind", MIXERS)
def test_mixer_branch_equals_the_reference(kind, branch):
    arch, blk, apply, japply, spec, jspec = MIXERS[kind]
    jcfg, cfg, jp, p = _mixer(arch, blk)
    s, with_pos, q_lens = BRANCHES[branch]
    b = 3
    x = np.random.default_rng(3).standard_normal(
        (b, s, cfg.d_model)).astype(np.float32)
    jcache, cache = _cache(spec, jspec, cfg, jcfg, b, seed=4)
    if branch == "prefill":
        jcache = jax.tree_util.tree_map(jnp.zeros_like, jcache)
        cache = {k: torch.zeros_like(v) for k, v in cache.items()}
    before = {k: v.clone() for k, v in cache.items()}
    pos = 9 if with_pos else None
    ql = None if q_lens is None else np.asarray(q_lens, np.int32)
    # one jit of the reference's branch: eager jax compiles every
    # primitive of the scan shape by shape, which takes seconds
    run = jax.jit(lambda p, x, c, q: japply(p, x, jcfg, cache=c, pos=pos,
                                            q_lens=q))
    want, want_cache = run(jp, J(x), jcache, None if ql is None else J(ql))
    with torch.no_grad():
        got, got_cache = apply(p, T(x), cfg, cache=cache, pos=pos,
                               q_lens=None if ql is None else T(ql))
    assert got_cache is cache              # updated in place
    if q_lens is None:
        close(got, want)
    else:                                  # padded rows are garbage
        for i, n in enumerate(q_lens):
            close(got[i, :n], np.asarray(want)[i, :n])
    for k in cache:
        close(cache[k], want_cache[k])
    if q_lens is not None:
        for k in cache:
            assert torch.equal(cache[k][1], before[k][1]), k


def test_rglru_scan_is_the_reference_bit_for_bit():
    """The associative scan pairs elements as jax's does: h over 37 steps
    from random gates equals the reference exactly."""
    rng = np.random.default_rng(8)
    a = rng.uniform(0.5, 1.0, (2, 37, 5)).astype(np.float32)
    bb = rng.standard_normal((2, 37, 5)).astype(np.float32)

    def comb(left, right):
        return left[0] * right[0], left[1] * right[0] + right[1]

    want = jax.lax.associative_scan(comb, (J(a), J(bb)), axis=1)
    got = rglru.associative_scan(rglru._combine, (T(a), T(bb)), dim=1)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


# ---------------------------------------------------------------------------
# serving
# ---------------------------------------------------------------------------

ARCHS = ("mamba2-780m", "recurrentgemma-2b")
SETTINGS = {
    "monolithic": dict(),
    "page 4 chunk 3": dict(kv_page_size=4, prefill_chunk=3),
    "wave": dict(mode="wave", buckets=(8, 32)),
}
_ENGINES = {}


def engines(arch):
    """Both packages' engines over the unit-scale params with the
    embeddings scaled by 30, and MIXED's requests; one pair an arch, so
    the reference compiles its steps once.  At that scale the residual
    stream carries the input token strongly enough that greedy decoding
    falls into repeats, where n-gram drafts are accepted (at the init
    scale the reduced models rarely repeat, and every draft is
    rejected)."""
    if arch not in _ENGINES:
        tree = unit_scale_mlp(jax_params(reduced_jax(arch), seed=0))
        tree["embed"] = (tree["embed"] * 30.0).astype(tree["embed"].dtype)
        jengine = JaxServeEngine(reduced_jax(arch), tree)
        _ENGINES[arch] = (ServeEngine(reduced_torch(arch), torch_params(tree),
                                      device="cpu"),
                          jengine, mixed_requests(jengine, MIXED))
    return _ENGINES[arch]


def _same_run(engine, jengine, sched):
    m, jm = engine.metrics, jengine.metrics
    assert (m.decode_steps, m.kv_gather_bytes, m.kv_prefill_gather_bytes,
            m.prefill_chunks, m.waves, m.spec_accepted_tokens,
            m.spec_rejected_tokens) == \
        (jm.decode_steps, jm.kv_gather_bytes, jm.kv_prefill_gather_bytes,
         jm.prefill_chunks, jm.waves, jm.spec_accepted_tokens,
         jm.spec_rejected_tokens)
    assert_nothing_leaked(sched._pool)


@pytest.mark.parametrize("setting", SETTINGS)
@pytest.mark.parametrize("arch", ARCHS)
def test_gathered_tokens_identical_to_the_reference(arch, setting):
    engine, jengine, reqs = engines(arch)
    kw = dict(attn_backend="gathered", **SETTINGS[setting])
    want = oracle(jengine, reqs, **kw)
    got, sched = port_serve(engine, reqs, **kw)
    assert_tokens_identical(got, want, f"{arch} {setting}")
    _same_run(engine, jengine, sched)
    assert engine.compressed == (arch == "recurrentgemma-2b")


@pytest.mark.parametrize("arch", ARCHS)
def test_ngram_speculation_tokens_identical_to_the_reference(arch):
    """Repetitive prompts, so drafts are accepted and rejected; page 4
    chunk 3, k = 3: the tokens are the plain run's, so the committed
    recurrent state advanced by accepted tokens only."""
    engine, jengine, _ = engines(arch)
    reqs = repetitive_requests(jengine, decode=12)
    kw = dict(attn_backend="gathered", kv_page_size=4, prefill_chunk=3)
    plain, _ = port_serve(engine, reqs, **kw)
    want = oracle(jengine, reqs, speculate="ngram", draft_k=3, **kw)
    got, sched = port_serve(engine, reqs, speculate="ngram", draft_k=3,
                            **kw)
    assert_tokens_identical(got, want, f"{arch} ngram")
    assert_tokens_identical(got, plain, f"{arch} ngram vs plain")
    _same_run(engine, jengine, sched)
    assert engine.metrics.spec_accepted_tokens > 0
    assert engine.metrics.spec_rejected_tokens > 0


@pytest.fixture
def fresh_warnings(monkeypatch):
    """Each package's warn-once set emptied for this test: another file on
    the same worker may have warned for the family already."""
    monkeypatch.setattr(sched_mod, "_FALLBACK_WARNED", set())
    monkeypatch.setattr(jax_sched_mod, "_FALLBACK_WARNED", set())


@pytest.mark.parametrize("arch", ARCHS)
def test_kernel_backend_downgrades_to_gathered(arch, fresh_warnings):
    """``cuda_paged`` asked for: the recurrent lanes cannot page, so both
    schedulers take ``gathered`` with the same warning and note, and keep
    the chunked prefill (the run itself is the gathered page 4 chunk 3
    case above; the launcher serves it end to end,
    ``tests/test_torch_serve_launch_flags.py``)."""
    engine, jengine, _ = engines(arch)
    kw = dict(kv_page_size=4, prefill_chunk=3)
    notes, jnotes = [], []
    with pytest.warns(RuntimeWarning, match="downgraded to the gathered"):
        js = JaxScheduler(jengine, attn_backend="pallas_paged",
                          emit=jnotes.append, **kw)
    with pytest.warns(RuntimeWarning, match="downgraded to the gathered") \
            as rec:
        sched = Scheduler(engine, attn_backend="cuda_paged",
                          emit=notes.append, **kw)
    family = engine.cfg.family
    assert [str(w.message) for w in rec] == [
        f"{family} arch downgraded to the gathered attention backend: "
        f"supports_paged_attention=False (no attention-style cache to "
        f"page)"]
    assert notes == jnotes == [
        f"note: {family} arch has no paged decode attention; falling back "
        f"to the gathered backend"]
    assert (sched.attn_backend, sched.prefill_chunk) == \
        (js.attn_backend, js.prefill_chunk) == ("gathered", 3)

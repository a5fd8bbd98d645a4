"""paligemma-3b's vision prefix and whisper-large-v3's encoder-decoder in
the port against the JAX reference, on the CPU, at the reduced widths of
``tests/test_models.py::REDUCED``, and the capability probes and
downgrades of mamba2-780m, recurrentgemma-2b, paligemma-3b and
whisper-large-v3.

* Model level, within 1e-4 (f32 several blocks deep; both packages differ
  in summation order only): ``cross_attn_apply`` computing its K/V and
  reusing cached ones, ``encode``, whisper's ``prefill`` and three
  ``decode_step``s over the cached self-attention KV and cross K/V, and
  paligemma's forward with vision embeddings (bidirectional prefix) and its
  prefill behind them with decode steps at ``prompt + 8`` onwards.
* Serving: ``tests/harness.py::MIXED`` with unit-scale MLPs gives the JAX
  ``Scheduler``'s tokens exactly: paligemma monolithic on ``cuda_paged``
  (the kernel's plain version here, one call a decode step and layer)
  against ``pallas_paged`` interpreted; whisper gathered monolithic.
* ``supports_chunked_prefill``, ``supports_paged_attention``,
  ``supports_speculation`` and ``supports_prefix_share`` give the
  reference's answers, and a scheduler asked for what an arch lacks
  downgrades it with the reference's warnings and notes.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

import repro.models.api as jax_api
from repro.models import attention as jattention
from repro.models import encdec as jencdec
from repro.models import transformer as jtransformer
from repro.runtime import scheduler as jax_sched_mod
from repro.runtime.scheduler import Scheduler as JaxScheduler
from repro.runtime.weight_store import WeightStore as JaxWeightStore
from repro_torch.models import api, attention, encdec, transformer
from repro_torch.runtime import Scheduler, WeightStore
from repro_torch.runtime import scheduler as sched_mod
from repro_torch.tree import tree_map_with_path
from tests.harness import assert_tokens_identical
from tests.test_torch_harness import (jax_params, jitted, reduced_jax,
                                      reduced_torch, torch_params)
from tests.test_torch_serve_gathered import (assert_nothing_leaked,
                                             make_engines, oracle,
                                             port_serve)

ATOL = RTOL = 1e-4
ARCHS = ("mamba2-780m", "recurrentgemma-2b", "paligemma-3b",
         "whisper-large-v3")


def J(a):
    return jnp.asarray(np.asarray(a))


def T(a):
    return torch.from_numpy(np.array(a))


def close(got, want):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), atol=ATOL,
                               rtol=RTOL)


def _embeds(b, rows, d, seed):
    return (np.random.default_rng(seed).standard_normal((b, rows, d))
            * 0.5).astype(np.float32)


@pytest.fixture(scope="module")
def whisper():
    jcfg, cfg = reduced_jax("whisper-large-v3"), \
        reduced_torch("whisper-large-v3")
    tree = jax_params(jcfg, seed=3)
    return jcfg, cfg, tree, torch_params(tree)


# ---------------------------------------------------------------------------
# model level
# ---------------------------------------------------------------------------

def test_cross_attention_equals_the_reference(whisper):
    jcfg, cfg, tree, params = whisper
    jp = jax.tree_util.tree_map(lambda a: a[0], tree["scan"]["b0"]["cross"])
    p = {k: v[0] for k, v in params["scan"]["b0"]["cross"].items()}
    x = _embeds(2, 5, cfg.d_model, 1)
    enc = _embeds(2, cfg.encoder_seq, cfg.d_model, 2)
    want, want_kv = jattention.cross_attn_apply(jp, J(x), jcfg,
                                                enc_out=J(enc))
    got, kv = attention.cross_attn_apply(p, T(x), cfg, enc_out=T(enc))
    close(got, want)
    for n in ("k", "v"):
        close(kv[n], want_kv[n])
    again, _ = attention.cross_attn_apply(p, T(x), cfg, enc_kv=kv)
    torch.testing.assert_close(again, got, rtol=0, atol=0)


def test_encoder_equals_the_reference(whisper):
    jcfg, cfg, tree, params = whisper
    fe = _embeds(2, cfg.encoder_seq, cfg.d_model, 4)
    close(encdec.encode(cfg, params, T(fe)),
          jencdec.encode(jcfg, tree, J(fe)))


def test_whisper_prefill_and_decode_equal_the_reference(whisper):
    """Prefill (the encoder once, cross K/V cached per layer), then three
    decode steps on the cached self-attention KV and cross K/V."""
    jcfg, cfg, tree, params = whisper
    fe = _embeds(2, cfg.encoder_seq, cfg.d_model, 5)
    toks = np.random.default_rng(6).integers(0, 128, (2, 7)).astype(np.int32)
    jcache = jencdec.init_cache(jcfg, 2, 16)
    cache = encdec.init_cache(cfg, 2, 16, "cpu")
    jprefill = jitted(jencdec.prefill, jcfg)
    jdecode = jitted(jencdec.decode_step, jcfg)
    want, jcache = jprefill(tree, J(toks), jcache, J(fe))
    with torch.no_grad():
        got, _ = encdec.prefill(cfg, params, T(toks), cache, T(fe))
    close(got, want)
    close(cache["scan"]["b0"]["cross"]["k"],
          jcache["scan"]["b0"]["cross"]["k"])
    nxt = np.argmax(np.asarray(want)[:, -1], -1).astype(np.int32)[:, None]
    for pos in range(7, 10):
        want, jcache = jdecode(tree, jcache, J(nxt), pos)
        with torch.no_grad():
            got, _ = encdec.decode_step(cfg, params, cache, T(nxt), pos)
        close(got, want)
        nxt = np.argmax(np.asarray(want)[:, -1], -1).astype(np.int32)[:, None]
    assert torch.equal(torch.tensor(tuple(cache["scan"]["b0"]["self"]["k"]
                                          .shape)),
                       torch.tensor(jcache["scan"]["b0"]["self"]["k"].shape))


def test_whisper_forward_equals_the_reference(whisper):
    jcfg, cfg, tree, params = whisper
    fe = _embeds(2, cfg.encoder_seq, cfg.d_model, 7)
    toks = np.random.default_rng(8).integers(0, 128, (2, 9)).astype(np.int32)
    want, _ = jencdec.forward(jcfg, tree, J(toks), J(fe))
    with torch.no_grad():
        got, aux = api.get_model(cfg).forward(cfg, params, T(toks), T(fe))
    close(got, want)
    assert float(aux) == 0.0


def test_paligemma_vision_prefix_equals_the_reference():
    """The forward over 8 vision rows + 12 text tokens (bidirectional
    prefix, text scaled by sqrt(d)), then prefill and decode at positions
    20, 21, 22 -- behind the vision rows."""
    jcfg, cfg = reduced_jax("paligemma-3b"), reduced_torch("paligemma-3b")
    tree = jax_params(jcfg, seed=4)
    params = torch_params(tree)
    ve = _embeds(2, cfg.num_vision_tokens, cfg.d_model, 9)
    toks = np.random.default_rng(10).integers(0, 128, (2, 12)).astype(
        np.int32)
    want, _ = jtransformer.forward(jcfg, tree, J(toks), vision_embeds=J(ve))
    with torch.no_grad():
        got, _ = transformer.forward(cfg, params, T(toks),
                                     vision_embeds=T(ve))
    assert got.shape == (2, 20, cfg.vocab_size)
    close(got, want)
    jcache = jtransformer.init_cache(jcfg, 2, 32)
    cache = transformer.init_cache(cfg, 2, 32, "cpu")
    want, jcache = jitted(jtransformer.prefill, jcfg)(
        tree, J(toks), jcache, vision_embeds=J(ve))
    jdecode = jitted(jtransformer.decode_step, jcfg)
    with torch.no_grad():
        got, _ = transformer.prefill(cfg, params, T(toks), cache,
                                     vision_embeds=T(ve))
    close(got, want)
    nxt = np.argmax(np.asarray(want)[:, -1], -1).astype(np.int32)[:, None]
    for pos in range(20, 23):
        want, jcache = jdecode(tree, jcache, J(nxt), pos)
        with torch.no_grad():
            got, _ = transformer.decode_step(cfg, params, cache, T(nxt), pos)
        close(got, want)
        nxt = np.argmax(np.asarray(want)[:, -1], -1).astype(np.int32)[:, None]


# ---------------------------------------------------------------------------
# serving
# ---------------------------------------------------------------------------

_ENGINES = {}


def engines(arch):
    if arch not in _ENGINES:
        _ENGINES[arch] = make_engines(arch)
    return _ENGINES[arch]


@pytest.fixture
def kernel_calls(monkeypatch):
    """Count the model's calls of the paged attention (its plain version
    on the CPU), and let the JAX kernel run interpreted."""
    monkeypatch.setattr(pltpu, "TPUCompilerParams", pltpu.CompilerParams,
                        raising=False)
    calls = []
    inner = attention.paged_mixed_attention

    def counted(*args, **kw):
        calls.append(args[0].shape)
        return inner(*args, **kw)

    monkeypatch.setattr(attention, "paged_mixed_attention", counted)
    return calls


def test_paligemma_kernel_backend_tokens_identical(kernel_calls):
    """Monolithic prefill behind 8 vision rows, installed into pages of 4
    (slots hold prompt + 8 + gen), then decode on the paged attention at
    Q=1: one call a decode step and layer, G = 4 query heads over 1 KV
    head."""
    engine, jengine, reqs = engines("paligemma-3b")
    kw = dict(attn_backend="pallas_paged", kv_page_size=4)
    want = oracle(jengine, reqs, **kw)
    kernel_calls.clear()
    got, sched = port_serve(engine, reqs, **{**kw,
                                             "attn_backend": "cuda_paged"})
    assert_tokens_identical(got, want, "paligemma cuda_paged")
    m, jm = engine.metrics, jengine.metrics
    assert (m.decode_steps, m.kv_prefill_gather_bytes, m.pages_total) == \
        (jm.decode_steps, jm.kv_prefill_gather_bytes, jm.pages_total)
    layers = engine.cfg.num_layers
    assert len(kernel_calls) == m.decode_steps * layers > 0
    assert {s[1:] for s in kernel_calls} == {(1, 4, 16)}
    assert sched._pool.slot_len >= max(len(p) for p, _ in reqs) + 8 + \
        max(g for _, g in reqs)
    assert_nothing_leaked(sched._pool)


def test_whisper_gathered_tokens_identical_to_the_reference():
    engine, jengine, reqs = engines("whisper-large-v3")
    kw = dict(attn_backend="gathered")
    want = oracle(jengine, reqs, **kw)
    got, sched = port_serve(engine, reqs, **kw)
    assert_tokens_identical(got, want, "whisper gathered")
    m, jm = engine.metrics, jengine.metrics
    assert (m.decode_steps, m.kv_gather_bytes, m.kv_prefill_gather_bytes) \
        == (jm.decode_steps, jm.kv_gather_bytes, jm.kv_prefill_gather_bytes)
    assert engine.compressed
    assert_nothing_leaked(sched._pool)


def test_params_and_store_selection_carry_across():
    """bf16 trees cross leaf for leaf with their dtypes (mamba2's
    ``A_log``/``D``/``dt_bias`` stay f32; whisper's ``enc_scan`` and
    ``cross`` subtrees arrive), and both packages' stores register the
    same MLP matrices: whisper's encoder and decoder ``up``/``down``, and
    none of mamba2's (a ``ValueError`` in both, served raw)."""
    for arch in ("mamba2-780m", "whisper-large-v3"):
        jcfg = reduced_jax(arch).scaled(dtype="bfloat16")
        tree = jax_params(jcfg)
        params = torch_params(tree)
        got = []
        tree_map_with_path(lambda n, a: got.append(
            (n, str(a.dtype).replace("torch.", ""), tuple(a.shape))), params)
        want = []
        tree_map_with_path(lambda n, a: want.append(
            (n, str(np.asarray(a).dtype), np.shape(a))), tree)
        assert got == want
        stores = (JaxWeightStore(), WeightStore())
        if arch == "mamba2-780m":
            assert params["scan"]["b0"]["mixer"]["A_log"].dtype == \
                torch.float32
            for store, p in zip(stores, (tree, params)):
                with pytest.raises(ValueError, match="no weights matched"):
                    store.register_model("lm", p)
            continue
        assert {"enc_scan", "cross"} <= {part for n, _, _ in got
                                         for part in n.split("/")}
        for store, p in zip(stores, (tree, params)):
            store.register_model("lm", p)
        assert sorted(stores[1].layers("lm")) == \
            sorted(stores[0].layers("lm")) == [
                "enc_scan/b0/mlp/down", "enc_scan/b0/mlp/up",
                "scan/b0/mlp/down", "scan/b0/mlp/up"]


# ---------------------------------------------------------------------------
# capabilities and downgrades
# ---------------------------------------------------------------------------

PROBES = ("supports_chunked_prefill", "supports_paged_attention",
          "supports_speculation", "supports_prefix_share")


@pytest.mark.parametrize("arch", ARCHS)
def test_capability_probes_answer_as_the_reference(arch):
    jcfg, cfg = reduced_jax(arch), reduced_torch(arch)
    got = [getattr(api, n)(cfg) for n in PROBES]
    assert got == [getattr(jax_api, n)(jcfg) for n in PROBES]
    m, jm = api.get_model(cfg), jax_api.get_model(jcfg)
    for n in ("prefill_chunk", "mixed_step", "verify_step"):
        assert (getattr(m, n) is None) == (getattr(jm, n) is None), n


@pytest.fixture
def fresh_warnings(monkeypatch):
    """Each package's warn-once set emptied for this test: another file on
    the same worker may have warned for the family already."""
    monkeypatch.setattr(sched_mod, "_FALLBACK_WARNED", set())
    monkeypatch.setattr(jax_sched_mod, "_FALLBACK_WARNED", set())


# every capability asked for at once: page 4, chunks of 3, n-gram drafts,
# prefix sharing, the kernel backend
ASK = dict(kv_page_size=4, prefill_chunk=3, speculate="ngram",
           prefix_share=True)


@pytest.mark.parametrize("arch", ARCHS)
def test_downgrades_warn_and_note_as_the_reference(arch, fresh_warnings):
    engine, jengine, _ = engines(arch)
    with pytest.warns(RuntimeWarning) as jrec:
        jnotes = []
        js = JaxScheduler(jengine, attn_backend="pallas_paged",
                          emit=jnotes.append, **ASK)
    with pytest.warns(RuntimeWarning) as rec:
        notes = []
        s = Scheduler(engine, attn_backend="cuda_paged", emit=notes.append,
                      **ASK)
    assert [str(w.message) for w in rec] == \
        [str(w.message) for w in jrec] != []
    assert notes == jnotes
    assert (s.attn_backend, s.prefill_chunk, s.speculate, s.prefix_share) \
        == (js.attn_backend.replace("pallas_paged", "cuda_paged"),
            js.prefill_chunk, js.speculate, js.prefix_share)
    family = engine.cfg.family
    if family in ("vlm", "audio"):
        assert s.prefill_chunk is None
    assert (s.attn_backend == "gathered") == (family != "vlm")
    assert not s.prefix_share

"""phi3-medium-14b, h2o-danube-1.8b, gemma2-2b and mixtral-8x22b, and
mamba2-780m, recurrentgemma-2b, paligemma-3b and whisper-large-v3, in the
port against the JAX reference, on the CPU.

* Each port config equals the reference's field for field.
* Block kinds map to attention variants as in the reference: an
  ``swa_moe`` block (mixtral) attends and caches with its window, and
  ``block_cache_spec`` gives ``swa_moe`` and ``attn_local`` the
  reference's rolling shapes.
* gemma2's blocks (``local``/``global`` with sandwich norms, attention
  softcap) and every arch's scoring forward equal the reference's
  (paligemma behind vision embeddings, whisper over frame embeddings), and
  every arch's ``init_params`` has the reference's tree.
* The launcher's ``--scale tiny`` config is the reference's (gemma2: one
  ``local`` + ``global`` repeat), and mixtral needs a depth cut.

Params come from the JAX ``init_params`` through numpy.  Stated
tolerances: a block's f32 output and cache within ``ATOL``/``RTOL`` 1e-5,
a forward's f32 logits (several blocks deep) within 1e-4; both packages
compute in f32 and differ in summation order only.
"""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import get_config as get_jax_config
from repro.launch.train import tiny_config as jax_tiny_config
from repro.models import transformer as jtransformer
from repro.models.api import get_model as jax_get_model
from repro_torch.configs.base import get_config
from repro_torch.launch import serve as serve_launch
from repro_torch.models import transformer
from repro_torch.models.api import get_model
from repro_torch.tree import tree_leaves, tree_map, tree_map_with_path
from tests.test_torch_harness import (jax_params, jitted, reduced_jax,
                                      reduced_torch, torch_params)

ARCHS = ("phi3-medium-14b", "h2o-danube-1.8b", "gemma2-2b", "mixtral-8x22b",
         "mamba2-780m", "recurrentgemma-2b", "paligemma-3b",
         "whisper-large-v3")
ATOL = RTOL = 1e-5


def J(a):
    return jnp.asarray(np.asarray(a))


def T(a):
    return torch.from_numpy(np.array(a))


def close(got, want):
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL,
                               rtol=RTOL)


@pytest.mark.parametrize("arch", ARCHS)
def test_config_equals_the_reference(arch):
    assert dataclasses.asdict(get_config(arch)) == \
        dataclasses.asdict(get_jax_config(arch))


@pytest.mark.parametrize("arch", ARCHS)
def test_tiny_config_equals_the_reference(arch):
    assert dataclasses.asdict(serve_launch.tiny_config(arch)) == \
        dataclasses.asdict(jax_tiny_config(arch))


def test_gemma2_tiny_config_has_one_local_global_repeat():
    cfg = serve_launch.tiny_config("gemma2-2b")
    assert (cfg.scan_pattern, cfg.scan_repeats, cfg.num_layers,
            cfg.window) == (("local", "global"), 1, 2, 64)


def test_mixtral_full_depth_needs_a_layer_cut():
    with pytest.raises(ValueError, match="does not fit one card"):
        serve_launch.full_config("mixtral-8x22b")
    cfg = serve_launch.full_config("mixtral-8x22b", 2)
    assert (cfg.num_layers, cfg.scan_repeats, cfg.d_model, cfg.num_heads,
            cfg.num_kv_heads, cfg.num_experts, cfg.top_k) == \
        (2, 2, 6144, 48, 8, 8, 2)
    for arch in ("phi3-medium-14b", "h2o-danube-1.8b", "gemma2-2b"):
        assert serve_launch.full_config(arch) == get_config(arch)


def test_recurrent_and_multimodal_depth_cuts():
    """The chip's cuts keep the published widths: recurrentgemma as one
    (rglru, rglru, attn_local) repeat and its two suffix rglru blocks,
    whisper with as many encoder as decoder layers, mamba2 whole."""
    rg = serve_launch.full_config("recurrentgemma-2b", 5)
    assert (rg.scan_repeats, rg.suffix_kinds, rg.d_model, rg.lru_width,
            rg.d_ff) == (1, ("rglru", "rglru"), 2560, 2560, 7680)
    wh = serve_launch.full_config("whisper-large-v3", 2)
    assert (wh.num_layers, wh.scan_repeats, wh.encoder_layers,
            wh.encoder_seq, wh.d_model) == (2, 2, 2, 1536, 1280)
    pg = serve_launch.full_config("paligemma-3b", 2)
    assert (pg.scan_repeats, pg.num_vision_tokens, pg.d_ff) == \
        (2, 256, 16384)
    assert serve_launch.full_config("mamba2-780m") == \
        get_config("mamba2-780m")
    with pytest.raises(ValueError, match="cannot cut"):
        serve_launch.full_config("recurrentgemma-2b", 4)


def _block(arch, i, seed=1):
    """Block ``b{i}`` of the reduced arch's first scan repeat, in both
    packages."""
    jcfg, cfg = reduced_jax(arch), reduced_torch(arch)
    tree = jax_params(jcfg, seed=seed)
    p = jax.tree_util.tree_map(lambda a: a[0], tree["scan"][f"b{i}"])
    return jcfg, cfg, p, torch_params(p)


def _block_case(arch, i, kind, s=20):
    """One block over an ``s``-token input, in both packages: without a
    cache, and filling a lane cache of 32 positions (a rolling window's
    ``window`` rows)."""
    jcfg, cfg, jp, p = _block(arch, i)
    x = np.random.default_rng(5).standard_normal(
        (2, s, cfg.d_model)).astype(np.float32)
    jblock = jax.jit(functools.partial(jtransformer.block_apply, kind, jcfg))
    want, _, _ = jblock(jp, J(x))
    with torch.no_grad():
        got, _ = transformer.block_apply(kind, cfg, p, T(x))
    close(got, want)
    jcache = jtransformer.init_cache(jcfg, 2, 32)["scan"][f"b{i}"]
    jcache = jax.tree_util.tree_map(lambda a: a[0], jcache)
    want, want_cache, _ = jblock(jp, J(x), cache=jcache)
    cache = tree_map(lambda a: a[0], transformer.init_cache(
        cfg, 2, 32, "cpu")["scan"][f"b{i}"])
    with torch.no_grad():
        got, _ = transformer.block_apply(kind, cfg, p, T(x), cache=cache)
    close(got, want)
    for name in ("k", "v"):
        assert cache[name].shape == want_cache[name].shape
        close(cache[name], want_cache[name])
    return cfg


def test_swa_moe_block_attends_with_its_window():
    """Reduced mixtral (window 16), a 20-token input: the block equals the
    reference's, so its attention saw the window, and its cache keeps the
    last 16 keys rolled to ``p % 16``."""
    cfg = _block_case("mixtral-8x22b", 0, "swa_moe")
    assert cfg.window == 16


@pytest.mark.parametrize("kind", ["swa_moe", "attn_local", "local", "swa",
                                  "global", "attn"])
def test_block_cache_spec_maps_kinds_as_the_reference(kind):
    jcfg, cfg = reduced_jax("mixtral-8x22b"), reduced_torch("mixtral-8x22b")
    want = jtransformer.block_cache_spec(kind, jcfg, 3, 40)
    got = transformer.block_cache_spec(kind, cfg, 3, 40)
    assert {n: tuple(t.shape) for n, t in got.items()} == \
        {n: tuple(t.shape) for n, t in want.items()}
    rolling = kind in ("swa_moe", "attn_local", "local", "swa")
    assert got["k"].shape[1] == (cfg.window if rolling else 40)


@pytest.mark.parametrize("i,kind", [(0, "local"), (1, "global")])
def test_gemma2_block_equals_the_reference(i, kind):
    """Sandwich norms (nonzero gains, so ``post_ln1``/``post_ln2`` act),
    the attention softcap, GeGLU; ``local`` with its window of 16."""
    jcfg, cfg, jp, p = _block("gemma2-2b", i)
    assert set(p) == {"ln1", "attn", "ln2", "mlp", "post_ln1", "post_ln2"}
    rng = np.random.default_rng(6)
    for name in ("ln1", "ln2", "post_ln1", "post_ln2"):
        jp[name] = rng.standard_normal(jp[name].shape).astype(np.float32)
        p[name] = T(jp[name])
    x = rng.standard_normal((2, 20, cfg.d_model)).astype(np.float32)
    want, _, _ = jtransformer.block_apply(kind, jcfg, jp, J(x))
    with torch.no_grad():
        got, _ = transformer.block_apply(kind, cfg, p, T(x))
    close(got, want)
    _block_case("gemma2-2b", i, kind)


@pytest.mark.parametrize("arch", ARCHS)
def test_forward_logits_equal_the_reference(arch):
    """The scoring forward over a 24-token input: embedding scale and final
    softcap (gemma2), windows past their length (danube, gemma2, mixtral,
    recurrentgemma's ``attn_local``), MoE without drops (mixtral at
    capacity factor 8), the SSD scan over two chunks (mamba2), the RG-LRU
    scan, paligemma's 8 vision rows before the text, whisper's encoder and
    cross-attention."""
    jcfg, cfg = reduced_jax(arch), reduced_torch(arch)
    tree = jax_params(jcfg, seed=2)
    rng = np.random.default_rng(7)
    toks = rng.integers(0, 128, (2, 24)).astype(np.int32)
    args, kw = (), {}
    rows = {"vlm": cfg.num_vision_tokens,
            "audio": cfg.encoder_seq}.get(cfg.family)
    if rows:
        emb = (rng.standard_normal((2, rows, cfg.d_model)) * 0.02).astype(
            np.float32)
        args, kw = ((emb,), {}) if cfg.family == "audio" else \
            ((), {"vision_embeds": emb})
    want, _ = jitted(jax_get_model(jcfg).forward, jcfg)(
        tree, J(toks), *map(J, args), **{k: J(v) for k, v in kw.items()})
    with torch.no_grad():
        got, _ = get_model(cfg).forward(
            cfg, torch_params(tree), T(toks), *map(T, args),
            **{k: T(v) for k, v in kw.items()})
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-4,
                               rtol=1e-4)


@pytest.mark.parametrize("arch", ARCHS)
def test_init_params_has_the_reference_tree(arch):
    cfg = reduced_torch(arch)
    got = get_model(cfg).init_params(cfg, torch.Generator().manual_seed(0),
                                     "cpu")
    want = jax_params(reduced_jax(arch))
    shapes = lambda t: [tuple(a.shape) for a in jax.tree_util.tree_leaves(
        jax.tree_util.tree_map(np.asarray, t))]
    assert tree_map_with_path(lambda n, _: n, got) == \
        tree_map_with_path(lambda n, _: n, torch_params(want))
    assert [tuple(a.shape) for a in tree_leaves(got)] == shapes(want)

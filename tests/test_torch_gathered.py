"""The port's lane attention and lane step functions against the JAX
reference, on the CPU.

Same numpy-seeded inputs through both packages, f32, compared with
``ATOL``/``RTOL`` (1e-5 / 1e-5: both compute in f32 and differ in
summation order only; caches, which are copies and codec round trips,
are compared bit for bit):

* ``flash_attention`` (q blocks of every size that divides the prompt,
  window, softcap, prefix-LM, non-causal), ``decode_attention`` (shared
  and per-lane positions, window, rolling lanes, softcap) and
  ``chunk_attention`` (ragged ``q_lens``, per-lane positions, rolling
  slot positions, window, softcap), and the lane helpers
  ``_rolling_slot_positions``, ``_lane_chunk_write`` and
  ``_codec_roundtrip``;
* ``attn_apply``'s three lane branches (monolithic prefill into the
  cache, rolled when the window is shorter than the prompt; decode; the
  chunk with write-after-attend) for kinds ``attn`` and ``swa``, with and
  without ``kv_quant``; ``mla_apply``'s prefill and absorbed decode and
  chunk (ragged too), and per-lane positions against a loop over lanes;
* ``transformer.prefill``/``prefill_chunk``/``decode_step``/``forward``
  logits for minitron and deepseek, with and without ``kv_quant``, and
  ``decode_step(per_lane=True)`` against the reference's vmap over lanes
  at MoE capacity factor 1.25 (the lanes share no capacity);
* ``paged_decode_attention``'s plain path against
  ``paged_mixed_attention_plain`` at Q=1 and against the JAX wrapper in
  interpret mode, page 0 poisoned.
"""

import jax
import jax.experimental.pallas.tpu as pltpu
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import kv_codec as jkv
from repro.kernels import paged_attention as jpa
from repro.models import attention as jattn
from repro.models import transformer as jtransformer
from repro_torch.kernels.paged_attention import (paged_decode_attention,
                                                 paged_mixed_attention_plain)
from repro_torch.models import attention as attn
from repro_torch.models import transformer
from repro_torch.tree import tree_leaves, tree_map
from tests.test_torch_harness import (jax_params, jitted, reduced_jax,
                                      reduced_torch, torch_params)

ATOL, RTOL = 1e-5, 1e-5
T = torch.from_numpy
J = jnp.asarray


def close(got, want):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), atol=ATOL,
                               rtol=RTOL)


def normal(rng, *shape):
    return rng.standard_normal(shape).astype(np.float32)


# ---------------------------------------------------------------------------
# flash / decode / chunk attention
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("q_chunk", [4096, 4, 3])
@pytest.mark.parametrize("window,cap", [(0, 0.0), (5, 0.0), (0, 2.0),
                                        (4, 3.0)])
def test_flash_attention(q_chunk, window, cap):
    rng = np.random.default_rng(1)
    q, k, v = normal(rng, 2, 12, 4, 8), normal(rng, 2, 12, 2, 8), \
        normal(rng, 2, 12, 2, 6)
    kw = dict(window=window, attn_softcap=cap, q_chunk=q_chunk)
    close(attn.flash_attention(T(q), T(k), T(v), **kw),
          jattn.flash_attention(J(q), J(k), J(v), **kw))


@pytest.mark.parametrize("kw", [dict(prefix_len=5), dict(causal=False),
                                dict(q_offset=3, window=4)])
def test_flash_attention_masks(kw):
    rng = np.random.default_rng(2)
    q, k, v = normal(rng, 1, 8, 4, 8), normal(rng, 1, 11, 4, 8), \
        normal(rng, 1, 11, 4, 8)
    close(attn.flash_attention(T(q), T(k), T(v), **kw),
          jattn.flash_attention(J(q), J(k), J(v), **kw))


def test_flash_attention_bf16_keeps_the_reference_roundings():
    """bf16 operands: q scaled in bf16, products accumulated in f32,
    probabilities cast to bf16 before the value product."""
    rng = np.random.default_rng(3)
    q, k, v = (normal(rng, 1, 8, 4, 16) for _ in range(3))
    tq, tk, tv = (T(a).to(torch.bfloat16) for a in (q, k, v))
    jq, jk, jv = (J(a).astype(jnp.bfloat16) for a in (q, k, v))
    got = attn.flash_attention(tq, tk, tv)
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(),
                               np.asarray(jattn.flash_attention(jq, jk, jv)),
                               atol=1e-2, rtol=0)


@pytest.mark.parametrize("pos", [6, [2, 9, 0]])
@pytest.mark.parametrize("window,rolling,cap", [(0, False, 0.0),
                                                (4, False, 0.0),
                                                (0, True, 0.0),
                                                (0, False, 2.5)])
def test_decode_attention(pos, window, rolling, cap):
    rng = np.random.default_rng(4)
    q, kc, vc = normal(rng, 3, 1, 4, 8), normal(rng, 3, 10, 2, 8), \
        normal(rng, 3, 10, 2, 8)
    kw = dict(window=window, attn_softcap=cap, rolling=rolling)
    close(attn.decode_attention(T(q), T(kc), T(vc), torch.tensor(pos), **kw),
          jattn.decode_attention(J(q), J(kc), J(vc), J(pos), **kw))


@pytest.mark.parametrize("case", ["shared", "per_lane_ragged", "rolling"])
@pytest.mark.parametrize("window,cap", [(0, 0.0), (3, 0.0), (0, 2.0)])
def test_chunk_attention(case, window, cap):
    rng = np.random.default_rng(5)
    b, s, p = 2, 4, 6
    q, k, v = normal(rng, b, s, 4, 8), normal(rng, b, s, 2, 8), \
        normal(rng, b, s, 2, 8)
    kp, vp = normal(rng, b, p, 2, 8), normal(rng, b, p, 2, 8)
    q_lens = None
    if case == "shared":
        q_pos = np.arange(3, 3 + s)
        k_pos = np.where(np.arange(p) < 3, np.arange(p), -1)
    elif case == "per_lane_ragged":
        start = np.array([1, 5])
        q_pos = start[:, None] + np.arange(s)
        k_pos = np.where(np.arange(p) < start[:, None], np.arange(p), -1)
        q_lens = np.array([4, 2], np.int32)
    else:
        start = np.array([8, 2])
        q_pos = start[:, None] + np.arange(s)
        k_pos = np.array(jattn._rolling_slot_positions(J(start), p))
    kw = dict(window=window, attn_softcap=cap)
    got = attn.chunk_attention(
        T(q), T(k), T(v), T(kp), T(vp), T(q_pos), T(k_pos),
        q_lens=None if q_lens is None else T(q_lens), **kw)
    want = jattn.chunk_attention(
        J(q), J(k), J(v), J(kp), J(vp), J(q_pos), J(k_pos),
        q_lens=None if q_lens is None else J(q_lens), **kw)
    rows = np.arange(s)[None] < (np.full(b, s) if q_lens is None
                                 else q_lens)[:, None]
    close(got.numpy()[rows], np.asarray(want)[rows])


@pytest.mark.parametrize("pos", [0, 3, 7, 20, [0, 5, 13]])
def test_rolling_slot_positions(pos):
    np.testing.assert_array_equal(
        attn._rolling_slot_positions(torch.tensor(pos), 6).numpy(),
        np.asarray(jattn._rolling_slot_positions(J(pos), 6)))


@pytest.mark.parametrize("rolling", [False, True])
@pytest.mark.parametrize("pos,q_lens", [(2, None), ([0, 9], [5, 3]),
                                        ([4, 1], [0, 5])])
def test_lane_chunk_write(rolling, pos, q_lens):
    rng = np.random.default_rng(6)
    smax = 4 if rolling else 16
    cache, new = normal(rng, 2, smax, 2, 3), normal(rng, 2, 5, 2, 3)
    ql = None if q_lens is None else np.asarray(q_lens, np.int32)
    got = attn._lane_chunk_write(
        T(cache.copy()), T(new), torch.tensor(pos),
        None if ql is None else T(ql), rolling=rolling)
    want = jattn._lane_chunk_write(J(cache), J(new), J(pos),
                                   None if ql is None else J(ql),
                                   rolling=rolling)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("axes", [(-2, -1), (-1,)])
def test_codec_roundtrip_bit_identical(axes):
    x = normal(np.random.default_rng(7), 2, 5, 3, 8) * 3
    got = attn._codec_roundtrip(T(x), axes).numpy()
    assert got.tobytes() == np.asarray(jattn._codec_roundtrip(J(x), axes)) \
        .tobytes()
    # the encode is idempotent, so a second round trip changes nothing
    assert attn._codec_roundtrip(T(got), axes).numpy().tobytes() == \
        got.tobytes()


# ---------------------------------------------------------------------------
# attn_apply / mla_apply lane branches
# ---------------------------------------------------------------------------


def _layer(arch, **over):
    """One attention layer's params in both packages and the configs."""
    jcfg, cfg = reduced_jax(arch).scaled(**over), \
        reduced_torch(arch).scaled(**over)
    tree = jax_params(jcfg, seed=2)
    blk = jax.tree_util.tree_map(lambda a: a[0], tree["scan"]["b0"]["attn"])
    return jcfg, cfg, blk, torch_params(blk)


def _cache(rng, b, smax, names, widths):
    return {n: normal(rng, b, smax, *w) for n, w in zip(names, widths)}


def _same_cache(got, want):
    for name in want:
        np.testing.assert_array_equal(got[name].numpy(),
                                      np.asarray(want[name]))


KINDS = [("attn", {}), ("swa", dict(window=6)),
         ("attn", dict(attn_logit_softcap=3.0))]


@pytest.mark.parametrize("kind,over", KINDS)
def test_attn_apply_prefill_fills_the_cache(kind, over):
    jcfg, cfg, jp, p = _layer("minitron-8b", **over)
    x = normal(np.random.default_rng(8), 2, 10, jcfg.d_model)
    zeros = np.zeros((2, 16 if kind == "attn" else 6, 2, 16), np.float32)
    jy, jc = jattn.attn_apply(jp, J(x), jcfg, kind=kind,
                              cache={"k": J(zeros), "v": J(zeros)})
    cache = {"k": T(zeros.copy()), "v": T(zeros.copy())}
    y, c = attn.attn_apply(p, T(x), cfg, kind=kind, cache=cache)
    close(y, jy)
    for name in ("k", "v"):     # rows are copies of K/V computed alike
        close(c[name], jc[name])
    # no cache: the scoring forward
    close(attn.attn_apply(p, T(x), cfg, kind=kind)[0],
          jattn.attn_apply(jp, J(x), jcfg, kind=kind)[0])


@pytest.mark.parametrize("kv_quant", [False, True])
@pytest.mark.parametrize("pos", [7, [3, 11]])
@pytest.mark.parametrize("kind,over", KINDS)
def test_attn_apply_decode(kind, over, pos, kv_quant):
    jcfg, cfg, jp, p = _layer("minitron-8b", **over)
    rng = np.random.default_rng(9)
    x = normal(rng, 2, 1, jcfg.d_model)
    smax = 16 if kind == "attn" else 6
    c0 = _cache(rng, 2, smax, ("k", "v"), ((2, 16), (2, 16)))
    jy, jc = jattn.attn_apply(jp, J(x), jcfg, kind=kind,
                              cache={n: J(a) for n, a in c0.items()},
                              pos=J(pos), kv_quant=kv_quant)
    y, c = attn.attn_apply(p, T(x), cfg, kind=kind,
                           cache={n: T(a.copy()) for n, a in c0.items()},
                           pos=torch.tensor(pos), kv_quant=kv_quant)
    close(y, jy)
    for name in ("k", "v"):
        close(c[name], jc[name])


@pytest.mark.parametrize("kv_quant", [False, True])
@pytest.mark.parametrize("pos,q_lens", [(4, None), ([2, 9], [4, 1])])
@pytest.mark.parametrize("kind,over", KINDS)
def test_attn_apply_chunk(kind, over, pos, q_lens, kv_quant):
    jcfg, cfg, jp, p = _layer("minitron-8b", **over)
    rng = np.random.default_rng(10)
    x = normal(rng, 2, 4, jcfg.d_model)
    smax = 16 if kind == "attn" else 6
    c0 = _cache(rng, 2, smax, ("k", "v"), ((2, 16), (2, 16)))
    ql = None if q_lens is None else np.asarray(q_lens, np.int32)
    jy, jc = jattn.attn_apply(jp, J(x), jcfg, kind=kind,
                              cache={n: J(a) for n, a in c0.items()},
                              pos=J(pos), kv_quant=kv_quant,
                              q_lens=None if ql is None else J(ql))
    y, c = attn.attn_apply(p, T(x), cfg, kind=kind,
                           cache={n: T(a.copy()) for n, a in c0.items()},
                           pos=torch.tensor(pos), kv_quant=kv_quant,
                           q_lens=None if ql is None else T(ql))
    rows = np.arange(4)[None] < (np.full(2, 4) if ql is None else ql)[:, None]
    close(y.numpy()[rows], np.asarray(jy)[rows])
    for name in ("k", "v"):
        close(c[name], jc[name])


MLA_WIDTHS = (("c_kv", "k_pe"), ((16,), (8,)))


def test_mla_apply_prefill_fills_the_cache():
    jcfg, cfg, jp, p = _layer("deepseek-v2-236b")
    x = normal(np.random.default_rng(11), 2, 9, jcfg.d_model)
    zeros = {"c_kv": np.zeros((2, 12, 16), np.float32),
             "k_pe": np.zeros((2, 12, 8), np.float32)}
    jy, jc = jattn.mla_apply(jp, J(x), jcfg,
                             cache={n: J(a) for n, a in zeros.items()})
    y, c = attn.mla_apply(p, T(x), cfg,
                          cache={n: T(a.copy()) for n, a in zeros.items()})
    close(y, jy)
    for name in zeros:
        close(c[name], jc[name])
    close(attn.mla_apply(p, T(x), cfg)[0], jattn.mla_apply(jp, J(x), jcfg)[0])


@pytest.mark.parametrize("kv_quant", [False, True])
@pytest.mark.parametrize("s,q_lens", [(1, None), (3, None), (3, [3, 1])])
def test_mla_apply_absorbed_decode_and_chunk(s, q_lens, kv_quant):
    jcfg, cfg, jp, p = _layer("deepseek-v2-236b")
    rng = np.random.default_rng(12)
    x = normal(rng, 2, s, jcfg.d_model)
    c0 = _cache(rng, 2, 12, *MLA_WIDTHS)
    ql = None if q_lens is None else np.asarray(q_lens, np.int32)
    jy, jc = jattn.mla_apply(jp, J(x), jcfg,
                             cache={n: J(a) for n, a in c0.items()}, pos=5,
                             kv_quant=kv_quant,
                             q_lens=None if ql is None else J(ql))
    y, c = attn.mla_apply(p, T(x), cfg,
                          cache={n: T(a.copy()) for n, a in c0.items()},
                          pos=5, kv_quant=kv_quant,
                          q_lens=None if ql is None else T(ql))
    rows = np.arange(s)[None] < (np.full(2, s) if ql is None else ql)[:, None]
    close(y.numpy()[rows], np.asarray(jy)[rows])
    for name in c0:
        close(c[name], jc[name])


@pytest.mark.parametrize("s", [1, 2])
def test_mla_apply_per_lane_positions_are_a_loop_over_lanes(s):
    """The reference decodes MLA lanes one at a time (a vmap over slots,
    each at its own scalar position); the port takes ``(B,)`` positions
    in one call."""
    jcfg, cfg, jp, p = _layer("deepseek-v2-236b")
    rng = np.random.default_rng(13)
    x = normal(rng, 3, s, jcfg.d_model)
    c0 = _cache(rng, 3, 12, *MLA_WIDTHS)
    pos = [2, 9, 0]
    y, c = attn.mla_apply(p, T(x), cfg,
                          cache={n: T(a.copy()) for n, a in c0.items()},
                          pos=torch.tensor(pos), kv_quant=True)
    for i, pi in enumerate(pos):
        jy, jc = jattn.mla_apply(
            jp, J(x[i:i + 1]), jcfg,
            cache={n: J(a[i:i + 1]) for n, a in c0.items()}, pos=pi,
            kv_quant=True)
        close(y[i:i + 1], jy)
        for name in c0:
            close(c[name][i:i + 1], jc[name])


# ---------------------------------------------------------------------------
# transformer step functions
# ---------------------------------------------------------------------------

ARCHS = ["minitron-8b", "deepseek-v2-236b"]


@pytest.mark.parametrize("kv_quant", [False, True])
@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_decode_and_chunk_logits(arch, kv_quant):
    jcfg, cfg = reduced_jax(arch), reduced_torch(arch)
    tree = jax_params(jcfg, seed=1)
    params = torch_params(tree)
    toks = np.random.default_rng(14).integers(0, 128, (1, 9)).astype(
        np.int32)
    jc = jtransformer.init_cache(jcfg, 1, 16)
    jl, jc = jitted(jtransformer.prefill, jcfg)(tree, J(toks), jc)
    jdecode = jitted(jtransformer.decode_step, jcfg, kv_quant=kv_quant)
    jchunk = jitted(jtransformer.prefill_chunk, jcfg, kv_quant=kv_quant)
    c = transformer.init_cache(cfg, 1, 16, "cpu")
    with torch.no_grad():
        l, c = transformer.prefill(cfg, params, T(toks), c)
        close(l, jl)
        for i in range(3):
            t = np.array([[i + 3]], np.int32)
            jl, jc = jdecode(tree, jc, J(t), 9 + i)
            l, c = transformer.decode_step(cfg, params, c, T(t), 9 + i,
                                           kv_quant=kv_quant)
            close(l, jl)
        jc = jtransformer.init_cache(jcfg, 1, 16)
        c = transformer.init_cache(cfg, 1, 16, "cpu")
        for st in (0, 4, 8):
            ch = toks[:, st:st + 4]
            jl, jc = jchunk(tree, jc, J(ch), st)
            l, c = transformer.prefill_chunk(cfg, params, c, T(ch), st,
                                             kv_quant=kv_quant)
            close(l, jl)
    for got, want in zip(tree_leaves(c),
                         jax.tree_util.tree_leaves(jc)):
        close(got, want)


@pytest.mark.parametrize("arch", ARCHS)
def test_forward_and_backbone(arch):
    jcfg, cfg = reduced_jax(arch), reduced_torch(arch)
    tree = jax_params(jcfg, seed=3)
    toks = np.random.default_rng(15).integers(0, 128, (2, 7)).astype(
        np.int32)
    with torch.no_grad():
        logits, aux = transformer.forward(cfg, torch_params(tree), T(toks))
    jlogits, jaux = jtransformer.forward(jcfg, tree, J(toks))
    close(logits, jlogits)
    close(aux, jaux)


def test_per_lane_decode_is_the_reference_vmap_over_lanes():
    """Six deepseek lanes at capacity factor 1.25, each at its own
    position: ``per_lane`` decodes them as the reference's vmap over
    slots does (one batch-1 sequence a lane), so no lane's tokens take
    another's expert capacity."""
    over = dict(capacity_factor=1.25)
    jcfg = reduced_jax("deepseek-v2-236b").scaled(**over)
    cfg = reduced_torch("deepseek-v2-236b").scaled(**over)
    tree = jax_params(jcfg, seed=4)
    rng = np.random.default_rng(16)
    n = 6
    cache0 = jax.tree_util.tree_map(
        lambda s: rng.standard_normal((n, *s.shape)).astype(np.float32),
        jtransformer.init_cache_specs(jcfg, 1, 16))
    toks = rng.integers(0, 128, (n, 1, 1)).astype(np.int32)
    pos = np.array([3, 9, 0, 15, 7, 7], np.int32)
    jtree = jax.tree_util.tree_map(J, tree)
    step = jax.vmap(lambda c, t, q: jtransformer.decode_step(
        jcfg, jtree, c, t, q), in_axes=(0, 0, 0))
    jl, jc = step(jax.tree_util.tree_map(J, cache0), J(toks), J(pos))
    def as_batch(a):
        """(n, *lane leaf) -> the lane axis where the batch axis sits (MLA
        leaves: batch axis 0, or 1 behind the repeats axis)."""
        bax = a.ndim - 4
        return np.moveaxis(np.asarray(a).squeeze(bax + 1), 0, bax)

    lanes = tree_map(lambda a: T(as_batch(a)), cache0)
    with torch.no_grad():
        logits, lanes = transformer.decode_step(
            cfg, torch_params(tree), lanes, T(toks[:, 0]), T(pos),
            per_lane=True)
    close(logits, np.asarray(jl)[:, 0])
    for got, want in zip(tree_leaves(lanes),
                         jax.tree_util.tree_leaves(jc)):
        close(got, as_batch(want))


# ---------------------------------------------------------------------------
# paged_decode_attention (Q = 1)
# ---------------------------------------------------------------------------


def _decode_case(case):
    rng = np.random.default_rng(17)
    s_n, page, pps = 3, 4, 4
    mla = case.startswith("mla")
    h, kh, d = (4, 1, 16) if mla else (4, 2, 16)
    n_pages = s_n * pps + 1
    lengths = np.array([5, 16, 1], np.int32)
    table = np.zeros((s_n, pps), np.int32)
    ids = iter(rng.permutation(np.arange(1, n_pages)))
    for s, ln in enumerate(lengths):
        for j in range(-(-ln // page)):
            table[s, j] = next(ids)
    k = normal(rng, n_pages, page, kh, d)
    v = k if mla else normal(rng, n_pages, page, kh, d)
    k[0] = v[0] = 1e4                              # poisoned dummy sink
    args = dict(q=normal(rng, s_n, h, d), k_pages=k, v_pages=v, table=table,
                lengths=lengths)
    kw = dict(page_size=page)
    if mla:
        args.update(q2=normal(rng, s_n, h, 8),
                    k2_pages=normal(rng, n_pages, page, 1, 8))
        args["k2_pages"][0] = 1e4
        kw["scale"] = 0.2
    if case.endswith("window_softcap"):
        kw.update(window=3, softcap_val=2.0)
    if case.endswith("codec"):
        for name in ("k_pages", "v_pages", "k2_pages"):
            if name in args:
                codes, sc = jkv.encode(J(args[name]), (-2, -1))
                args[name] = np.array(codes)
                args[name.replace("pages", "scales")] = np.array(sc)
        args["codebook"] = np.array(jkv.codebook())
    return args, kw


@pytest.mark.parametrize("case", ["gqa", "gqa_window_softcap", "gqa_codec",
                                  "mla", "mla_codec"])
def test_paged_decode_attention_plain(case, monkeypatch):
    args, kw = _decode_case(case)
    targs = {n: T(a) for n, a in args.items()}
    got = paged_decode_attention(**targs, **kw)
    lengths = targs["lengths"]
    q_lens = torch.ones_like(lengths)
    plain = paged_mixed_attention_plain(
        targs["q"][:, None], targs["k_pages"], targs["v_pages"],
        targs["table"], lengths, q_lens, targs.get("k_scales"),
        targs.get("v_scales"), targs.get("codebook"),
        q2=None if "q2" not in targs else targs["q2"][:, None],
        k2_pages=targs.get("k2_pages"), k2_scales=targs.get("k2_scales"),
        **kw)[:, 0]
    assert got.shape == plain.shape
    np.testing.assert_array_equal(got.numpy(), plain.numpy())
    # the JAX wrapper, its Pallas kernel interpreted; jax 0.9 renamed the
    # compiler-params class the kernel names
    monkeypatch.setattr(pltpu, "TPUCompilerParams", pltpu.CompilerParams,
                        raising=False)
    want = jpa.paged_decode_attention(
        **{n: J(a) for n, a in args.items()}, interpret=True, **kw)
    close(got, want)


@pytest.mark.parametrize("arch", ARCHS)
def test_bf16_prefill_and_decode_logits(arch):
    """The published dtype: bf16 params and caches, each product rounded
    to bf16 as the reference rounds it.  Logits (|x| < 0.5 here) agree to
    two bf16 steps at that scale (atol 8e-3): summation order moves a
    bf16 rounding by one step now and then."""
    jcfg = reduced_jax(arch).scaled(dtype="bfloat16")
    cfg = reduced_torch(arch).scaled(dtype="bfloat16")
    tree = jax_params(jcfg, seed=1)
    params = torch_params(tree)
    toks = np.random.default_rng(18).integers(0, 128, (1, 20)).astype(
        np.int32)
    jc = jtransformer.init_cache(jcfg, 1, 32)
    jl, jc = jitted(jtransformer.prefill, jcfg)(tree, J(toks), jc)
    jdecode = jitted(jtransformer.decode_step, jcfg)
    c = transformer.init_cache(cfg, 1, 32, "cpu")
    with torch.no_grad():
        l, c = transformer.prefill(cfg, params, T(toks), c)
        assert c["scan"]["b0"][next(iter(c["scan"]["b0"]))].dtype == \
            torch.bfloat16
        for i in range(4):
            np.testing.assert_allclose(l.numpy(), np.asarray(jl, np.float32),
                                       atol=8e-3, rtol=0)
            t = np.array([[i + 3]], np.int32)
            if i < 3:
                jl, jc = jdecode(tree, jc, J(t), 20 + i)
                l, c = transformer.decode_step(cfg, params, c, T(t), 20 + i)

"""The port's KV-page codec (``kv_codec="cluster"``) against the JAX
reference, on the CPU.

* ``repro_torch.kernels.kv_codec``: ``codebook``/``encode``/``decode``/
  ``error_bound`` byte-identical to ``repro.kernels.kv_codec`` over the
  reference's own grid (``tests/test_kv_codec.py::SHAPES`` x
  ``SEED_GRID``, all-zero pages, bf16 inputs); the at-rest Huffman archive
  and report equal.
* Paged attention over int8 code pools: the plain version against the
  JAX ``chunk_attention``/``decode_attention`` oracles over pages decoded
  by the JAX ``kv_codec.decode`` (f32, atol 1e-5, rtol 1e-4: summation
  order only); bit-identical to the fp path on the pool decoded up front
  (both dequant names); poisoned page-0 codes inert.  The CUDA kernel is
  held to this plain version on the card by ``tests/test_torch_cuda.py``.
* Serving: ``Scheduler(attn_backend="cuda_paged", kv_codec="cluster")``
  gives the tokens of the JAX gathered chunked codec path (the oracle:
  the reference's in-kernel codec path needs its Pallas kernel) on
  ``tests/harness.py::MIXED`` with unit-scale MLP weights, at pages 4
  and 8 and chunks 3 and 4; ``SlotPool`` page bytes equal the JAX
  ``SlotPool``'s; the serve launcher prints the codec lines.
"""

import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from repro.kernels import kv_codec as jkv
from repro.models.attention import decode_attention
from repro.runtime import ServeEngine as JaxServeEngine
from repro.runtime.scheduler import SlotPool as JaxSlotPool
from repro_torch.kernels import kv_codec as kv
from repro_torch.kernels.paged_attention import (decode_pool,
                                                 paged_mixed_attention,
                                                 paged_mixed_attention_plain)
from repro_torch.launch import serve as serve_launch
from repro_torch.runtime import Scheduler, ServeEngine, SlotPool
from repro_torch.tree import tree_leaves
from tests.harness import MIXED, assert_tokens_identical, mixed_requests
from tests.harness import run_trace as jax_serve
from tests.test_kv_codec import SEED_GRID, SHAPES, random_values
from tests.test_torch_harness import (jax_params, reduced_jax, reduced_torch,
                                      torch_params, unit_scale_mlp)
from tests.test_torch_paged_attention import chunk_oracle, gathered, paged_case

ATOL, RTOL = 1e-5, 1e-4

# ---------------------------------------------------------------------------
# codec functions: byte-identical to the reference
# ---------------------------------------------------------------------------


def assert_encode_identical(values, axes):
    jcodes, jscale = jkv.encode(values, axes)
    codes, scale = kv.encode(torch.from_numpy(np.asarray(values)), axes)
    assert codes.dtype == torch.int8 and scale.dtype == torch.float32
    np.testing.assert_array_equal(codes.numpy(), np.asarray(jcodes))
    assert scale.numpy().tobytes() == np.asarray(jscale).tobytes()
    # decode and the bound, with the squeezed axes re-inserted
    sc = np.array(jscale)
    for ax in sorted(a % np.ndim(values) for a in axes):
        sc = np.expand_dims(sc, ax)
    want = np.asarray(jkv.decode(jcodes, sc))
    got = kv.decode(codes, torch.from_numpy(sc)).numpy()
    assert got.tobytes() == want.tobytes()
    assert kv.error_bound(torch.from_numpy(sc)).numpy().tobytes() == \
        np.asarray(jkv.error_bound(sc)).tobytes()


def test_codebook_and_constants_identical():
    assert (kv.KV_CODECS, kv.LEVELS, kv.ZERO_CODE, kv.MAX_CODE) == \
        (jkv.KV_CODECS, jkv.LEVELS, jkv.ZERO_CODE, jkv.MAX_CODE)
    assert kv.codebook().numpy().tobytes() == \
        np.asarray(jkv.codebook()).tobytes()


@pytest.mark.parametrize("seed", SEED_GRID)
@pytest.mark.parametrize("shape,axes", SHAPES)
def test_encode_decode_byte_identical(seed, shape, axes):
    """The reference's grid: normal values with exact zeros and an
    outlier, at magnitudes from 1e-6 to 1e6."""
    rng = np.random.default_rng(seed + 4000)
    mag = float(10.0 ** rng.integers(-6, 7))
    assert_encode_identical(random_values(seed, shape, mag), axes)


@pytest.mark.parametrize("shape,axes", SHAPES)
def test_zero_pages_byte_identical(shape, axes):
    zero = np.zeros(shape, np.float32)
    assert_encode_identical(zero, axes)
    codes, scale = kv.encode(torch.from_numpy(zero), axes)
    assert not codes.any() and not scale.any()


@pytest.mark.parametrize("seed", SEED_GRID[:3])
def test_encode_bf16_values_identical(seed):
    """The model's K/V are bf16 at full width; both packages cast to f32
    before the amax."""
    v = random_values(seed, (4, 8, 2, 16)).astype(ml_dtypes.bfloat16)
    jcodes, jscale = jkv.encode(jnp.asarray(v), (-2, -1))
    codes, scale = kv.encode(
        torch.from_numpy(v.view(np.int16)).view(torch.bfloat16), (-2, -1))
    np.testing.assert_array_equal(codes.numpy(), np.asarray(jcodes))
    assert scale.numpy().tobytes() == np.asarray(jscale).tobytes()


@pytest.mark.parametrize("seed", SEED_GRID)
def test_archive_and_restore_identical(seed):
    rng = np.random.default_rng(seed + 5000)
    shape = (int(rng.integers(1, 5)), int(rng.integers(1, 33)), 8)
    codes = rng.integers(-127, 128, shape).astype(np.int8)
    jwords, jnbits, jassign = jkv.archive_pages(codes)
    words, nbits, assign = kv.archive_pages(torch.from_numpy(codes))
    assert nbits == jnbits and words.dtype == np.uint32
    np.testing.assert_array_equal(words, jwords)
    for t, jt in zip(assign.tables, jassign.tables):
        np.testing.assert_array_equal(t, jt)
    restored = kv.restore_pages(words, nbits, assign, codes.shape)
    np.testing.assert_array_equal(restored, codes)
    np.testing.assert_array_equal(
        restored, jkv.restore_pages(jwords, jnbits, jassign, codes.shape))


@pytest.mark.parametrize("spread", [6.0, 60.0])
def test_huffman_report_identical(spread):
    rng = np.random.default_rng(0)
    codes = np.clip(rng.normal(0.0, spread, 4096).round(), -127, 127) \
        .astype(np.int8)
    assert kv.huffman_report(torch.from_numpy(codes)) == \
        jkv.huffman_report(codes)


# ---------------------------------------------------------------------------
# paged attention over code pools (plain version) vs the JAX oracles
# ---------------------------------------------------------------------------


def codec_case(seed, **kw):
    """``paged_case`` with its pools encoded by the JAX codec: ``c`` holds
    the decoded f32 pools (what the oracles read), ``codes`` the int8
    pools and (n_pages, rows) scales (what the port reads)."""
    c = paged_case(seed, **kw)
    codes = {}
    for name in ("k", "v"):
        jc, js = jkv.encode(c[name], (-2, -1))
        c[name] = np.asarray(jkv.decode(jc, np.asarray(js)[..., None, None]))
        codes[name] = (torch.from_numpy(np.array(jc)),
                       torch.from_numpy(np.array(js)))
    return c, codes


def port_codec(c, codes, **kw):
    d = c["q"].shape[-1]
    (kc, ks), (vc, vs) = codes["k"], codes["v"]
    return paged_mixed_attention(
        torch.from_numpy(c["q"]) * d ** -0.5, kc, vc,
        torch.from_numpy(c["table"]), torch.from_numpy(c["lengths"]),
        torch.from_numpy(c["q_lens"]), k_scales=ks, v_scales=vs,
        codebook=kv.codebook(), page_size=c["logical"], **kw).numpy()


@pytest.mark.parametrize("window,cap", [(0, 0.0), (5, 0.0), (0, 2.0),
                                        (6, 3.0)])
@pytest.mark.parametrize("rows,logical", [(4, 4), (8, 5)])
def test_codec_chunk_rows_vs_chunk_attention(window, cap, rows, logical):
    c, codes = codec_case(11, qn=5, q_lens=[5, 1, 0, 3],
                          lengths=[19, 9, 0, 3], rows=rows, logical=logical)
    out = port_codec(c, codes, window=window, softcap_val=cap)
    for s, ql in enumerate(c["q_lens"]):
        if ql:
            np.testing.assert_allclose(
                out[s, :ql], chunk_oracle(c, s, window, cap)[:ql],
                atol=ATOL, rtol=RTOL)
        assert (out[s, ql:] == 0).all()


@pytest.mark.parametrize("window,cap", [(0, 0.0), (4, 0.0), (0, 5.0)])
def test_codec_decode_rows_vs_decode_attention(window, cap):
    c, codes = codec_case(12, qn=1, q_lens=[1, 1, 1], lengths=[23, 1, 11])
    out = port_codec(c, codes, window=window, softcap_val=cap)
    views = [gathered(c, s) for s in range(3)]
    want = decode_attention(
        jnp.asarray(c["q"]), jnp.asarray(np.stack([k for k, _ in views])),
        jnp.asarray(np.stack([v for _, v in views])),
        jnp.asarray(c["lengths"] - 1), window=window, attn_softcap=cap)
    np.testing.assert_allclose(out, np.asarray(want), atol=ATOL, rtol=RTOL)


@pytest.mark.parametrize("dequant", ["gather", "onehot"])
@pytest.mark.parametrize("window,cap", [(0, 0.0), (6, 3.0)])
def test_codec_path_bit_identical_to_fp_on_decoded_pool(dequant, window,
                                                        cap):
    c, codes = codec_case(13, qn=5, q_lens=[5, 1, 0, 3],
                          lengths=[19, 9, 0, 3], rows=8, logical=5)
    (kc, ks), (vc, vs) = codes["k"], codes["v"]
    cb = kv.codebook()
    k, v = decode_pool(kc, ks, cb), decode_pool(vc, vs, cb)
    assert k.numpy().tobytes() == c["k"].tobytes()     # JAX's decode
    args = (torch.from_numpy(c["q"]), kc, vc, torch.from_numpy(c["table"]),
            torch.from_numpy(c["lengths"]), torch.from_numpy(c["q_lens"]))
    kw = dict(window=window, softcap_val=cap, page_size=c["logical"])
    got = paged_mixed_attention(*args, k_scales=ks, v_scales=vs,
                                codebook=kv.codebook(), dequant=dequant,
                                **kw)
    want = paged_mixed_attention_plain(args[0], k, v, *args[3:], **kw)
    assert got.numpy().tobytes() == want.numpy().tobytes()


def test_codec_poisoned_dummy_sink_and_padding_rows_are_inert():
    """Page 0 and the layout padding rows hold codes and scales that are
    not zero under serving (padded tokens are written to the sink); the
    masks must never admit them."""
    c, codes = codec_case(14, qn=4, q_lens=[4, 1, 0], lengths=[9, 14, 0],
                          rows=8, logical=6)
    clean = port_codec(c, codes)
    for name, val in (("k", 127), ("v", -127)):
        cc, sc = codes[name]
        cc[0], cc[:, 6:] = val, val
        sc[0], sc[:, 6:] = 1e6, 1e6
    poisoned = port_codec(c, codes)
    assert np.isfinite(poisoned).all()
    np.testing.assert_array_equal(clean, poisoned)


def test_codec_wrapper_refuses_what_it_does_not_take():
    c, codes = codec_case(15, qn=1, q_lens=[1], lengths=[3])
    (kc, ks), (vc, vs) = codes["k"], codes["v"]
    args = (torch.from_numpy(c["q"]), kc, vc, torch.from_numpy(c["table"]),
            torch.from_numpy(c["lengths"]), torch.from_numpy(c["q_lens"]))
    with pytest.raises(ValueError, match="k_scales, v_scales and codebook"):
        paged_mixed_attention(*args, k_scales=ks, v_scales=vs)
    with pytest.raises(ValueError, match="int8"):
        paged_mixed_attention(args[0], kc.float(), vc.float(), *args[3:],
                              k_scales=ks, v_scales=vs,
                              codebook=kv.codebook())
    with pytest.raises(ValueError, match="dequant"):
        paged_mixed_attention(*args, k_scales=ks, v_scales=vs,
                              codebook=kv.codebook(), dequant="bitplane")
    # the MLA second operand under the codec needs its own scale pool, and
    # runs with it (tests/test_torch_mla.py holds it to the reference)
    q2 = torch.zeros((*args[0].shape[:3], 8))
    k2 = torch.zeros((*kc.shape[:3], 8), dtype=torch.int8)
    with pytest.raises(ValueError, match="k2_scales without"):
        paged_mixed_attention(*args, k_scales=ks, v_scales=vs,
                              k2_scales=ks, codebook=kv.codebook())
    with pytest.raises(ValueError, match="k2_scales comes with codec"):
        paged_mixed_attention(*args, q2, k2, k_scales=ks, v_scales=vs,
                              codebook=kv.codebook())
    with pytest.raises(ValueError, match="dtype"):
        paged_mixed_attention(*args, q2, k2.float(), k_scales=ks,
                              v_scales=vs, k2_scales=ks,
                              codebook=kv.codebook())
    got = paged_mixed_attention(*args, q2, k2, k_scales=ks, v_scales=vs,
                                k2_scales=ks, codebook=kv.codebook())
    want = paged_mixed_attention(*args, k_scales=ks, v_scales=vs,
                                 codebook=kv.codebook())
    assert got.numpy().tobytes() == want.numpy().tobytes()


# ---------------------------------------------------------------------------
# serving: the port's codec path vs the JAX gathered chunked codec path
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def engines():
    tree = unit_scale_mlp(jax_params(reduced_jax("minitron-8b"), seed=0))
    jengine = JaxServeEngine(reduced_jax("minitron-8b"), tree)
    engine = ServeEngine(reduced_torch("minitron-8b"), torch_params(tree),
                         device="cpu")
    return engine, jengine, mixed_requests(jengine, MIXED)


def port_serve(engine, reqs, **kw):
    engine.metrics = type(engine.metrics)()
    sched = Scheduler(engine, batch_size=2, attn_backend="cuda_paged",
                      kv_codec="cluster", **kw)
    rids = {sched.submit(*r).rid: i for i, r in enumerate(reqs)}
    done = sched.run()
    assert len(done) == len(reqs)
    return {rids[r.rid]: tuple(r.generated) for r in done}, sched


@pytest.mark.parametrize("chunk", [3, 4])
@pytest.mark.parametrize("page", [4, 8])
def test_codec_scheduler_tokens_identical_to_jax_oracle(engines, page,
                                                        chunk):
    """Same tokens as the JAX gathered chunked codec path, whose chunks
    attend codec-roundtripped K/V exactly as the in-kernel path does; the
    pools rest as int8 codes + f32 scales and nothing leaks."""
    engine, jengine, reqs = engines
    want = jax_serve(jengine, reqs, attn_backend="gathered",
                     kv_codec="cluster", kv_page_size=page,
                     prefill_chunk=chunk)
    got, sched = port_serve(engine, reqs, kv_page_size=page,
                            prefill_chunk=chunk)
    assert_tokens_identical(got, want, f"codec page {page} chunk {chunk}")
    pool, m = sched._pool, engine.metrics
    assert {c.dtype for c in tree_leaves(pool.kcache)} == {torch.int8}
    assert {s.dtype for s in tree_leaves(pool.kscales)} == {torch.float32}
    assert [s.shape for s in tree_leaves(pool.kscales)] == \
        [c.shape[:-2] for c in tree_leaves(pool.kcache)]
    assert m.kv_gather_bytes == 0 and m.kv_prefill_gather_bytes == 0
    assert m.kv_bytes_avoided == m.kv_codec_bytes_fp \
        - m.kv_codec_bytes_resident > 0
    assert m.kv_capacity_multiplier() == pytest.approx(
        pool.page_bytes_fp / pool.page_bytes_resident)
    assert "kv codec" in engine.stats_line()
    assert pool.allocator.n_allocated == 0 and (pool.table == 0).all()


@pytest.mark.parametrize("page,chunk", [(4, 3), (8, 4)])
def test_codec_error_bound_is_the_reference_formula(engines, page, chunk):
    """``kv_codec_error_bound`` is the reference's ``error_bound`` of the
    largest scale resident in the pool at the end of the run, as in the
    reference's ``SlotPool.codec_error_bound``.  What the pool holds then
    depends on the backend (the in-kernel path writes padded tokens into
    the page-0 sink and each token where it lands; the gathered oracle
    drops padded writes and rewrites whole slot views at install), so the
    number is held to the formula over the port's own pool, not to the
    gathered oracle's."""
    engine, _, reqs = engines
    _, sched = port_serve(engine, reqs, kv_page_size=page,
                          prefill_chunk=chunk)
    top = max(float(s.max()) for s in tree_leaves(sched._pool.kscales))
    assert top > 0
    assert engine.metrics.kv_codec_error_bound == \
        float(jkv.error_bound(np.float32(top)))
    assert sched._pool.codec_error_bound() == \
        engine.metrics.kv_codec_error_bound


@pytest.mark.parametrize("page", [4, 8])
@pytest.mark.parametrize("codec", ["none", "cluster"])
def test_slot_pool_page_bytes_match_jax(engines, page, codec):
    engine, jengine, _ = engines
    jpool = JaxSlotPool(jengine, 2, 32, page_size=page, backend="gathered",
                        kv_codec=codec)
    pool = SlotPool(engine, 2, 32, page_size=page, kv_codec=codec)
    assert (pool.page_bytes_fp, pool.page_bytes_resident) == \
        (jpool.page_bytes_fp, jpool.page_bytes_resident)
    assert pool.codec == (codec == "cluster") and \
        (pool.kscales is None) == (codec == "none")


def test_unknown_codec_is_refused(engines):
    with pytest.raises(ValueError, match="unknown kv codec"):
        Scheduler(engines[0], kv_page_size=4, prefill_chunk=3,
                  kv_codec="fp8")


def test_serve_launcher_prints_the_codec_lines(capsys):
    done = serve_launch.main(["--arch", "minitron-8b", "--scale", "tiny",
                              "--device", "cpu", "--attn-backend",
                              "cuda_paged", "--kv-codec", "cluster",
                              "--batch", "2",
                              "--requests", "3", "--prompt-len", "20",
                              "--gen", "5", "--prefill-chunk", "8",
                              "--kv-page-size", "4"])
    assert len(done) == 3 and all(len(r.generated) == 5 for r in done)
    out = capsys.readouterr().out
    for line in ("kv codec (cluster): page 4096 fp bytes -> 1088 resident "
                 "bytes (3.76x effective capacity",
                 "kv codec error bound: ", "kv codec at-rest huffman: "):
        assert line in out

"""The port's CUDA kernels on the card, against their plain versions.

Every test here is marked ``cuda`` and skips without a card (the kernels
have no CPU mode; the plain versions are held to the JAX reference by
the other ``test_torch_*`` files).  This file imports neither jax nor
``repro``, so the machine with the card runs it as it is:

    python -m pytest -q -m cuda tests/test_torch_cuda.py
"""

import numpy as np
import pytest
import torch

from repro_torch.core import compression
from repro_torch.kernels import kv_codec, ops, ref
from repro_torch.kernels.binarize_pack import (binarize_pack,
                                               binarize_pack_patches)
from repro_torch.kernels.binary_contraction import (
    binary_contraction, contraction_kernel_info, contraction_plan)
from repro_torch.kernels.fused_decode_contraction import (
    fused_decode_matmul, fused_kernel_info, fused_plan)
from repro_torch.kernels.huffman_decode import flat_table, huffman_decode
from repro_torch.kernels.paged_attention import (decode_pool,
                                                 gqa_kernel_info,
                                                 mla_kernel_info,
                                                 paged_decode_attention,
                                                 paged_mixed_attention,
                                                 paged_mixed_attention_plain,
                                                 sm_count)
from repro_torch.models.reactnet import CONFIG as RN
from repro_torch.runtime.decode_cache import DecodeTileCache
from repro_torch.runtime.weight_store import WeightStore
import contraction_walk as walk

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    return torch.device("cuda")


def _tiles(dev, kind, c, n, seed):
    """Tiles of a skewed (a few hot sequences, short codes) or uniform
    (mostly 12-bit escapes) sequence sample."""
    rng = np.random.default_rng(seed)
    probs = np.ones(512)
    if kind == "skewed":
        probs[[0, 511, 1, 7, 73, 255, 448]] = [300, 210, 90, 90, 90, 90, 90]
    seqs = rng.choice(512, size=n, p=probs / probs.sum()).astype(np.uint16)
    ct = compression.compress_sequences(seqs, seqs.shape, "gemm",
                                        cluster=False, codes_per_sub=c)
    words = np.ascontiguousarray(ct.tiled.words).view(np.int32)
    return (torch.from_numpy(words).to(dev),
            torch.from_numpy(ct.decode_tables()).to(dev))


@pytest.mark.parametrize("c", [8, 16, 32])
@pytest.mark.parametrize("kind", ["skewed", "uniform"])
def test_huffman_kernel_bit_exact_vs_plain(dev, kind, c):
    words, table = _tiles(dev, kind, c, 40 * 128 * c + 5, seed=c)
    before = huffman_decode.launches
    got = huffman_decode(words, table, c=c)
    torch.cuda.synchronize()
    assert huffman_decode.launches == before + 1
    assert torch.equal(got, ref.decode_tiled(words, table, c))


def test_huffman_kernel_edge_rules_on_garbage_words(dev):
    gen = torch.Generator(device=dev).manual_seed(0)
    for w_rows in (1, 2, 3):
        words = torch.randint(-2 ** 31, 2 ** 31 - 1, (64, w_rows, 128),
                              generator=gen, device=dev, dtype=torch.int64)
        words = words.to(torch.int32)
        table = torch.randint(0, 512, (160,), generator=gen, device=dev,
                              dtype=torch.int32)
        assert torch.equal(huffman_decode(words, table, c=16),
                           ref.decode_tiled(words, table, 16))


def test_huffman_wrapper_rejects_what_the_kernel_does_not_take(dev):
    words, table = _tiles(dev, "skewed", 8, 4096, seed=1)
    with pytest.raises(ValueError, match="contiguous int32"):
        huffman_decode(words.transpose(1, 2), table, c=8)
    with pytest.raises(ValueError, match="contiguous int32"):
        huffman_decode(words.long(), table, c=8)


def test_evicting_decoded_tiles_frees_device_memory(dev):
    """With a bounded tile cache, the tiles it evicts are freed on the
    card: the store grows device memory by the tiles it keeps, not by
    every tile the launch decoded."""
    rng = np.random.default_rng(0)
    up = rng.standard_normal((2, 144, 512)).astype(np.float32)
    tile_bytes = 8 * 128 * 4
    grown, kept = {}, {}
    for cap in (None, 4 * tile_bytes):
        store = WeightStore(DecodeTileCache(cap))
        store.register_model("m", {"scan": {"b0": {"mlp": {
            "up": torch.from_numpy(up).to(dev)}}}})
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated(dev)
        store.materialize("m")
        torch.cuda.synchronize()
        grown[cap] = torch.cuda.memory_allocated(dev) - base
        kept[cap] = len(store.cache)
        assert store.cache.resident_bytes == kept[cap] * tile_bytes
    assert kept[None] == 16 and kept[4 * tile_bytes] == 4
    assert grown[None] - grown[4 * tile_bytes] == 12 * tile_bytes


def _paged(dev, dtype, seed, d=128, h=8):
    """Ragged block (chunk, decode, empty, short chunk) over pools whose
    rows 6..7 are layout padding; later table entries hit the sink."""
    rng = np.random.default_rng(seed)
    s_n, qn, kh, rows, logical, pps = 4, 6, 2, 8, 6, 5
    lengths = np.array([22, 13, 0, 2], np.int32)
    q_lens = np.array([6, 1, 0, 2], np.int32)
    n_pages = s_n * pps + 1
    ids = iter(rng.permutation(np.arange(1, n_pages)))
    table = np.zeros((s_n, pps), np.int32)
    for s, ln in enumerate(lengths):
        for j in range(-(-int(ln) // logical)):
            table[s, j] = next(ids)
    k = rng.standard_normal((n_pages, rows, kh, d)).astype(np.float32)
    v = rng.standard_normal((n_pages, rows, kh, d)).astype(np.float32)
    q = rng.standard_normal((s_n, qn, h, d)).astype(np.float32) * d ** -0.5
    t = lambda a: torch.from_numpy(a).to(dev)
    return (t(q), t(k).to(dtype), t(v).to(dtype), t(table), t(lengths),
            t(q_lens), logical)


@pytest.mark.parametrize("window,cap", [(0, 0.0), (7, 0.0), (0, 4.0),
                                        (5, 3.0)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_paged_attention_kernel_vs_plain(dev, dtype, window, cap):
    q, k, v, table, lengths, q_lens, logical = _paged(dev, dtype, seed=5)
    kw = dict(window=window, softcap_val=cap, page_size=logical)
    before = paged_mixed_attention.launches
    got = paged_mixed_attention(q, k, v, table, lengths, q_lens, **kw)
    want = paged_mixed_attention_plain(q, k, v, table, lengths, q_lens, **kw)
    torch.cuda.synchronize()
    assert paged_mixed_attention.launches == before + 1
    # both score in f32 from the same pool values; they differ only in
    # summation order and the exp/tanh implementations
    torch.testing.assert_close(got, want, atol=2e-5, rtol=1e-4)


def test_paged_attention_kernel_never_reads_sink_or_padding(dev):
    q, k, v, table, lengths, q_lens, logical = _paged(dev, torch.bfloat16, 6)
    clean = paged_mixed_attention(q, k, v, table, lengths, q_lens,
                                  page_size=logical)
    k[0], v[0] = 3e4, -3e4
    k[:, logical:], v[:, logical:] = 3e4, -3e4
    poisoned = paged_mixed_attention(q, k, v, table, lengths, q_lens,
                                     page_size=logical)
    torch.cuda.synchronize()
    assert torch.isfinite(poisoned).all()
    assert torch.equal(clean, poisoned)


@pytest.mark.parametrize("mla", [False, True])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_paged_decode_attention_is_the_kernel_at_q1(dev, dtype, mla):
    """The Q=1 wrapper launches the GQA (or, with ``q2``, the MLA) kernel
    once, gives the mixed kernel's bits at q_lens = 1, and stays within
    the plain version's tolerance with the sink and padding poisoned."""
    q, k, v, table, lengths, _, logical = _paged(dev, dtype, seed=11,
                                                 h=8 if not mla else 16)
    live = torch.tensor([0, 1, 3], device=dev)   # slot 2 owns no page
    q, table, lengths = q[live, 0], table[live], lengths[live]
    kw = dict(page_size=logical)
    if mla:
        k = v = k[:, :, :1].contiguous()
        gen = torch.Generator(device=dev).manual_seed(2)
        kw.update(q2=torch.randn((*q.shape[:2], 32), generator=gen,
                                 device=dev),
                  k2_pages=torch.randn((*k.shape[:3], 32), generator=gen,
                                       device=dev).to(dtype), scale=0.1)
    k[0], k[:, logical:] = 3e4, 3e4
    if not mla:
        v[0], v[:, logical:] = -3e4, -3e4
    ones = torch.ones_like(lengths)
    q2 = kw.pop("q2", None)
    before = paged_mixed_attention.launches
    got = paged_decode_attention(q, k, v, table, lengths, q2, **kw)
    assert paged_mixed_attention.launches == before + 1
    mixed = paged_mixed_attention(q[:, None], k, v, table, lengths, ones,
                                  None if q2 is None else q2[:, None], **kw)
    want = paged_mixed_attention_plain(
        q[:, None], k, v, table, lengths, ones,
        q2=None if q2 is None else q2[:, None], **kw)
    torch.cuda.synchronize()
    assert torch.equal(got, mixed[:, 0])
    torch.testing.assert_close(got, want[:, 0], atol=2e-5, rtol=1e-4)


def test_lane_paths_serve_the_cpu_tokens(dev):
    """A small f32 model with +-1 MLP weights served on the gathered
    backend (paged and monolithic lanes, codec), with monolithic prefill
    on cuda_paged, and in wave mode: the card's tokens are the CPU's."""
    from repro_torch.configs.base import get_config
    from repro_torch.models.transformer import init_params
    from repro_torch.runtime import Scheduler, ServeEngine
    from repro_torch.tree import tree_map_with_path
    cfg = get_config("minitron-8b").scaled(
        num_layers=2, scan_repeats=2, d_model=64, num_heads=4,
        num_kv_heads=2, head_dim=16, d_ff=128, vocab_size=128,
        dtype="float32")
    params = tree_map_with_path(
        lambda path, w: torch.where(w >= 0, 1.0, -1.0)
        if "mlp" in path.split("/") else w,
        init_params(cfg, torch.Generator().manual_seed(1), "cpu"))
    rng = np.random.default_rng(1)
    reqs = [(rng.integers(0, 128, n), g)
            for n, g in ((5, 7), (12, 2), (20, 5), (6, 9), (3, 1))]
    engines = {d: ServeEngine(cfg, params, device=d) for d in ("cpu", dev)}
    for kw in (dict(attn_backend="gathered"),
               dict(attn_backend="gathered", kv_page_size=4,
                    prefill_chunk=3, kv_codec="cluster"),
               dict(attn_backend="cuda_paged", kv_page_size=4),
               dict(attn_backend="cuda_paged", kv_page_size=4,
                    prefill_chunk=3, mode="wave")):
        out = []
        for engine in engines.values():
            sched = Scheduler(engine, batch_size=2, **kw)
            for r in reqs:
                sched.submit(*r)
            out.append({r.rid: r.generated for r in sched.run()})
        assert out[0] == out[1], kw


@pytest.mark.parametrize("mla", [False, True])
def test_verify_blocks_over_shared_pages(dev, mla):
    """Speculative verify blocks: Q=5 ragged, each block across a page
    boundary, slots 1 and 3 mapping the same physical pages (a shared
    prefix), GQA or MLA; the kernel within the plain version's tolerance
    and unmoved by the sink poisoned."""
    rng = np.random.default_rng(7)
    s_n, qn, page, pps, d = 4, 5, 4, 6, 32
    h, kh = (8, 1) if mla else (8, 2)
    lengths = np.array([10, 7, 0, 23], np.int32)
    q_lens = np.array([5, 3, 0, 5], np.int32)
    table = np.zeros((s_n, pps), np.int32)
    ids = iter(rng.permutation(np.arange(1, s_n * pps + 1)))
    for s, ln in enumerate(lengths):
        for j in range(-(-int(ln) // page)):
            table[s, j] = next(ids)
    table[3, :2] = table[1, :2]
    t = lambda a: torch.from_numpy(np.asarray(a)).to(dev)
    k = t(rng.standard_normal((s_n * pps + 1, page, kh, d))
          .astype(np.float32)).to(torch.bfloat16)
    v = k if mla else t(rng.standard_normal(k.shape).astype(np.float32)) \
        .to(torch.bfloat16)
    q = t(rng.standard_normal((s_n, qn, h, d)).astype(np.float32) * 0.2)
    kw = dict(page_size=page)
    args = (q, k, v, t(table), t(lengths), t(q_lens))
    if mla:
        kw.update(k2_pages=t(rng.standard_normal((*k.shape[:3], 16))
                             .astype(np.float32)).to(torch.bfloat16),
                  scale=0.2)
        q2 = t(rng.standard_normal((s_n, qn, h, 16)).astype(np.float32))
        got = paged_mixed_attention(*args, q2, **kw)
        want = paged_mixed_attention_plain(*args, q2=q2, **kw)
    else:
        got = paged_mixed_attention(*args, **kw)
        want = paged_mixed_attention_plain(*args, **kw)
    k[0] = 3e4
    poisoned = paged_mixed_attention(*args, q2, **kw) if mla else \
        paged_mixed_attention(*args, **kw)
    torch.cuda.synchronize()
    rows = torch.arange(qn, device=dev)[None] < t(q_lens)[:, None]
    torch.testing.assert_close(got[rows], want[rows], atol=2e-5, rtol=1e-4)
    assert torch.equal(got, poisoned)


def test_prefix_and_speculation_serve_the_cpu_tokens(dev):
    """A small f32 model with +-1 MLP weights, prompts sharing a prefix
    and prompts repeating a pattern, served with prefix sharing and n-gram
    speculation on both backends: the card's tokens and counters are the
    CPU's."""
    from repro_torch.configs.base import get_config
    from repro_torch.models.transformer import init_params
    from repro_torch.runtime import Scheduler, ServeEngine
    from repro_torch.tree import tree_map_with_path
    cfg = get_config("minitron-8b").scaled(
        num_layers=2, scan_repeats=2, d_model=64, num_heads=4,
        num_kv_heads=2, head_dim=16, d_ff=128, vocab_size=128,
        dtype="float32")
    params = tree_map_with_path(
        lambda path, w: torch.where(w >= 0, 1.0, -1.0)
        if "mlp" in path.split("/") else w,
        init_params(cfg, torch.Generator().manual_seed(1), "cpu"))
    rng = np.random.default_rng(2)
    common = rng.integers(0, 128, 13)
    reqs = [(np.concatenate([common, rng.integers(0, 128, n)]), g)
            for n, g in ((3, 6), (5, 9), (2, 4))]
    reqs += [(np.tile(rng.integers(0, 128, 3), 4), 12) for _ in range(2)]
    engines = {d: ServeEngine(cfg, params, device=d) for d in ("cpu", dev)}
    for backend in ("gathered", "cuda_paged"):
        kw = dict(attn_backend=backend, kv_page_size=4, prefill_chunk=4,
                  prefix_share=True, speculate="ngram", draft_k=3)
        out = []
        for engine in engines.values():
            sched = Scheduler(engine, batch_size=2, **kw)
            for r in reqs:
                sched.submit(*r)
            toks = {r.rid: r.generated for r in sched.run()}
            m = engine.metrics
            out.append((toks, m.prefix_hits, m.prefix_cow_copies,
                        m.spec_draft_tokens, m.spec_accepted_tokens))
        assert out[0] == out[1], backend
        assert out[0][1] > 0 and out[0][3] > 0


def _codec_pools(dev, seed, d=128):
    """``_paged``'s block over int8 codec pools: (q, codes, scales,
    codebook, decoded f32 pools, table, lengths, q_lens, logical)."""
    q, k, v, table, lengths, q_lens, logical = _paged(dev, torch.float32,
                                                      seed, d)
    (kc, ks), (vc, vs) = (kv_codec.encode(x, (-2, -1)) for x in (k, v))
    cb = kv_codec.codebook(dev)
    return (q, (kc, vc), (ks, vs), cb,
            (decode_pool(kc, ks, cb), decode_pool(vc, vs, cb)), table,
            lengths, q_lens, logical)


@pytest.mark.parametrize("d", [128, 40])
@pytest.mark.parametrize("window,cap", [(0, 0.0), (7, 0.0), (0, 4.0),
                                        (5, 3.0)])
def test_codec_kernel_vs_plain_and_bit_identical_to_fp(dev, window, cap, d):
    """The codec kernel within 1e-4 of its plain version, and bit-identical
    to the fp kernel on the pool decoded up front into f32, under both
    dequant names."""
    q, (kc, vc), (ks, vs), cb, (k, v), table, lengths, q_lens, logical = \
        _codec_pools(dev, 7, d)
    kw = dict(window=window, softcap_val=cap, page_size=logical)
    fp = paged_mixed_attention(q, k, v, table, lengths, q_lens, **kw)
    want = paged_mixed_attention_plain(q, kc, vc, table, lengths, q_lens,
                                       ks, vs, cb, **kw)
    for dequant in ("gather", "onehot"):
        before = paged_mixed_attention.launches
        got = paged_mixed_attention(q, kc, vc, table, lengths, q_lens,
                                    k_scales=ks, v_scales=vs, codebook=cb,
                                    dequant=dequant, **kw)
        torch.cuda.synchronize()
        assert paged_mixed_attention.launches == before + 1
        assert torch.equal(got, fp), dequant
        torch.testing.assert_close(got, want, atol=1e-4, rtol=1e-4)


def test_codec_kernel_never_reads_sink_or_padding(dev):
    q, (kc, vc), (ks, vs), cb, _, table, lengths, q_lens, logical = \
        _codec_pools(dev, 8)
    kw = dict(k_scales=ks, v_scales=vs, codebook=cb, page_size=logical)
    clean = paged_mixed_attention(q, kc, vc, table, lengths, q_lens, **kw)
    for codes, scales, val in ((kc, ks, 127), (vc, vs, -127)):
        codes[0], codes[:, logical:] = val, val
        scales[0], scales[:, logical:] = 1e6, 1e6
    poisoned = paged_mixed_attention(q, kc, vc, table, lengths, q_lens, **kw)
    torch.cuda.synchronize()
    assert torch.isfinite(poisoned).all()
    assert torch.equal(clean, poisoned)


# The GQA kernel's rows a block are tokens x the G heads of one KV head;
# 64 rows when the launch has a block for every SM, else 32, else 16.
_GQA_ROWS = (64, 32, 16)
_GQA_GROUPS = {1: (4, 4), 2: (8, 4), 4: (8, 2), 6: (12, 2)}
_GQA_MASKS = [(0, 0.0), (9, 3.0)]


def _gqa_rows_case(rows):
    """(H, KH, D, Q, q_lens, lengths) of a launch that takes ``rows`` rows
    a block on this card (H100 SXM, 132 SMs: Q 80 and 64).  At H=32,
    KH=8 and 4 slots a launch has 32 blocks per 16 tokens at 64 rows and
    per 8 at 32.  Chunks span several token tiles of a block; the window
    of 9 starts inside a 16-key tile."""
    n = (sm_count() - 1) // 32
    if rows == 64:
        qn = 16 * (n + 1)
        return 32, 8, 40, qn, [qn, 1, 0, 50], [qn + 20, 13, 0, 70]
    if rows == 32:
        qn = 16 * n
        return 32, 8, 128, qn, [qn, 37, 0, 1], [qn + 26, 40, 0, 20]
    return 8, 2, 128, 6, [6, 1, 0, 2], [22, 13, 0, 2]


def _gqa(dev, seed, h, kh, d, qn, q_lens, lengths):
    """A ragged block over f32 pools whose rows 6..7 are layout padding
    (logical page 6 of 8 rows); table entries past a slot's length hit
    the page-0 sink."""
    rng = np.random.default_rng(seed)
    s_n, rows, logical = len(q_lens), 8, 6
    pps = -(-max(lengths) // logical)
    n_pages = s_n * pps + 1
    ids = iter(rng.permutation(np.arange(1, n_pages)))
    table = np.zeros((s_n, pps), np.int32)
    for s, ln in enumerate(lengths):
        for j in range(-(-ln // logical)):
            table[s, j] = next(ids)
    t = lambda a: torch.from_numpy(np.asarray(a)).to(dev)
    f32 = lambda *shape: rng.standard_normal(shape).astype(np.float32)
    return (t(f32(s_n, qn, h, d) * d ** -0.5), t(f32(n_pages, rows, kh, d)),
            t(f32(n_pages, rows, kh, d)), t(table),
            t(np.int32(lengths)), t(np.int32(q_lens)), logical)


def _check_gqa(dev, case, window, cap):
    """f32 and bf16 pools within the fp tolerance of the plain version;
    the codec (gather and onehot) bit-identical to the fp kernel on the
    decoded f32 pools and within 1e-4 of its plain version; poisoned sink
    and padding rows inert for bf16 and codec pools."""
    q, k, v, table, lengths, q_lens, logical = case
    kw = dict(window=window, softcap_val=cap, page_size=logical)
    for dtype in (torch.float32, torch.bfloat16):
        kd, vd = k.to(dtype, copy=True), v.to(dtype, copy=True)
        before = paged_mixed_attention.launches
        got = paged_mixed_attention(q, kd, vd, table, lengths, q_lens, **kw)
        want = paged_mixed_attention_plain(q, kd, vd, table, lengths, q_lens,
                                           **kw)
        torch.cuda.synchronize()
        assert paged_mixed_attention.launches == before + 1
        torch.testing.assert_close(got, want, atol=2e-5, rtol=1e-4)
        kd[0], vd[0], kd[:, logical:], vd[:, logical:] = 3e4, -3e4, 3e4, -3e4
        poisoned = paged_mixed_attention(q, kd, vd, table, lengths, q_lens,
                                         **kw)
        torch.cuda.synchronize()
        assert torch.equal(poisoned, got), dtype
    (kc, ks), (vc, vs) = (kv_codec.encode(x, (-2, -1)) for x in (k, v))
    cb = kv_codec.codebook(dev)
    fp = paged_mixed_attention(q, decode_pool(kc, ks, cb),
                               decode_pool(vc, vs, cb), table, lengths,
                               q_lens, **kw)
    want = paged_mixed_attention_plain(q, kc, vc, table, lengths, q_lens, ks,
                                       vs, cb, **kw)
    ckw = dict(k_scales=ks, v_scales=vs, codebook=cb, **kw)
    for dequant in ("gather", "onehot"):
        got = paged_mixed_attention(q, kc, vc, table, lengths, q_lens,
                                    dequant=dequant, **ckw)
        torch.cuda.synchronize()
        assert torch.equal(got, fp), dequant
        torch.testing.assert_close(got, want, atol=1e-4, rtol=1e-4)
    for codes, scales, val in ((kc, ks, 127), (vc, vs, -127)):
        codes[0], codes[:, logical:] = val, val
        scales[0], scales[:, logical:] = 1e6, 1e6
    poisoned = paged_mixed_attention(q, kc, vc, table, lengths, q_lens,
                                     **ckw)
    torch.cuda.synchronize()
    assert torch.equal(poisoned, fp)


@pytest.mark.parametrize("window,cap", _GQA_MASKS)
@pytest.mark.parametrize("rows", _GQA_ROWS)
def test_gqa_kernel_rows_per_block(dev, rows, window, cap):
    h, kh, d, qn, q_lens, lengths = _gqa_rows_case(rows)
    assert gqa_kernel_info("bfloat16", len(q_lens), qn, h, kh, d,
                           d)["rows"] == rows
    _check_gqa(dev, _gqa(dev, rows, h, kh, d, qn, q_lens, lengths), window,
               cap)


@pytest.mark.parametrize("window,cap", _GQA_MASKS)
@pytest.mark.parametrize("d", [40, 128, 256])
@pytest.mark.parametrize("g", list(_GQA_GROUPS))
def test_gqa_kernel_groups_and_widths(dev, g, d, window, cap):
    """G = H / KH of 1, 2, 4 and 6 query heads a KV head (6 leaves rows
    of a block empty), at head widths 40 (not a power of two), 128 and
    256 (two warps a row tile, each half of Dv)."""
    h, kh = _GQA_GROUPS[g]
    _check_gqa(dev, _gqa(dev, 10 * g + d, h, kh, d, 20, [20, 1, 0, 2],
                         [45, 13, 0, 2]), window, cap)


def test_gqa_kernel_info_reports_no_spills(dev):
    """Every instantiation (four pool kinds) at every rows-a-block choice
    and both column layouts (Dv <= 128, Dv = 256) keeps its registers:
    no local (spill) bytes, shared memory within the 227 KB a block may
    have."""
    for pools in ("float32", "bfloat16", "gather", "onehot"):
        for rows in _GQA_ROWS:
            h, kh, _, qn, q_lens, _ = _gqa_rows_case(rows)
            for d in (40, 128, 256):
                info = gqa_kernel_info(pools, len(q_lens), qn, h, kh, d, d)
                assert info["rows"] == rows
                assert info["local_bytes"] == 0, (pools, rows, d, info)
                assert 0 < info["smem_bytes"] <= 232448, info


def test_codec_encode_on_the_card_equals_the_cpu(dev):
    """The codes and scales written on the card are the CPU's for the same
    bf16 K/V (true division, round half to even, f32 cast before amax)."""
    gen = torch.Generator().manual_seed(9)
    x = (torch.randn((64, 16, 8, 128), generator=gen) * 3).to(torch.bfloat16)
    codes, scale = kv_codec.encode(x, (-2, -1))
    dcodes, dscale = kv_codec.encode(x.to(dev), (-2, -1))
    assert torch.equal(dcodes.cpu(), codes)
    assert torch.equal(dscale.cpu(), scale)


def _mla(dev, dtype, seed, d, d2, h=8):
    """``_paged``'s ragged block as MLA's absorbed attention: one latent
    KV head (pool (n_pages, rows, 1, d), the key and value pool at once)
    and a rope pool (n_pages, rows, 1, d2) scored against q2."""
    q, c, _, table, lengths, q_lens, logical = _paged(dev, dtype, seed, d, h)
    gen = torch.Generator(device=dev).manual_seed(seed)
    c = c[:, :, :1].contiguous()
    q2 = torch.randn((*q.shape[:3], d2), generator=gen, device=dev)
    pe = torch.randn((*c.shape[:3], d2), generator=gen, device=dev).to(dtype)
    return q * d ** 0.5, c, q2, pe, table, lengths, q_lens, logical


# MLA: the reduced deepseek's widths (16, 8), the test widths (32, 8) and
# deepseek's (512, 64); head counts inside one 64-head block of the
# kernel and across two (100, not a multiple of 64); a window that cuts
# inside a page (logical 6) and inside a 16-key tile, with and without a
# softcap
_MLA_WIDTHS = [(16, 8), (32, 8), (512, 64)]
_MLA_MASKS = [(0, 0.0), (4, 0.0), (9, 3.0)]


@pytest.mark.parametrize("window,cap", _MLA_MASKS)
@pytest.mark.parametrize("h", [8, 100])
@pytest.mark.parametrize("d,d2", _MLA_WIDTHS)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_mla_kernel_vs_plain(dev, dtype, d, d2, h, window, cap):
    q, c, q2, pe, table, lengths, q_lens, logical = _mla(dev, dtype, 11, d,
                                                         d2, h)
    kw = dict(scale=(d // 4 + d2) ** -0.5, page_size=logical, window=window,
              softcap_val=cap)
    before = (paged_mixed_attention.launches,
              paged_mixed_attention.mla_launches)
    got = paged_mixed_attention(q, c, c, table, lengths, q_lens, q2, pe,
                                **kw)
    want = paged_mixed_attention_plain(q, c, c, table, lengths, q_lens,
                                       q2=q2, k2_pages=pe, **kw)
    torch.cuda.synchronize()
    assert (paged_mixed_attention.launches,
            paged_mixed_attention.mla_launches) == (before[0] + 1,
                                                    before[1] + 1)
    # summation order only, as for GQA; at D = 512 a score sums 576 terms
    torch.testing.assert_close(got, want, atol=1e-4, rtol=1e-4)


@pytest.mark.parametrize("window,cap", _MLA_MASKS)
@pytest.mark.parametrize("h", [8, 100])
@pytest.mark.parametrize("d,d2", _MLA_WIDTHS)
def test_mla_codec_kernel_bit_identical_to_fp_on_decoded_pools(dev, d, d2, h,
                                                               window, cap):
    q, c, q2, pe, table, lengths, q_lens, logical = _mla(
        dev, torch.float32, 12, d, d2, h)
    (cc, cs), (pc, ps) = (kv_codec.encode(x, (-2, -1)) for x in (c, pe))
    cb = kv_codec.codebook(dev)
    cd, pd = decode_pool(cc, cs, cb), decode_pool(pc, ps, cb)
    kw = dict(scale=0.1, page_size=logical, window=window, softcap_val=cap)
    fp = paged_mixed_attention(q, cd, cd, table, lengths, q_lens, q2, pd,
                               **kw)
    want = paged_mixed_attention_plain(q, cc, cc, table, lengths, q_lens,
                                       cs, cs, cb, q2=q2, k2_pages=pc,
                                       k2_scales=ps, **kw)
    for dequant in ("gather", "onehot"):
        got = paged_mixed_attention(q, cc, cc, table, lengths, q_lens, q2,
                                    pc, cs, cs, ps, cb, dequant=dequant, **kw)
        torch.cuda.synchronize()
        assert torch.equal(got, fp), dequant
        torch.testing.assert_close(got, want, atol=1e-4, rtol=1e-4)
    for codes, scales in ((cc, cs), (pc, ps)):         # poison page 0
        codes[0], codes[:, logical:] = 127, 127
        scales[0], scales[:, logical:] = 1e6, 1e6
    poisoned = paged_mixed_attention(q, cc, cc, table, lengths, q_lens, q2,
                                     pc, cs, cs, ps, cb, **kw)
    torch.cuda.synchronize()
    assert torch.equal(poisoned, fp)


def _mla_long(dev, seed, d, d2, h=100):
    """A long ragged block (chunks of 40 and 23 tokens, a decode, an empty
    slot): enough blocks that the kernel takes 64 query rows a block."""
    rng = np.random.default_rng(seed)
    s_n, qn, rows, logical = 4, 40, 8, 6
    lengths = np.array([100, 13, 0, 60], np.int32)
    q_lens = np.array([40, 1, 0, 23], np.int32)
    pps = -(-int(lengths.max()) // logical)
    n_pages = s_n * pps + 1
    ids = iter(rng.permutation(np.arange(1, n_pages)))
    table = np.zeros((s_n, pps), np.int32)
    for s, ln in enumerate(lengths):
        for j in range(-(-int(ln) // logical)):
            table[s, j] = next(ids)
    t = lambda a: torch.from_numpy(a).to(dev)
    f32 = lambda *shape: t(rng.standard_normal(shape).astype(np.float32))
    return (f32(s_n, qn, h, d), f32(n_pages, rows, 1, d), f32(s_n, qn, h, d2),
            f32(n_pages, rows, 1, d2), t(table), t(lengths), t(q_lens),
            logical)


@pytest.mark.parametrize("window,cap", [(0, 0.0), (9, 3.0)])
@pytest.mark.parametrize("d,d2", [(16, 8), (512, 64)])
def test_mla_kernel_64_row_blocks(dev, d, d2, window, cap):
    """Launches with many tokens take 64 query rows a block (decode-sized
    ones 32): bf16 and f32 pools within 1e-4 of the plain version, the
    codec bit-identical to the fp kernel on the decoded pools."""
    q, c, q2, pe, table, lengths, q_lens, logical = _mla_long(dev, 17, d, d2)
    assert mla_kernel_info("bfloat16", *q.shape[:3], d, d2)["rows"] == 64
    assert mla_kernel_info("bfloat16", 4, 1, 100, d, d2)["rows"] == 32
    kw = dict(scale=(d // 4 + d2) ** -0.5, page_size=logical, window=window,
              softcap_val=cap)
    for pool_c, pool_pe in ((c, pe), (c.to(torch.bfloat16),
                                      pe.to(torch.bfloat16))):
        got = paged_mixed_attention(q, pool_c, pool_c, table, lengths,
                                    q_lens, q2, pool_pe, **kw)
        want = paged_mixed_attention_plain(q, pool_c, pool_c, table, lengths,
                                           q_lens, q2=q2, k2_pages=pool_pe,
                                           **kw)
        torch.cuda.synchronize()
        rows = torch.arange(q.shape[1], device=dev)[None] < q_lens[:, None]
        torch.testing.assert_close(got[rows], want[rows], atol=1e-4,
                                   rtol=1e-4)
    (cc, cs), (pc, ps) = (kv_codec.encode(x, (-2, -1)) for x in (c, pe))
    cb = kv_codec.codebook(dev)
    cd = decode_pool(cc, cs, cb)
    fp = paged_mixed_attention(q, cd, cd, table, lengths, q_lens, q2,
                               decode_pool(pc, ps, cb), **kw)
    for dequant in ("gather", "onehot"):
        got = paged_mixed_attention(q, cc, cc, table, lengths, q_lens, q2,
                                    pc, cs, cs, ps, cb, dequant=dequant, **kw)
        torch.cuda.synchronize()
        assert torch.equal(got, fp), dequant


def test_mla_wrapper_rejects_what_the_kernel_does_not_take(dev):
    q, c, q2, pe, table, lengths, q_lens, _ = _mla(dev, torch.float32, 13,
                                                   32, 8)
    args = (q, c, c, table, lengths, q_lens)
    with pytest.raises(ValueError, match="q2 and k2_pages"):
        paged_mixed_attention(*args, q2)
    with pytest.raises(ValueError, match="dtype"):
        paged_mixed_attention(*args, q2, pe.to(torch.bfloat16))
    wide = torch.zeros((*q.shape[:3], 96), device=dev)
    with pytest.raises(ValueError, match="exceeds 64"):
        paged_mixed_attention(*args, wide, torch.zeros(
            (*c.shape[:3], 96), device=dev))
    big = torch.zeros((*c.shape[:3], 544), device=dev)
    qbig = torch.zeros((*q.shape[:3], 544), device=dev)
    with pytest.raises(ValueError, match="exceeds 512"):
        paged_mixed_attention(qbig, big, big, table, lengths, q_lens, q2, pe)
    with pytest.raises(ValueError, match="exceed 256"):   # GQA kernel
        paged_mixed_attention(qbig, big, big, table, lengths, q_lens)
    # KH = 2 with the second operand: not MLA's absorbed attention
    c2, pe2 = c.expand(-1, -1, 2, -1).contiguous(), \
        pe.expand(-1, -1, 2, -1).contiguous()
    with pytest.raises(ValueError, match="one latent KV head"):
        paged_mixed_attention(q, c2, c2, table, lengths, q_lens, q2, pe2)
    with pytest.raises(ValueError, match="v_pages must be k_pages"):
        paged_mixed_attention(q, c, c.clone(), table, lengths, q_lens, q2,
                              pe)


# --- binary kernels --------------------------------------------------------

def _signs(rng, shape):
    x = rng.standard_normal(shape).astype(np.float32)
    x[rng.random(shape) < 0.05] = 0.0          # x >= 0 is bit 1 at exactly 0
    return x


@pytest.mark.parametrize("m,k", [(1, 1), (3, 287), (5, 288), (37, 289),
                                 (64, 1000), (1024, 576)])
def test_binarize_pack_kernel_bit_exact_vs_plain(dev, m, k):
    x = torch.from_numpy(_signs(np.random.default_rng(k), (m, k))).to(dev)
    before = binarize_pack.launches
    got = binarize_pack(x)
    torch.cuda.synchronize()
    assert binarize_pack.launches == before + 1
    assert got.shape == (m, -(-k // 288), 9)
    assert torch.equal(got, ref.binarize_pack(x))


def _garbage_words(rng, rows, kw, dev):
    """Random packed words: the bits past k_true are random too."""
    w = rng.integers(0, 1 << 32, (rows, kw), dtype=np.uint64)
    return torch.from_numpy(w.astype(np.uint32).view(np.int32)).to(dev)


@pytest.mark.parametrize("m,n,k,kw", [
    (1, 1, 9, None), (1, 31, 100, None), (65, 33, 288, None),
    (130, 70, 2000, None), (7, 129, 9216, None),
    (37, 33, 400, 13),              # KW not a multiple of 9, padded garbage
    (401408, 64, 32, None),         # ReActNet-A block 0's 1x1 conv
    (1568, 1024, 9216, None),       # block 12's 3x3 conv (KW 288)
    (300, 129, 16400, 513),         # K-chunked slab at 128 columns
    (257, 40, 25000, 800),          # K-chunked slab at 64 columns
    (20000, 129, 16400, 513),       # the same, several M tiles a block
    (40000, 40, 25000, 800),
    (5, 7, 0, 3),                   # k_true 0
    (3, 5, 0, 0)])                  # KW 0
def test_binary_contraction_kernel_bit_exact_vs_plain(dev, m, n, k, kw):
    """Operands packed from signs (``kw`` None) or random words of width
    ``kw`` whose bits past k_true are garbage.  At M 20,000 and 40,000 a
    block stages each chunk of its slab again for each of its M tiles."""
    rng = np.random.default_rng(m * n)
    if kw is None:
        xw = ref.binarize_pack(torch.from_numpy(_signs(rng, (m, k))).to(dev))
        ww = ref.binarize_pack(torch.from_numpy(_signs(rng, (n, k))).to(dev))
        xw, ww = xw.reshape(m, -1), ww.reshape(n, -1)
    else:
        xw, ww = _garbage_words(rng, m, kw, dev), _garbage_words(rng, n, kw,
                                                                 dev)
    before = binary_contraction.launches
    got = binary_contraction(xw, ww, k_true=k)
    torch.cuda.synchronize()
    assert binary_contraction.launches == before + 1
    assert torch.equal(got, ref.popcount_dot(xw, ww, k))
    plan = contraction_plan(m, n, xw.shape[1], sm_count(dev.index))
    assert plan.chunked == (kw in (513, 800))
    if plan.chunked and m >= 20000:
        assert plan.m_splits < -(-m // plan.bm)


@pytest.mark.parametrize("kw", [9, 13, 36])
@pytest.mark.parametrize("offset", [0, 1, 2])
def test_binary_contraction_kernel_unaligned_operands(dev, kw, offset):
    """Operands that start off a 16-byte boundary take the 4-byte copies."""
    rng = np.random.default_rng(kw + offset)
    m, n = 300, 70
    flat = _garbage_words(rng, 1, (m + n) * kw + offset, dev)[0]
    xw = flat[offset:offset + m * kw].view(m, kw)
    ww = flat[offset + m * kw:].view(n, kw)
    got = binary_contraction(xw, ww, k_true=kw * 32 - 5)
    torch.cuda.synchronize()
    assert torch.equal(got, ref.popcount_dot(xw, ww, kw * 32 - 5))


# local (spill) bytes of the contraction kernel as built at 128 registers,
# by slab width, whole slab and chunked (-Xptxas=-v on the H100 machine's
# nvcc 12.9)
CONTRACTION_SPILL_BYTES = {(32, False): 40, (64, False): 48,
                           (128, False): 48, (32, True): 24, (64, True): 24,
                           (128, True): 24}


@pytest.mark.parametrize("chunked", [False, True])
@pytest.mark.parametrize("bn", [32, 64, 128])
def test_contraction_kernel_info_fits_two_blocks_an_sm(dev, bn, chunked):
    """At most 128 registers a thread (two blocks of 256 an SM), and no
    more spilled bytes than the kernel was measured with."""
    info = contraction_kernel_info(bn, chunked)
    assert 0 < info["registers"] <= 128
    assert info["local_bytes"] <= CONTRACTION_SPILL_BYTES[bn, chunked], info


def test_contraction_plan_is_the_walk_the_cpu_tests_emulate(dev):
    """The library's plan equals ``contraction_walk.plan``, which the CPU
    tests emulate, at ReActNet-A's 26 shapes and ragged and chunked ones,
    on this card and on a card of one SM."""
    shapes = [(1, 1, 9), (2, 33, 13), (513, 129, 13), (300, 129, 513),
              (257, 40, 800), (20000, 129, 513), (40000, 40, 800),
              (130, 1024, 288), (5, 7, 0)]
    side, c = -(-RN.image_size // 2), RN.width
    for mult, stride in RN.blocks:
        side = (side - 1) // stride + 1
        m = 32 * side * side
        shapes += [(m, c, 9 * -(-c // 32)), (m, c * mult, 9 * -(-c // 288))]
        c *= mult
    for sms in (sm_count(dev.index), 1):
        for m, n, kw in shapes:
            assert contraction_plan(m, n, kw, sms) == walk.plan(m, n, kw,
                                                                sms)


@pytest.mark.parametrize("gather", ["onehot", "bitplane"])
@pytest.mark.parametrize("codes", [8, 16, 32])
@pytest.mark.parametrize("m,n,k", [(1, 33, 100), (129, 70, 577),
                                   (300, 32, 288)])
def test_fused_kernel_bit_exact_vs_plain(dev, m, n, k, codes, gather):
    rng = np.random.default_rng(k + codes)
    w_bits = (rng.random((n, k)) < 0.3).astype(np.uint8)   # skewed sequences
    words, tables, meta = ops.prepare_compressed_gemm(
        w_bits, cluster=True, gather=gather, codes=codes, device=dev)
    xw = ref.binarize_pack(torch.from_numpy(_signs(rng, (m, k))).to(dev))
    before = fused_decode_matmul.launches
    got = fused_decode_matmul(words, xw, tables, k_true=k, n_true=n,
                              codes=codes)
    torch.cuda.synchronize()
    assert fused_decode_matmul.launches == before + 1
    want = ref.fused_decode_matmul(words, xw, flat_table(tables, dev),
                                   k_true=k, n_true=n, codes=codes)
    assert torch.equal(got, want)


@pytest.mark.parametrize("m,k", [(700, 32), (401, 96), (33, 4), (5, 2304),
                                 (97, 64), (30, 128), (9, 256)])
@pytest.mark.parametrize("offset", [0, 1])
def test_binarize_pack_kernel_runs_and_alignment(dev, m, k, offset):
    """Whole rows of K <= 288 a block (K = 32: ReActNet block 0's 1x1
    activations), and a base that is not 16-byte aligned (the scalar
    load path)."""
    rng = np.random.default_rng(m + k + offset)
    flat = torch.from_numpy(_signs(rng, (m * k + offset,))).to(dev)
    x = flat[offset:].view(m, k)
    got = binarize_pack(x)
    torch.cuda.synchronize()
    assert torch.equal(got, ref.binarize_pack(x))


@pytest.mark.parametrize("cin", [1, 32, 40, 96])
@pytest.mark.parametrize("stride", [1, 2])
@pytest.mark.parametrize("n,h,w", [(2, 7, 7), (2, 9, 5), (1, 1, 1),
                                   (3, 16, 15)])
def test_binarize_pack_patches_kernel_bit_exact_vs_plain(dev, n, h, w, stride,
                                                         cin):
    x = torch.from_numpy(_signs(np.random.default_rng(h * w + cin),
                                (n, h, w, cin))).to(dev)
    before = binarize_pack_patches.launches
    got = binarize_pack_patches(x, stride)
    torch.cuda.synchronize()
    assert binarize_pack_patches.launches == before + 1
    want = ref.binarize_pack_patches(x, stride)
    assert torch.equal(got, want)
    assert torch.equal(got, binarize_pack(ops._im2col_signs(x, stride)[0]))


@pytest.mark.parametrize("gather", ["onehot", "bitplane"])
@pytest.mark.parametrize("codes", [4, 8, 16, 32])
@pytest.mark.parametrize("m,n,k", [(1, 100, 1000), (2000, 150, 2000),
                                   (3, 40, 16400)])
def test_fused_kernel_tables_m1_and_k_chunked(dev, m, n, k, codes, gather):
    """M = 1, several M tiles a block, and K 16,400: at codes 32 its 57
    tiles do not fit in shared memory and the slab is decoded in chunks."""
    rng = np.random.default_rng(m + k + codes)
    w_bits = (rng.random((n, k)) < 0.3).astype(np.uint8)
    words, tables, _ = ops.prepare_compressed_gemm(
        w_bits, cluster=True, gather=gather, codes=codes, device=dev)
    xw = ref.binarize_pack(torch.from_numpy(_signs(rng, (m, k))).to(dev))
    got = fused_decode_matmul(words, xw, tables, k_true=k, n_true=n,
                              codes=codes)
    torch.cuda.synchronize()
    want = ref.fused_decode_matmul(words, xw, flat_table(tables, dev),
                                   k_true=k, n_true=n, codes=codes)
    assert torch.equal(got, want)
    plan = fused_plan(m, *words.shape[:3], codes, sm_count(dev.index))
    assert plan.chunked == (k == 16400 and codes == 32)
    if plan.chunked:                 # chunk starts stay 16-byte aligned
        assert plan.slab_tiles % 4 == 0 and plan.smem_bytes <= 232448


# local (spill) bytes of the slab kernel as built at 128 registers, whole
# slab and chunked (-Xptxas=-v on the H100 machine's nvcc 12.9)
FUSED_SPILL_BYTES = {False: 120, True: 136}


@pytest.mark.parametrize("chunked", [False, True])
@pytest.mark.parametrize("codes", [1, 8, 16, 32])
def test_fused_kernel_info_fits_two_blocks_an_sm(dev, codes, chunked):
    """At most 128 registers a thread (two blocks of 256 an SM), and no
    more spilled bytes than the kernel was measured with."""
    info = fused_kernel_info(codes, chunked)
    assert 0 < info["registers"] <= 128
    assert info["local_bytes"] <= FUSED_SPILL_BYTES[chunked], info


def test_fused_plan_at_reactnet_shapes(dev):
    """ReActNet-A's 13 3x3 convs at batch 32 (codes 8): the whole slab in
    shared memory, two blocks an SM by shared memory, at least one block
    an SM, each tile decoded m_splits times (the first kernel decoded it
    once per 128-row M tile)."""
    sms = sm_count(dev.index)
    side, c = -(-RN.image_size // 2), RN.width
    for mult, stride in RN.blocks:
        side = (side - 1) // stride + 1
        m, nb, gb = 32 * side * side, -(-c // 32), -(-9 * c // 288)
        p = fused_plan(m, nb, gb, 3, 8, sms)
        assert not p.chunked and 2 * p.smem_bytes <= 232448
        assert p.m_splits * nb >= min(sms, -(-m // p.bm) * nb)
        assert p.m_splits <= -(-m // 128)
        c *= mult


def test_binary_conv_paths_agree_on_the_card(dev):
    rng = np.random.default_rng(3)
    x = torch.from_numpy(_signs(rng, (2, 9, 7, 40))).to(dev)
    w = torch.from_numpy(_signs(rng, (33, 40, 3, 3))).to(dev)
    operands = ops.prepare_compressed_conv(
        (w >= 0).cpu().numpy().astype(np.uint8), cluster=False, device=dev)
    for stride in (1, 2):
        want = ref.binary_conv3x3(x, w, stride)
        assert torch.equal(ops.binary_conv3x3(x, w, stride=stride), want)
        assert torch.equal(ops.compressed_binary_conv3x3(
            x, *operands[:2], cin=40, cout=33, stride=stride), want)


def test_binary_wrappers_reject_what_the_kernels_do_not_take(dev):
    x = torch.zeros((4, 300), device=dev)
    with pytest.raises(ValueError, match="contiguous float32"):
        binarize_pack(x.double())
    with pytest.raises(ValueError, match="contiguous float32"):
        binarize_pack(torch.zeros((300, 4), device=dev).T)
    xw = binarize_pack(x).reshape(4, -1)
    with pytest.raises(ValueError, match="contiguous int32"):
        binary_contraction(xw.long(), xw, k_true=300)
    with pytest.raises(ValueError, match="contiguous int32"):
        binary_contraction(xw[:, ::2], xw[:, ::2], k_true=100)
    with pytest.raises(ValueError, match="one card"):
        binary_contraction(xw, xw.cpu(), k_true=300)
    before = binary_contraction.launches
    with pytest.raises(RuntimeError, match="binary_contraction launch"):
        binary_contraction(   # more 128-column slabs than a grid's 65535
            xw[:, :1].contiguous(), torch.zeros(
                (65535 * 128 + 1, 1), dtype=torch.int32, device=dev),
            k_true=0)
    assert binary_contraction.launches == before
    words, tables, _ = ops.prepare_compressed_gemm(
        np.ones((32, 300), np.uint8), device=dev)
    with pytest.raises(ValueError, match="G=1 != weight tiles GB=2"):
        fused_decode_matmul(words, binarize_pack(x[:, :200].contiguous()),
                            tables,
                            k_true=300, n_true=32)
    with pytest.raises(ValueError, match="contiguous int32"):
        fused_decode_matmul(words.long(), binarize_pack(x), tables,
                            k_true=300, n_true=32)
    with pytest.raises(ValueError, match="4 \\* codes must divide"):
        fused_decode_matmul(words, binarize_pack(x), tables, k_true=300,
                            n_true=32, codes=3)

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
from repro_torch.kernels import ref
from repro_torch.kernels.huffman_decode import huffman_decode
from repro_torch.kernels.paged_attention import (paged_mixed_attention,
                                                 paged_mixed_attention_plain)
from repro_torch.runtime.decode_cache import DecodeTileCache
from repro_torch.runtime.weight_store import WeightStore

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


def _paged(dev, dtype, seed):
    """Ragged block (chunk, decode, empty, short chunk) over pools whose
    rows 6..7 are layout padding; later table entries hit the sink."""
    rng = np.random.default_rng(seed)
    s_n, qn, h, kh, d, rows, logical, pps = 4, 6, 8, 2, 128, 8, 6, 5
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

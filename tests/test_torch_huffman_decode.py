"""Tiled Huffman decode: the port's plain version is bit-exact against
``repro.kernels.ref.decode_tiled`` (the CUDA kernel is held to this plain
version on the card by ``tests/test_torch_cuda.py``).

Inputs cover C in {8, 16, 32}, skewed and escape-heavy (uniform)
histograms, a partly padded tail tile, random garbage words whose cursors
run past the last word (the reference's edge rules), and both table
forms (flat 160 and the (5, 9) bit-plane LUT).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import compression as jcomp
from repro.kernels import ref as jref
from repro.kernels.huffman_decode import pack_bitplane_tables
from repro_torch.kernels import ref
from repro_torch.kernels.huffman_decode import (huffman_decode,
                                                unpack_bitplane_tables)
from tests.conftest import skewed_sequences


def _tiles(kind, c, n, seed):
    rng = np.random.default_rng(seed)
    seqs = skewed_sequences(rng, n) if kind == "skewed" else \
        rng.integers(0, 512, n).astype(np.uint16)
    ct = jcomp.compress_sequences(seqs, seqs.shape, "gemm", cluster=False,
                                  codes_per_sub=c)
    return seqs, ct.tiled, ct.decode_tables()


def _as_torch(words):
    return torch.from_numpy(np.ascontiguousarray(words).view(np.int32))


@pytest.mark.parametrize("table_form", ["flat", "bitplane"])
@pytest.mark.parametrize("c", [8, 16, 32])
@pytest.mark.parametrize("kind", ["skewed", "uniform"])
def test_plain_bit_exact_vs_reference(kind, c, table_form):
    n = 3 * 128 * c + 77                          # partly padded tail tile
    seqs, ts, tables = _tiles(kind, c, n, seed=c)
    want = np.asarray(jref.decode_tiled(jnp.asarray(ts.words),
                                        jnp.asarray(tables), c))
    tab = tables if table_form == "flat" else pack_bitplane_tables(tables)
    got = huffman_decode(_as_torch(ts.words), torch.from_numpy(
        np.asarray(tab).view(np.int32)), c=c)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(
        ref.tiled_to_sequences(got, ts.n_seqs).numpy(), seqs)


@pytest.mark.parametrize("w_rows", [1, 2, 3])
def test_garbage_words_follow_reference_edge_rules(w_rows):
    """Random words decode to long codes whose cursor leaves the tile:
    the word past the end reads 0 and the next-word index clamps."""
    rng = np.random.default_rng(w_rows)
    words = rng.integers(0, 2 ** 32, (4, w_rows, 128), dtype=np.uint64) \
        .astype(np.uint32)
    tables = rng.integers(0, 512, 160).astype(np.int32)
    want = np.asarray(jref.decode_tiled(jnp.asarray(words),
                                        jnp.asarray(tables), 16))
    got = huffman_decode(_as_torch(words), torch.from_numpy(tables), c=16)
    np.testing.assert_array_equal(got.numpy(), want)


def test_bitplane_unpack_inverts_pack(rng):
    tables = rng.integers(0, 512, 160).astype(np.int32)
    np.testing.assert_array_equal(
        unpack_bitplane_tables(pack_bitplane_tables(tables)), tables)


def test_plain_path_does_not_count_launches():
    _, ts, tables = _tiles("skewed", 8, 2048, seed=1)
    before = huffman_decode.launches
    huffman_decode(_as_torch(ts.words), torch.from_numpy(tables), c=8)
    assert huffman_decode.launches == before


def test_rejects_other_devices_and_tables():
    words = torch.zeros((1, 2, 128), dtype=torch.int32, device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        huffman_decode(words, torch.zeros(160, dtype=torch.int32), c=8)
    with pytest.raises(ValueError, match="decode table"):
        huffman_decode(torch.zeros((1, 2, 128), dtype=torch.int32),
                       torch.zeros(100, dtype=torch.int32), c=8)

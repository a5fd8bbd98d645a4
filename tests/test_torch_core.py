"""The port's at-rest format is byte-identical to ``repro.core``.

Every name of ``repro.core`` that the port copies gives the reference's
values, dtypes and bytes on seeded inputs (the offline tooling of the
paper's workflow: bit views, conv packing, frequency tables, the full
Huffman bound, the clustering invariant, conv and model compression).

Stream words, tiled words and decode tables from ``repro_torch.core``
must equal the reference's on skewed (ReActNet-like) and uniform
(escape-heavy) histograms, with and without clustering; and the port's
registration-time tiling must equal the reference's first-use path
(``decode_stream`` -> ``tile_stream``).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import binarize as jbinarize
from repro.core import bitpack as jbitpack
from repro.core import clustering as jclustering
from repro.core import compression as jcomp
from repro.core import frequency as jfrequency
from repro.core import huffman as jhuff
from repro.core.binarize import binarize_weights as jax_binarize_weights
from repro.core.binarize import ste_sign as jax_ste_sign
from repro.runtime.weight_store import WeightStore as JaxWeightStore
from repro_torch.core import (binarize, bitpack, clustering, compression,
                              frequency, huffman)
from repro_torch.core.binarize import binarize_weights, ste_sign
from repro_torch.kernels import ref
from repro_torch.runtime.weight_store import WeightStore
from tests.conftest import skewed_sequences


def _sequences(kind, rng, n):
    if kind == "skewed":
        return skewed_sequences(rng, n)
    return rng.integers(0, 512, n).astype(np.uint16)   # mostly escapes


@pytest.mark.parametrize("cluster", [False, True])
@pytest.mark.parametrize("kind,n,c", [("skewed", 5000, 8),
                                      ("uniform", 3000, 8),
                                      ("skewed", 4100, 32)])
def test_compress_sequences_byte_identical(rng, kind, n, c, cluster):
    seqs = _sequences(kind, rng, n)
    got = compression.compress_sequences(seqs, seqs.shape, "gemm",
                                         cluster=cluster, codes_per_sub=c)
    want = jcomp.compress_sequences(seqs, seqs.shape, "gemm",
                                    cluster=cluster, codes_per_sub=c)
    assert got.stream_bits == want.stream_bits
    np.testing.assert_array_equal(got.stream_words, want.stream_words)
    assert got.stream_words.dtype == want.stream_words.dtype == np.uint32
    np.testing.assert_array_equal(got.tiled.words, want.tiled.words)
    np.testing.assert_array_equal(got.decode_tables(), want.decode_tables())
    assert (got.replacement is None) == (want.replacement is None)
    if cluster:
        np.testing.assert_array_equal(got.replacement, want.replacement)


def test_gemm_bits_roundtrip_matches_reference(rng):
    bits = (rng.standard_normal((37, 100)) >= 0).astype(np.uint8)
    seqs = bitpack.gemm_to_sequences(bits)
    np.testing.assert_array_equal(seqs, jbitpack.gemm_to_sequences(bits))
    dev = ref.sequences_to_gemm(torch.from_numpy(seqs.astype(np.int32)), 100)
    np.testing.assert_array_equal(dev.numpy(), bits)


@pytest.mark.parametrize("cluster", [False, True])
def test_registration_tiling_equals_decode_then_tile(rng, cluster):
    """The port tiles at registration from the sequences just encoded; the
    reference re-decodes the stream on first use and tiles that.  Same
    words, same tables, same per-tile frequency prior."""
    w = rng.standard_normal((2, 45, 96)).astype(np.float32)
    tree = {"scan": {"b0": {"mlp": {"up": w}}}}
    jstore = JaxWeightStore()
    jstore.register_model("m", tree, cluster=cluster)
    store = WeightStore()
    store.register_model("m", {"scan": {"b0": {"mlp": {
        "up": torch.from_numpy(w)}}}}, cluster=cluster)
    for jl, pl in zip(jstore.layers("m")["scan/b0/mlp/up"],
                      store.layers("m")["scan/b0/mlp/up"]):
        ts = jl.ensure_tiled()
        seqs = jhuff.decode_stream(jl.ct.stream_words, jl.ct.stream_bits,
                                   jl.ct.assign, count=jl.ct.n_seqs)
        np.testing.assert_array_equal(
            jcomp.tile_stream(seqs, jl.ct.assign).words, pl.tiled.words)
        np.testing.assert_array_equal(ts.words, pl.tiled.words)
        np.testing.assert_array_equal(pl.words.numpy().view(np.uint32),
                                      ts.words)
        np.testing.assert_array_equal(jl.tables, pl.tables.numpy())
        np.testing.assert_array_equal(jl.tile_freq, pl.tile_freq)
        np.testing.assert_array_equal(jl.scale, pl.scale)
        np.testing.assert_array_equal(jl.ct.stream_words, pl.ct.stream_words)
    assert jstore.report("m") == store.report("m")


def test_ste_sign_and_binarize_match_reference(rng):
    x = rng.standard_normal((6, 10)).astype(np.float32) * 2
    x[0, 0] = 0.0
    xt = torch.from_numpy(x).requires_grad_(True)
    y = ste_sign(xt)
    np.testing.assert_array_equal(y.detach().numpy(),
                                  np.asarray(jax_ste_sign(jnp.asarray(x))))
    y.sum().backward()
    jg = jax.grad(lambda v: jax_ste_sign(v).sum())(jnp.asarray(x))
    np.testing.assert_array_equal(xt.grad.numpy(), np.asarray(jg))
    np.testing.assert_allclose(
        binarize_weights(torch.from_numpy(x)).numpy(),
        np.asarray(jax_binarize_weights(jnp.asarray(x))), rtol=1e-6)


# --- the offline tooling of the paper's workflow ---------------------------

def _same(got, want):
    got, want = np.asarray(got), np.asarray(want)
    assert got.dtype == want.dtype and got.shape == want.shape
    assert got.tobytes() == want.tobytes()


def _conv_bits(rng, cout=8, cin=64, skew=True):
    seqs = skewed_sequences(rng, cout * cin) if skew else \
        rng.integers(0, 512, cout * cin).astype(np.uint16)
    return jbitpack.sequences_to_kernel(seqs.reshape(cout, cin))


def test_bit_views_match_reference(rng):
    x = rng.standard_normal((5, 7)).astype(np.float32)
    x[0, :3] = [0.0, -0.0, -1e-30]
    _same(bitpack.to_bits(x), jbitpack.to_bits(x))
    b = jbitpack.to_bits(x)
    _same(bitpack.from_bits(b), jbitpack.from_bits(b))
    seqs = rng.integers(0, 512, (6, 11)).astype(np.uint16)
    _same(bitpack.sequences_to_kernel(seqs), jbitpack.sequences_to_kernel(seqs))
    np.testing.assert_array_equal(
        bitpack.kernel_to_sequences(bitpack.sequences_to_kernel(seqs)), seqs)


def test_binarize_activations_and_weight_bits_match_reference(rng):
    x = rng.standard_normal((4, 9)).astype(np.float32)
    x[0, 0] = 0.0
    xt = torch.from_numpy(x).requires_grad_(True)
    y = binarize.binarize_activations(xt)
    _same(y.detach().numpy(), jbinarize.binarize_activations(jnp.asarray(x)))
    (g,) = torch.autograd.grad(y.sum(), xt)
    _same(g.numpy(), jax.grad(
        lambda v: jbinarize.binarize_activations(v).sum())(jnp.asarray(x)))
    wb = binarize.weight_bits(torch.from_numpy(x))
    assert wb.dtype == torch.uint8
    _same(wb.numpy(), jbinarize.weight_bits(jnp.asarray(x)))


@pytest.mark.parametrize("shape,axis", [((3, 64), -1), ((64, 5), 0),
                                        ((2, 96, 3), 1)])
def test_unpack_bits_matches_reference(rng, shape, axis):
    bits = (rng.random(shape) < 0.5).astype(np.uint8)
    words = jbitpack.pack_bits(bits, axis=axis)
    _same(bitpack.pack_bits(bits, axis=axis), words)
    _same(bitpack.unpack_bits(words, axis=axis),
          jbitpack.unpack_bits(words, axis=axis))
    _same(bitpack.unpack_bits(words, axis=axis), bits)


@pytest.mark.parametrize("cout,cin", [(8, 32), (5, 96)])
def test_channel_pack_conv_matches_reference(rng, cout, cin):
    w = _conv_bits(rng, cout, cin, skew=False)
    words = jbitpack.channel_pack_conv(w)
    _same(bitpack.channel_pack_conv(w), words)
    _same(bitpack.channel_unpack_conv(words),
          jbitpack.channel_unpack_conv(words))
    _same(bitpack.channel_unpack_conv(words), w)


@pytest.mark.parametrize("k", [288, 100, 577])
def test_unpack_gemm_operand_matches_reference(rng, k):
    bits = (rng.random((7, k)) < 0.5).astype(np.uint8)
    words = jbitpack.pack_gemm_operand(bits)
    _same(bitpack.unpack_gemm_operand(words, k),
          jbitpack.unpack_gemm_operand(words, k))
    _same(bitpack.unpack_gemm_operand(words, k), bits)


@pytest.mark.parametrize("kind", ["skewed", "uniform", "empty"])
def test_frequency_tables_match_reference(rng, kind):
    hists = [np.zeros(512, np.int64)] if kind == "empty" else [
        jfrequency.sequence_histogram(_sequences(kind, rng, n))
        for n in (700, 3000)]
    for h in hists:
        for k in (1, 16, 64, 256, 512):
            assert frequency.top_k_share(h, k) == jfrequency.top_k_share(h, k)
    got, want = frequency.block_table(hists), jfrequency.block_table(hists)
    assert [dataclasses.asdict(r) for r in got] == \
        [dataclasses.asdict(r) for r in want]


@pytest.mark.parametrize("shares,total,seed", [
    ((0.46, 0.24, 0.23, 0.05), 4096, 0), ((0.25, 0.25, 0.25, 0.25), 999, 3)])
def test_synthetic_histogram_matches_reference(shares, total, seed):
    got = frequency.synthetic_histogram(shares, total,
                                        np.random.default_rng(seed))
    _same(got, jfrequency.synthetic_histogram(shares, total,
                                              np.random.default_rng(seed)))
    assert got.sum() == total


@pytest.mark.parametrize("kind", ["skewed", "uniform", "one"])
def test_huffman_bounds_and_node_stats_match_reference(rng, kind):
    if kind == "one":
        h = np.zeros(512, np.int64)
        h[7] = 40
    else:
        h = jfrequency.sequence_histogram(_sequences(kind, rng, 4000))
    _same(huffman.full_huffman_lengths(h), jhuff.full_huffman_lengths(h))
    assert huffman.full_huffman_avg_bits(h) == jhuff.full_huffman_avg_bits(h)
    got, want = huffman.assign_nodes(h), jhuff.assign_nodes(h)
    assert got.compression_ratio(h) == want.compression_ratio(h)
    _same(got.node_shares(h), want.node_shares(h))
    # the 4-node code never beats the optimal one
    assert huffman.full_huffman_avg_bits(h) <= got.avg_bits(h)


@pytest.mark.parametrize("m,n", [(64, 256), (16, 500)])
def test_max_weight_flips_matches_reference(rng, m, n):
    seqs = _sequences("skewed", rng, 5000)
    _, repl = clustering.apply_clustering(seqs, m=m, n=n)
    _, jrepl = jclustering.apply_clustering(seqs, m=m, n=n)
    _same(repl, jrepl)
    assert clustering.max_weight_flips(repl) == \
        jclustering.max_weight_flips(jrepl) <= 1


def _same_ct(got, want):
    assert got.kind == want.kind and got.seq_shape == want.seq_shape
    assert tuple(got.orig_shape) == tuple(want.orig_shape)
    assert got.stream_bits == want.stream_bits
    _same(got.stream_words, want.stream_words)
    _same(got.decode_tables(), want.decode_tables())
    _same(got.assign.node_of, want.assign.node_of)
    _same(got.assign.index_of, want.assign.index_of)
    assert (got.replacement is None) == (want.replacement is None)
    if want.replacement is not None:
        _same(got.replacement, want.replacement)
    assert (got.tiled is None) == (want.tiled is None)
    if want.tiled is not None:
        _same(got.tiled.words, want.tiled.words)
        assert got.tiled.stored_bits() == want.tiled.stored_bits()
        assert got.ratio_tiled() == want.ratio_tiled()
    assert got.ratio_stream() == want.ratio_stream()


@pytest.mark.parametrize("cluster", [False, True])
@pytest.mark.parametrize("tiled", [True, False])
def test_compress_conv3x3_and_decompress_match_reference(rng, cluster, tiled):
    w = _conv_bits(rng, 16, 64)
    got = compression.compress_conv3x3(w, cluster=cluster, tiled=tiled)
    want = jcomp.compress_conv3x3(w, cluster=cluster, tiled=tiled)
    _same_ct(got, want)
    _same(compression.decompress(got), jcomp.decompress(want))
    if not cluster:
        _same(compression.decompress(got), w)


@pytest.mark.parametrize("k", [72, 100])
def test_compress_gemm_and_decompress_match_reference(rng, k):
    bits = (rng.random((24, k)) < 0.3).astype(np.uint8)
    got = compression.compress_gemm(bits, cluster=False)
    want = jcomp.compress_gemm(bits, cluster=False)
    _same_ct(got, want)
    _same(compression.decompress(got), bits)
    _same(compression.decompress(got), jcomp.decompress(want))


@pytest.mark.parametrize("cluster", [False, True])
def test_compress_model_matches_reference(rng, cluster):
    tensors = {"block0/w3": _conv_bits(rng, 8, 32),
               "block1/w3": _conv_bits(rng, 16, 64, skew=False),
               "block0/w1": (rng.random((64, 32)) < 0.5).astype(np.uint8)}
    got, rep = compression.compress_model(tensors, fp_bits=12345,
                                          cluster=cluster)
    want, jrep = jcomp.compress_model(tensors, fp_bits=12345, cluster=cluster)
    assert list(got) == list(want)
    for name in want:
        _same_ct(got[name], want[name])
    assert dataclasses.asdict(rep) == dataclasses.asdict(jrep)
    assert (rep.binary_ratio, rep.model_ratio) == \
        (jrep.binary_ratio, jrep.model_ratio)

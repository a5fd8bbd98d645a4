"""The port's at-rest format is byte-identical to ``repro.core``.

Stream words, tiled words and decode tables from ``repro_torch.core``
must equal the reference's on skewed (ReActNet-like) and uniform
(escape-heavy) histograms, with and without clustering; and the port's
registration-time tiling must equal the reference's first-use path
(``decode_stream`` -> ``tile_stream``).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import bitpack as jbitpack
from repro.core import compression as jcomp
from repro.core import huffman as jhuff
from repro.core.binarize import binarize_weights as jax_binarize_weights
from repro.core.binarize import ste_sign as jax_ste_sign
from repro.runtime.weight_store import WeightStore as JaxWeightStore
from repro_torch.core import bitpack, compression
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

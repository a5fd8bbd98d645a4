"""The port's binary kernels' plain versions, ops and at-rest fused layout
against the JAX reference.

The same numpy-seeded inputs go through ``repro`` and ``repro_torch``.
Everything here is integer arithmetic, or float arithmetic on +-1 values
whose sums are exact, so every comparison is exact.  The reference's
Pallas BNN kernels do not run on the installed jax (ROADMAP "Reference
caveats"), so the port is held to the reference's pure-jnp oracles
(``repro.kernels.ref``) and its numpy compression.  On CPU tensors the
kernel wrappers take their plain versions; the kernels themselves are
held to those on the card by ``tests/test_torch_cuda.py``.
"""

import shutil

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import bitpack as jbitpack
from repro.core import compression as jcomp
from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro.kernels.huffman_decode import \
    pack_bitplane_tables as jax_pack_bitplane_tables
from repro_torch.core import bitpack, compression
from repro_torch.kernels import _build, ops, ref
from repro_torch.kernels.binarize_pack import binarize_pack
from repro_torch.kernels.binary_contraction import binary_contraction
from repro_torch.kernels.fused_decode_contraction import fused_decode_matmul
from repro_torch.kernels.huffman_decode import pack_bitplane_tables


def _u32(t: torch.Tensor) -> np.ndarray:
    """int32 view of packed words -> the reference's uint32 words."""
    return t.numpy().view(np.uint32)


def _reals(rng, shape):
    x = rng.standard_normal(shape).astype(np.float32)
    x[rng.random(shape) < 0.05] = 0.0          # x >= 0 is bit 1 at exactly 0
    return x


def _skewed_bits(rng, shape):
    """Bits with a skewed sequence histogram (mostly -1s), so clustering
    finds rare sequences to fold."""
    return (rng.random(shape) < 0.2).astype(np.uint8)


# --- at-rest layout --------------------------------------------------------

FUSED_SHAPES = [(70, 400), (33, 100), (64, 576), (5, 13), (40, 1000)]


@pytest.mark.parametrize("cluster", [False, True])
@pytest.mark.parametrize("codes", [8, 32])
@pytest.mark.parametrize("n,k", FUSED_SHAPES)
def test_compress_gemm_fused_byte_identical(rng, n, k, codes, cluster):
    """Words, tables, n_true and k_true, with and without clustering, for
    K a multiple of 288 and not even of 9."""
    w_bits = _skewed_bits(rng, (n, k))
    got = compression.compress_gemm_fused(w_bits, codes_per_sub=codes,
                                          cluster=cluster)
    want = jcomp.compress_gemm_fused(w_bits, codes_per_sub=codes,
                                     cluster=cluster)
    assert got.words.dtype == want.words.dtype == np.uint32
    np.testing.assert_array_equal(got.words, want.words)
    np.testing.assert_array_equal(got.ct.decode_tables(),
                                  want.ct.decode_tables())
    assert (got.n_true, got.k_true) == (want.n_true, want.k_true) == (n, k)
    assert got.ratio_tiled() == want.ratio_tiled()
    assert got.ct.ratio_stream() == want.ct.ratio_stream()


@pytest.mark.parametrize("cluster", [False, True])
def test_decompress_fused_matches_reference(rng, cluster):
    w_bits = _skewed_bits(rng, (37, 301))
    got = compression.decompress_fused(
        compression.compress_gemm_fused(w_bits, cluster=cluster))
    want = jcomp.decompress_fused(
        jcomp.compress_gemm_fused(w_bits, cluster=cluster))
    np.testing.assert_array_equal(got, want)
    if not cluster:
        np.testing.assert_array_equal(got, w_bits)
    else:   # the K-padding column group (301 % 9 = 4 bits) is never folded
        np.testing.assert_array_equal(got[:, 297:], w_bits[:, 297:])


def test_bitpack_copies_match_reference(rng):
    w4 = (rng.random((6, 5, 3, 3)) < 0.5).astype(np.uint8)
    np.testing.assert_array_equal(bitpack.kernel_to_sequences(w4),
                                  jbitpack.kernel_to_sequences(w4))
    bits = (rng.random((7, 601)) < 0.5).astype(np.uint8)
    seqs = bitpack.gemm_to_sequences(bits)
    np.testing.assert_array_equal(bitpack.sequences_to_gemm(seqs, 601),
                                  jbitpack.sequences_to_gemm(seqs, 601))
    np.testing.assert_array_equal(bitpack.pack_gemm_operand(bits),
                                  jbitpack.pack_gemm_operand(bits))
    assert [bitpack.pad_k(k) for k in (1, 288, 289)] == \
        [jbitpack.pad_k(k) for k in (1, 288, 289)] == [288, 288, 576]


def test_bitplane_tables_match_reference(rng):
    tables = rng.integers(0, 512, 160).astype(np.int32)
    np.testing.assert_array_equal(pack_bitplane_tables(tables),
                                  jax_pack_bitplane_tables(tables))


# --- plain versions (kernels/ref.py) ---------------------------------------

@pytest.mark.parametrize("m,k", [(1, 1), (3, 287), (5, 288), (4, 600)])
def test_pack_and_binarize_match_reference(rng, m, k):
    x = _reals(rng, (m, k))
    bits = (x >= 0).astype(np.uint32)
    want = np.asarray(jref.pack_bits_runtime(jnp.asarray(bits)))
    np.testing.assert_array_equal(
        _u32(ref.pack_bits_runtime(torch.from_numpy(bits))), want)
    np.testing.assert_array_equal(
        _u32(ref.binarize_pack(torch.from_numpy(x))),
        np.asarray(jref.binarize_pack(jnp.asarray(x))))
    np.testing.assert_array_equal(
        _u32(ref.pack_bits_runtime(torch.from_numpy(bits))),
        jbitpack.pack_gemm_operand(bits.astype(np.uint8)))


def test_pack_sequences_matches_reference(rng):
    seqs = rng.integers(0, 512, (6, 64)).astype(np.int32)
    np.testing.assert_array_equal(
        _u32(ref.pack_sequences(torch.from_numpy(seqs))),
        np.asarray(jref.pack_sequences(jnp.asarray(seqs))))


@pytest.mark.parametrize("m,n,k", [(1, 1, 9), (5, 11, 600), (33, 7, 2000)])
def test_popcount_dot_and_binary_matmul_match_reference(rng, m, n, k):
    x, w = _reals(rng, (m, k)), _reals(rng, (n, k))
    xw, ww = jref.binarize_pack(jnp.asarray(x)), jref.binarize_pack(
        jnp.asarray(w))
    got = ref.popcount_dot(ref.binarize_pack(torch.from_numpy(x)),
                           ref.binarize_pack(torch.from_numpy(w)), k)
    np.testing.assert_array_equal(got.numpy(),
                                  np.asarray(jref.popcount_dot(xw, ww, k)))
    np.testing.assert_array_equal(
        ref.binary_matmul(torch.from_numpy(x), torch.from_numpy(w)).numpy(),
        np.asarray(jref.binary_matmul(jnp.asarray(x), jnp.asarray(w))))


@pytest.mark.parametrize("stride", [1, 2])
def test_binary_conv3x3_matches_reference(rng, stride):
    x, w = _reals(rng, (2, 9, 7, 40)), _reals(rng, (33, 40, 3, 3))
    np.testing.assert_array_equal(
        ref.binary_conv3x3(torch.from_numpy(x), torch.from_numpy(w),
                           stride).numpy(),
        np.asarray(jref.binary_conv3x3(jnp.asarray(x), jnp.asarray(w),
                                       stride=stride)))


# --- wrappers on CPU tensors take the plain versions -----------------------

def test_wrappers_take_the_plain_versions_on_cpu(rng):
    x = torch.from_numpy(_reals(rng, (6, 300)))
    w_bits = _skewed_bits(rng, (40, 300))
    words, tables, meta = ops.prepare_compressed_gemm(w_bits, device="cpu")
    before = (binarize_pack.launches, binary_contraction.launches,
              fused_decode_matmul.launches)
    xw = binarize_pack(x)
    assert torch.equal(xw, ref.binarize_pack(x))
    flat = xw.reshape(6, -1)
    assert torch.equal(binary_contraction(flat, flat, k_true=300),
                       ref.popcount_dot(flat, flat, 300))
    fused_decode_matmul(words, xw, tables, k_true=300, n_true=40)
    assert (binarize_pack.launches, binary_contraction.launches,
            fused_decode_matmul.launches) == before


def test_wrappers_reject_mismatched_operands(rng):
    xw = ref.binarize_pack(torch.from_numpy(_reals(rng, (4, 300))))
    with pytest.raises(ValueError, match="k_true"):
        binary_contraction(xw.reshape(4, -1), xw.reshape(4, -1), k_true=600)
    words, tables, _ = ops.prepare_compressed_gemm(
        _skewed_bits(rng, (32, 600)), device="cpu")
    with pytest.raises(ValueError, match="G=2 != weight tiles GB=3"):
        fused_decode_matmul(words, xw, tables, k_true=600, n_true=32)
    with pytest.raises(ValueError, match="n_true"):
        fused_decode_matmul(words, ref.binarize_pack(torch.zeros(1, 600)),
                            tables, k_true=600, n_true=33)


# --- ops -------------------------------------------------------------------

@pytest.mark.parametrize("gather", ["onehot", "bitplane"])
def test_prepare_compressed_gemm_matches_reference(rng, gather):
    w_bits = _skewed_bits(rng, (45, 500))
    words, tables, meta = ops.prepare_compressed_gemm(
        w_bits, gather=gather, codes=16, device="cpu")
    jw, jt, jmeta = jops.prepare_compressed_gemm(w_bits, gather=gather,
                                                 codes=16)
    np.testing.assert_array_equal(_u32(words), np.asarray(jw))
    np.testing.assert_array_equal(tables.numpy().view(np.asarray(jt).dtype),
                                  np.asarray(jt))
    assert meta == jmeta


@pytest.mark.parametrize("gather", ["onehot", "bitplane"])
@pytest.mark.parametrize("codes", [8, 16, 32])
def test_compressed_binary_matmul_matches_reference(rng, codes, gather):
    """The fused path equals ``ref.binary_matmul`` on the reference's
    decompressed (clustered) weights."""
    x = _reals(rng, (9, 700))
    w_bits = _skewed_bits(rng, (70, 700))
    words, tables, meta = ops.prepare_compressed_gemm(
        w_bits, cluster=True, gather=gather, codes=codes, device="cpu")
    got = ops.compressed_binary_matmul(
        torch.from_numpy(x), words, tables, k_true=meta["k_true"],
        n_true=meta["n_true"], codes=codes)
    rec = jcomp.decompress_fused(jcomp.compress_gemm_fused(
        w_bits, cluster=True, codes_per_sub=codes))
    want = jref.binary_matmul(jnp.asarray(x),
                              jnp.asarray(jbitpack.from_bits(rec)))
    assert got.dtype == torch.float32
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_binary_matmul_matches_reference(rng):
    x, w = _reals(rng, (13, 333)), _reals(rng, (21, 333))
    np.testing.assert_array_equal(
        ops.binary_matmul(torch.from_numpy(x), torch.from_numpy(w)).numpy(),
        np.asarray(jref.binary_matmul(jnp.asarray(x), jnp.asarray(w))))


@pytest.mark.parametrize("stride", [1, 2])
def test_im2col_order_matches_reference(rng, stride):
    """Patch features are (Cin, kh, kw), channel outermost, as
    ``conv_general_dilated_patches`` orders them."""
    x = _reals(rng, (2, 6, 5, 4))
    cols, shape = ops._im2col_bits(torch.from_numpy(x), stride)
    jcols, jshape = jops._im2col_bits(jnp.asarray(x), stride)
    assert shape == jshape
    np.testing.assert_array_equal(cols.numpy(), np.asarray(jcols))


@pytest.mark.parametrize("stride", [1, 2])
def test_binary_conv_paths_match_reference(rng, stride):
    x, w = _reals(rng, (2, 9, 7, 40)), _reals(rng, (33, 40, 3, 3))
    want = np.asarray(jref.binary_conv3x3(jnp.asarray(x), jnp.asarray(w),
                                          stride=stride))
    xt, wt = torch.from_numpy(x), torch.from_numpy(w)
    np.testing.assert_array_equal(
        ops.binary_conv3x3(xt, wt, stride=stride).numpy(), want)
    for gather in ("onehot", "bitplane"):
        words, tables, _ = ops.prepare_compressed_conv(
            (w >= 0).astype(np.uint8), cluster=False, gather=gather,
            device="cpu")
        got = ops.compressed_binary_conv3x3(xt, words, tables, cin=40,
                                            cout=33, stride=stride)
        np.testing.assert_array_equal(got.numpy(), want)


def test_decode_sequences_matches_reference(rng):
    seqs = rng.integers(0, 512, 3000).astype(np.uint16)
    ct = compression.compress_sequences(seqs, seqs.shape, "gemm",
                                        cluster=False)
    words = torch.from_numpy(ct.tiled.words.view(np.int32))
    got = ops.decode_sequences(words, torch.from_numpy(ct.decode_tables()),
                               c=ct.tiled.c, n_seqs=3000)
    want = jref.tiled_to_sequences(jref.decode_tiled(
        jnp.asarray(ct.tiled.words), jnp.asarray(ct.decode_tables()),
        ct.tiled.c), 3000)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    np.testing.assert_array_equal(got.numpy(), seqs)


# --- build: a shared header is part of every library that includes it ------

def test_build_target_hashes_included_headers(tmp_path, monkeypatch):
    csrc = tmp_path / "csrc"
    shutil.copytree(_build.CSRC, csrc)
    monkeypatch.setattr(_build, "CSRC", csrc)
    assert {p.name for p in _build._sources("fused_decode_contraction")} \
        == {"fused_decode_contraction.cu", "binary_mma.cuh",
            "huffman_decode_step.cuh"}
    for header, users in (
            ("huffman_decode_step.cuh",
             {"huffman_decode", "fused_decode_contraction"}),
            ("binary_mma.cuh",
             {"binary_contraction", "fused_decode_contraction"})):
        before = {name: _build._target(name) for name in _build.KERNELS}
        path = csrc / header
        path.write_bytes(path.read_bytes() + b"\n// edited\n")
        after = {name: _build._target(name) for name in _build.KERNELS}
        assert {name for name in _build.KERNELS
                if before[name] != after[name]} == users

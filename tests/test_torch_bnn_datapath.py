"""The BNN datapath's two Hopper kernels, on the CPU: the patch pack's
plain version against the JAX reference, and numpy emulations of the
kernels' arithmetic and tiling against the plain versions.

``csrc/binarize_pack.cu`` and ``csrc/fused_decode_contraction.cu`` run
only on the card.  What they compute is emulated here step by step: the
tilings the wrappers pass them (:func:`pack_plan`, :func:`patch_plan`),
the sign words staged in shared memory, the funnel-shift cut of each
9-bit sequence and the 9 ballots, the per-block walk over M tiles with
each weight slab decoded once (or once a chunk, at chunk sizes the
kernel's own plan may pick; the card tests read that plan), and the
binary tensor-core products (AND-popcounts, with the rows' set bits as
the correction).  The int8 tensor-core route that the kernel's probe
times against them is emulated too.  All of it is integer arithmetic, so
every comparison is exact.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro_torch.kernels import ops, ref
from repro_torch.kernels.binarize_pack import (PACK_MAX_BLOCKS,
                                               binarize_pack,
                                               binarize_pack_patches,
                                               pack_plan, patch_plan)
from repro_torch.kernels.binary_contraction import binary_contraction
from repro_torch.kernels.fused_decode_contraction import fused_decode_matmul
from repro_torch.kernels.huffman_decode import flat_table
from repro_torch.models.reactnet import CONFIG as RN

U32 = 0xFFFFFFFF
H100_SMS = 132
POISON = 0xDEADBEEF         # shared memory the kernels never wrote
SMEM_DEFAULT = 48 * 1024    # the default dynamic shared memory of a block


def _u32(t: torch.Tensor) -> np.ndarray:
    return t.numpy().view(np.uint32)


def _reals(rng, shape):
    """Reals with exact zeros and negative zeros (both are bit 1)."""
    x = rng.standard_normal(shape).astype(np.float32)
    x[rng.random(shape) < 0.05] = 0.0
    x[rng.random(shape) < 0.05] = -0.0
    return x


def _sign_words(flat: np.ndarray, vec: bool) -> np.ndarray:
    """The kernels' load phase: natural sign words of a run of floats (bit
    b % 32 of word b / 32 is element b >= 0).  ``vec``: a lane's float4
    gives a nibble, and the 8 lanes of a word OR them at 4 * (lane % 8)."""
    n = flat.size
    bits = np.zeros(-(-n // 32) * 32, np.uint64)
    bits[:n] = flat >= 0
    if vec:
        nib = (bits.reshape(-1, 4) << np.arange(4, dtype=np.uint64)).sum(1)
        lanes = nib.reshape(-1, 8) << (4 * np.arange(8, dtype=np.uint64))
        return np.bitwise_or.reduce(lanes, axis=1).astype(np.uint32)
    return (bits.reshape(-1, 32)
            << np.arange(32, dtype=np.uint64)).sum(1).astype(np.uint32)


def _ballots(lane_vals: np.ndarray) -> np.ndarray:
    """9 warp ballots: word j has bit i = bit j of lane i's value."""
    bits = (lane_vals[None, :] >> np.arange(9, dtype=np.uint64)[:, None]) & 1
    return (bits.astype(np.uint64) << np.arange(32, dtype=np.uint64)).sum(
        1).astype(np.uint32)


# --- the patch pack: plain version vs the JAX reference ---------------------

PATCH_SIDES = [(1, 1), (1, 4), (2, 3), (5, 5), (6, 7), (8, 8)]


@pytest.mark.parametrize("cin", [1, 32, 40, 96])
@pytest.mark.parametrize("stride", [1, 2])
@pytest.mark.parametrize("h,w", PATCH_SIDES)
def test_patch_pack_plain_matches_reference(h, w, stride, cin):
    """Word for word ``pack_bits_runtime(_im2col_bits(x, stride))`` of the
    reference, and the port's own im2col + ``binarize_pack``."""
    x = _reals(np.random.default_rng(1000 * h + 10 * w + cin),
               (2, h, w, cin))
    jcols, _ = jops._im2col_bits(jnp.asarray(x), stride)
    want = np.asarray(jref.pack_bits_runtime(jcols.astype(jnp.uint32)))
    got = ref.binarize_pack_patches(torch.from_numpy(x), stride)
    ho, wo = (h - 1) // stride + 1, (w - 1) // stride + 1
    assert got.shape == (2 * ho * wo, -(-cin // 32), 9)
    np.testing.assert_array_equal(_u32(got), want)
    cols, _ = ops._im2col_signs(torch.from_numpy(x), stride)
    assert torch.equal(got, ref.binarize_pack(cols))


# --- the patch kernel, emulated --------------------------------------------

def _emulate_patch_kernel(x: np.ndarray, stride: int, sms: int):
    """csrc/binarize_pack.cu::binarize_pack_patches_kernel block by block
    -> (packed words, blocks launched)."""
    n, h, w, cin = x.shape
    p = patch_plan(n, h, w, cin, stride, sms)
    vec = cin % 32 == 0
    # every pixel's channel words: 32 floats a word, -1 past Cin
    padded = np.full((n, h, w, p.g * 32), -1.0, np.float32)
    padded[..., :cin] = x
    words = _sign_words(padded.reshape(-1), vec).reshape(n, h, w, p.g)
    out = np.full((n * p.ho * p.wo, p.g, 9), POISON, np.uint32)
    blocks = 0
    for img in range(n):
        for rt in range(p.row_tiles):
            for gt in range(p.gb_tiles):
                blocks += 1
                gb0 = gt * p.gbs
                gbc = min(p.gbs, p.g - gb0)
                ho0, ho1 = rt * p.rows, min(rt * p.rows + p.rows, p.ho)
                y_lo = max(0, ho0 * stride - 1)
                y_hi = min(h, (ho1 - 1) * stride + 2)
                stage = words[img, y_lo:y_hi, :, gb0:gb0 + gbc].reshape(-1)
                # the launch's buffer (PatchShape::stage_words)
                assert stage.size <= min((p.rows - 1) * stride + 3,
                                         h) * w * p.gbs
                per_pix = 9 * gbc
                o = np.arange((ho1 - ho0) * p.wo * per_pix)
                pl, rem = o // per_pix, o % per_pix
                lg, j = rem // 9, rem % 9
                hol, wx = pl // p.wo, pl % p.wo
                yy = (ho0 + hol) * stride + j // 3 - 1
                xx = wx * stride + j % 3 - 1
                inside = (yy >= 0) & (yy < h) & (xx >= 0) & (xx < w)
                idx = ((yy - y_lo) * w + xx) * gbc + lg
                val = np.where(inside, stage[np.where(inside, idx, 0)], 0)
                pix = (img * p.ho + ho0 + hol) * p.wo + wx
                assert (out[pix, gb0 + lg, j] == POISON).all()
                out[pix, gb0 + lg, j] = val
    return out, blocks


@pytest.mark.parametrize("sms", [1, H100_SMS])
@pytest.mark.parametrize("n,h,w,cin,stride", [
    (2, 7, 7, 40, 1), (2, 7, 5, 40, 2), (2, 1, 1, 1, 1), (2, 9, 4, 96, 2),
    (3, 6, 6, 64, 1), (2, 5, 3, 160, 1)])
def test_patch_kernel_emulation_equals_plain(n, h, w, cin, stride, sms):
    x = _reals(np.random.default_rng(cin * h + w), (n, h, w, cin))
    got, blocks = _emulate_patch_kernel(x, stride, sms)
    want = ref.binarize_pack_patches(torch.from_numpy(x), stride)
    np.testing.assert_array_equal(got, _u32(want))
    p = patch_plan(n, h, w, cin, stride, sms)
    assert blocks == n * p.row_tiles * p.gb_tiles


def test_patch_plan_at_reactnet_shapes():
    """Every ReActNet-A block's patch tiling fits the default shared
    memory as it is (the launch keeps its rows) and gives the card at
    least two blocks an SM."""
    side, c = -(-RN.image_size // 2), RN.width
    for mult, stride in RN.blocks:
        p = patch_plan(32, side, side, c, stride, H100_SMS)
        assert min((p.rows - 1) * stride + 3,
                   side) * side * p.gbs * 4 <= SMEM_DEFAULT
        assert 32 * p.row_tiles * p.gb_tiles >= 2 * H100_SMS
        side, c = (side - 1) // stride + 1, c * mult


# --- the (M, K) pack kernel, emulated ---------------------------------------

def _emulate_pack_kernel(x: np.ndarray) -> np.ndarray:
    """csrc/binarize_pack.cu::binarize_pack_kernel block by block: a run
    of whole 288-element blocks loaded as sign words (the word past the
    run poisoned), each lane's 9-bit sequence cut by a funnel shift, the
    ballots of a warp step shared by 32 / ceil(K / 9) rows when K <= 288."""
    m, k = x.shape
    g = -(-k // 288)
    per_cta = pack_plan(m, k)
    flat = x.reshape(-1)
    out = np.full((m * g, 9), POISON, np.uint32)
    for b0 in range(0, m * g, per_cta):
        b1 = min(b0 + per_cta, m * g)
        row0, g0 = divmod(b0, g)
        rl, gl = divmod(b1 - 1, g)
        f0, f1 = row0 * k + 288 * g0, rl * k + min(288 * gl + 288, k)
        words = _sign_words(flat[f0:f1], k % 4 == 0)
        assert words.size + 1 <= per_cta * 9 + 2     # the launch's buffer
        bits = np.concatenate([words, [POISON]]).astype(np.uint64)
        # a warp step: lane l cuts sequence l % S of block l / S
        seqs = -(-k // 9) if g == 1 else 32
        for s0 in range(b0, b1, 32 // seqs):
            vals = np.zeros(32, np.uint64)
            for lane in range(32 // seqs * seqs):
                b, sq = s0 + lane // seqs, lane % seqs
                if b >= b1:
                    continue
                row, gg = divmod(b, g)
                cnt = min(max(min(288, k - 288 * gg) - 9 * sq, 0), 9)
                if cnt:
                    pos = row * k + 288 * gg - f0 + 9 * sq
                    both = (int(bits[pos >> 5])
                            | int(bits[(pos >> 5) + 1]) << 32)
                    vals[lane] = (both >> (pos & 31)) & ((1 << cnt) - 1)
            words_ = _ballots(vals).astype(np.uint64)
            for r in range(32 // seqs):
                if s0 + r < b1:
                    out[s0 + r] = (words_ >> (seqs * r)) & ((1 << seqs) - 1)
    return out.reshape(m, g, 9)


@pytest.mark.parametrize("m,k", [(1, 1), (3, 287), (5, 288), (37, 289),
                                 (64, 32), (700, 32), (9, 1000), (2, 2304),
                                 (300, 3), (100, 64), (33, 128), (20, 10),
                                 (7, 256)])
def test_pack_kernel_emulation_equals_plain(m, k):
    x = _reals(np.random.default_rng(m + k), (m, k))
    np.testing.assert_array_equal(
        _emulate_pack_kernel(x), _u32(ref.binarize_pack(torch.from_numpy(x))))


def test_pack_plan_runs():
    """About 8192 floats a block; whole rows of K=32 (ReActNet block 0's
    1x1 activations) 256 to a block."""
    assert pack_plan(401408, 32) == PACK_MAX_BLOCKS
    assert pack_plan(10, 288) == 28
    for m, k in ((1, 1), (7, 16384), (3, 289)):
        assert 1 <= pack_plan(m, k) <= PACK_MAX_BLOCKS
        assert (pack_plan(m, k) * 9 + 2) * 4 <= SMEM_DEFAULT


# --- the fused kernel, emulated ---------------------------------------------

def _popc(words: np.ndarray) -> np.ndarray:
    """Set bits of each uint32 word."""
    return np.unpackbits(np.ascontiguousarray(words, "<u4").view(
        np.uint8)).reshape(
        *words.shape, 32).sum(-1, dtype=np.int64)


def _repack_slab(dec: np.ndarray, codes: int, bn_tile: int) -> np.ndarray:
    """The decode's 9 ballots: decoded tile values (C, 128) -> its (9,
    bn_tile) words (row 4 c + s / 32, bit s % 32 = tap j, MSB first);
    columns past 4C are poisoned."""
    slab = np.full((9, bn_tile), POISON, np.uint32)
    for ci in range(codes):
        for v in range(4):
            vals = dec[ci, 32 * v:32 * v + 32].astype(np.uint64)
            taps = (vals[None, :] >> (8 - np.arange(9, dtype=np.uint64))[
                :, None]) & 1                          # (9 taps, 32 lanes)
            slab[:, 4 * ci + v] = (taps << np.arange(32, dtype=np.uint64)
                                   ).sum(1)
    return slab


def _emulate_fused(words, x_words, table, *, k_true, n_true, codes,
                   m_splits, slab_tiles=None):
    """csrc/fused_decode_contraction.cu block by block, launched as
    (m_splits, NB) blocks with chunks of ``slab_tiles`` tiles (None: the
    whole slab) -> (out, tiles decoded, BM): the walk over M tiles of BM
    rows (8 warps of 64 x 32 output tiles); the slab decoded at a
    block's first stage, or chunk by chunk for every M tile, with zeros
    past the chunk in its last k step (its columns past 4C poisoned), and
    pb its columns' set bits summed over the chunks; k steps of 8 words
    with A zero past the chunk and past M; pand by AND-popcounts, pa by the
    all-ones MMA; out = k_true - 2 pa - 2 pb + 4 pand."""
    nb, gb, w_rows, s = words.shape
    m = x_words.shape[0]
    bn, bt, st = 4 * codes, max(32, 4 * codes), slab_tiles or gb
    bm = 64 * 8 * 32 // bt
    chunked = st < gb
    dec = ref.decode_tiled(words.reshape(nb * gb, w_rows, s), table,
                           codes).numpy().reshape(nb, gb, codes, s)
    n_mtiles = -(-m // bm)
    xw = np.zeros((n_mtiles * bm, gb * 9), np.uint32)
    xw[:m] = _u32(x_words).reshape(m, -1)
    n_chunks = -(-gb // st)
    out = np.full((m, n_true), -(1 << 31), np.int64)
    decoded = 0
    for nbi in range(nb):
        for split in range(m_splits):
            first = True
            for mt in range(split, n_mtiles, m_splits):
                acc = np.zeros((bm, bt), np.int64)
                pa = np.zeros(bm, np.int64)
                for c in range(n_chunks):
                    count = min(st, gb - c * st)
                    if chunked or first:
                        slab = np.zeros((-(-count * 9 // 8) * 8, bt),
                                        np.uint32)
                        for lt in range(count):
                            slab[9 * lt:9 * lt + 9] = _repack_slab(
                                dec[nbi, c * st + lt], codes, bt)
                        ones = _popc(slab).sum(0)
                        pb = ones if c == 0 else pb + ones
                        decoded += count
                        first = False
                    w_lo = c * st * 9
                    for kl in range(-(-count * 9 // 8)):
                        a = np.zeros((bm, 8), np.uint32)
                        lo, hi = w_lo + 8 * kl, min(w_lo + 8 * kl + 8,
                                                    w_lo + count * 9)
                        a[:, :hi - lo] = xw[mt * bm:(mt + 1) * bm, lo:hi]
                        b = slab[8 * kl:8 * kl + 8].T          # (bt, 8)
                        acc += _popc(a[:, None, :] & b[None]).sum(-1)
                        pa += _popc(a).sum(-1)
                rows = mt * bm + np.arange(bm)
                cols = nbi * bn + np.arange(bt)
                ok_r = rows < m
                ok_c = (np.arange(bt) < bn) & (cols < n_true)
                blk = np.ix_(rows[ok_r], cols[ok_c])
                assert (out[blk] == -(1 << 31)).all(), "written twice"
                val = k_true - 2 * pa[:, None] - 2 * pb[None, :] + 4 * acc
                out[blk] = val[np.ix_(ok_r, ok_c)]
    assert (out != -(1 << 31)).all(), "an output never written"
    return out, decoded, bm


def _fused_case(seed, m, n, k, codes, gather="onehot"):
    rng = np.random.default_rng(seed)
    w_bits = (rng.random((n, k)) < 0.3).astype(np.uint8)
    words, tables, _ = ops.prepare_compressed_gemm(
        w_bits, cluster=True, gather=gather, codes=codes, device="cpu")
    x = _reals(rng, (m, k))
    return words, tables, ref.binarize_pack(torch.from_numpy(x))


def _weight_words(words, table, codes):
    """The decoded weights' packed words (the plain version's repack)."""
    nb, gb = words.shape[:2]
    dec = ref.decode_tiled(words.reshape(nb * gb, *words.shape[2:]), table,
                           codes)
    seqs = dec.reshape(nb, gb, 4 * codes, 32).permute(0, 2, 1, 3)
    return ref.pack_sequences(seqs.reshape(nb * 4 * codes, gb * 32))


@pytest.mark.parametrize("codes", [1, 8, 16, 32])
@pytest.mark.parametrize("m,n,k,m_splits", [(1, 33, 100, 1),
                                            (1100, 70, 577, 1),
                                            (1100, 70, 577, 2),
                                            (40, 130, 1000, 2)])
def test_fused_kernel_emulation_equals_popcount(m, n, k, m_splits, codes):
    """k_true ragged (not a multiple of 9 or 288); a block that walks
    several M tiles, and one with none (m_splits above the M tiles);
    equal to the port's and the reference's ``popcount_dot`` and to the
    plain ``fused_decode_matmul``."""
    words, tables, xw = _fused_case(k + codes, m, n, k, codes)
    table = flat_table(tables, "cpu")
    got, decoded, bm = _emulate_fused(words, xw, table, k_true=k, n_true=n,
                                      codes=codes, m_splits=m_splits)
    want = ref.fused_decode_matmul(words, xw, table, k_true=k, n_true=n,
                                   codes=codes)
    np.testing.assert_array_equal(got, want.numpy())
    ww = _weight_words(words, table, codes)
    np.testing.assert_array_equal(
        got, ref.popcount_dot(xw, ww, k)[:, :n].numpy())
    np.testing.assert_array_equal(
        got, np.asarray(jref.popcount_dot(jnp.asarray(_u32(xw)),
                                          jnp.asarray(_u32(ww)), k))[:, :n])
    # each weight tile decoded once per block that has an M tile
    nb, gb = words.shape[:2]
    assert decoded == nb * min(m_splits, -(-m // bm)) * gb


@pytest.mark.parametrize("slab_tiles", [44, 13])
def test_fused_emulation_k_chunked(slab_tiles):
    """codes=32 at K 16,400 (GB 57): the slab of 57 tiles does not fit in
    shared memory, so each M tile decodes it in chunks (chunk starts 16-byte
    aligned, as the kernel's plan keeps them, or not)."""
    m, n, k, codes = 130, 128, 16400, 32
    words, tables, xw = _fused_case(7, m, n, k, codes)
    table = flat_table(tables, "cpu")
    got, decoded, bm = _emulate_fused(words, xw, table, k_true=k, n_true=n,
                                      codes=codes, m_splits=1,
                                      slab_tiles=slab_tiles)
    assert decoded == -(-m // bm) * 57           # once per M tile
    want = ref.fused_decode_matmul(words, xw, table, k_true=k, n_true=n,
                                   codes=codes)
    np.testing.assert_array_equal(got, want.numpy())


def _bytes_i8(r: np.ndarray) -> np.ndarray:
    """uint32 registers -> their 4 bytes as int8 (byte 0 first)."""
    return ((r[..., None] >> (8 * np.arange(4, dtype=np.uint64))) & 0xFF
            ).astype(np.uint8).view(np.int8)


def _expand(words: np.ndarray) -> np.ndarray:
    """(..., n_words) uint32 -> (..., n_words * 32) int8 +-1, in an int8
    MMA's (m16n8k32) k order within each word.

    Lane t4 takes bits 4 t4 .. 4 t4 + 3 and 16 + 4 t4 .. 16 + 4 t4 + 3 for
    k = 4 t4 + i and 16 + 4 t4 + i, set -> +1.  The k index is only a
    label, so every product is there."""
    w = words.astype(np.uint64)
    regs = []
    for half in range(2):
        for t4 in range(4):
            nib = (w >> (4 * t4 + 16 * half)) & 0xF
            m = (nib * 0x00204081) & 0x01010101
            regs.append(U32 ^ ((m * 0xFE) & U32))
    out = _bytes_i8(np.stack(regs, -1))         # (..., n_words, 8, 4)
    return out.reshape(*words.shape[:-1], words.shape[-1] * 32)


@pytest.mark.parametrize("codes", [8, 16, 32])
def test_int8_products_equal_popcount(codes):
    """The int8 tensor-core route that ``mma_rate`` times against the
    binary one: both operands' words expanded to +-1 bytes, an int32
    product, minus the pad, equals ``popcount_dot`` at a ragged k_true."""
    m, n, k = 37, 70, 577
    words, tables, xw = _fused_case(k + codes, m, n, k, codes)
    table = flat_table(tables, "cpu")
    ww = _weight_words(words, table, codes)
    a = _expand(_u32(xw).reshape(m, -1)).astype(np.int64)
    b = _expand(_u32(ww).reshape(ww.shape[0], -1)).astype(np.int64)
    pad = xw.shape[1] * 288 - k
    got = (a @ b.T - pad)[:, :n]
    np.testing.assert_array_equal(
        got, ref.fused_decode_matmul(words, xw, table, k_true=k, n_true=n,
                                     codes=codes).numpy())
    np.testing.assert_array_equal(
        got, np.asarray(jref.popcount_dot(jnp.asarray(_u32(xw)),
                                          jnp.asarray(_u32(ww)), k))[:, :n])


# --- wrappers on CPU tensors ------------------------------------------------

def test_wrappers_take_the_plain_versions_on_cpu():
    rng = np.random.default_rng(3)
    x = torch.from_numpy(_reals(rng, (2, 5, 6, 40)))
    w_bits = (rng.random((33, 360)) < 0.3).astype(np.uint8)
    words, tables, _ = ops.prepare_compressed_gemm(w_bits, device="cpu")
    counters = (binarize_pack, binarize_pack_patches, binary_contraction,
                fused_decode_matmul)
    before = [f.launches for f in counters]
    xw = binarize_pack_patches(x, 2)
    assert torch.equal(xw, ref.binarize_pack_patches(x, 2))
    assert torch.equal(fused_decode_matmul(words, xw, tables, k_true=360,
                                           n_true=33),
                       ref.fused_decode_matmul(words, xw,
                                               flat_table(tables, "cpu"),
                                               k_true=360, n_true=33,
                                               codes=8))
    assert [f.launches for f in counters] == before
    with pytest.raises(ValueError, match="NHWC"):
        binarize_pack_patches(x[0], 1)
    with pytest.raises(ValueError, match="stride"):
        binarize_pack_patches(x, 0)

"""Plain PyTorch versions of every kernel of the port (port of
``repro.kernels.ref``): the tiled Huffman decode, sequence-aligned bit
packing, the xnor-popcount contraction and the fused decode+contraction.

These run on any device and are the ground truth the CUDA kernels are
held to bit for bit; on CPU tensors they *are* the path.  Packed words
arrive as int32 views of the uint32 words: torch has no shifts on
``uint32`` and no popcount on the CPU, so the arithmetic here runs in
int64 masked to 32 bits, and popcounts are SWAR sums.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.core.bitpack import BLOCK_K, SEQ_BITS, SEQS_PER_BLOCK

_U32 = 0xFFFFFFFF
# elements of the (rows, N, KW) int64 xnor block popcount_dot makes at once
_DOT_CHUNK = 1 << 24


def decode_tiled(words: torch.Tensor, tables_flat: torch.Tensor,
                 c: int) -> torch.Tensor:
    """(T, W, S) words -> (T, C, S) int32 sequences.

    Every substream keeps one bit cursor; each of the C steps peeks 12
    bits across the word boundary, classifies the prefix (0 / 10 / 110 /
    111 -> code length 6 / 8 / 9 / 12) and looks the index up in the
    160-entry table, or takes the raw 9 bits after the escape prefix.
    Reproduces the reference's edge rules exactly: a cursor past the last
    word reads 0, and the next-word index clamps at ``W - 1``."""
    t, w_rows, s = words.shape
    w64 = words.to(torch.int64) & _U32
    tables = tables_flat.to(device=words.device, dtype=torch.int64)
    bitpos = torch.zeros((t, 1, s), dtype=torch.int64, device=words.device)
    out = torch.empty((t, c, s), dtype=torch.int32, device=words.device)
    for ci in range(c):
        word_idx = bitpos >> 5
        off = bitpos & 31
        w0 = torch.gather(w64, 1, word_idx.clamp(max=w_rows - 1))
        w0 = torch.where(word_idx < w_rows, w0, 0)
        w1 = torch.gather(w64, 1, (word_idx + 1).clamp(max=w_rows - 1))
        lo = torch.where(off > 0, w1 >> (32 - off.clamp(min=1)), 0)
        window = (((w0 << off) & _U32) | lo) >> 20     # 12-bit peek
        top3 = window >> 9
        is0 = top3 < 4
        is1 = (top3 >> 1) == 2
        is2 = top3 == 6
        is3 = top3 == 7
        flat_idx = torch.where(
            is0, (window >> 6) & 31,
            torch.where(is1, 32 + ((window >> 4) & 63),
                        96 + ((window >> 3) & 63)))
        val = torch.where(is3, window & 511, tables[flat_idx])
        length = torch.where(is0, 6, torch.where(is1, 8,
                                                 torch.where(is2, 9, 12)))
        out[:, ci:ci + 1] = val.to(torch.int32)
        bitpos = bitpos + length
    return out


def decode_tile(words: torch.Tensor, tables_flat: torch.Tensor,
                c: int) -> torch.Tensor:
    """Decode one tile: (W, S) words -> (C, S) int32 sequences."""
    return decode_tiled(words[None], tables_flat, c)[0]


def tiled_to_sequences(decoded: torch.Tensor, n_seqs: int) -> torch.Tensor:
    """(T, C, S) decode output -> flat (n_seqs,) in original order."""
    return decoded.reshape(-1)[:n_seqs]


def sequences_to_gemm(seqs: torch.Tensor, k: int) -> torch.Tensor:
    """(N, G) int sequences -> (N, K) {0,1} int32, dropping the K padding
    (torch mirror of ``core.bitpack.sequences_to_gemm`` on device)."""
    shifts = torch.arange(SEQ_BITS - 1, -1, -1, dtype=torch.int32,
                          device=seqs.device)
    bits = (seqs.to(torch.int32)[..., None] >> shifts) & 1
    return bits.reshape(seqs.shape[0], -1)[:, :k]


# ---------------------------------------------------------------------------
# sequence-aligned packing (runtime mirror of bitpack.pack_gemm_operand)
# ---------------------------------------------------------------------------

def _as_int32_words(v: torch.Tensor) -> torch.Tensor:
    """int64 values holding uint32 bit patterns -> their int32 views."""
    v = v & _U32
    return torch.where(v >= 1 << 31, v - (1 << 32), v).to(torch.int32)


def pack_bits_runtime(bits: torch.Tensor) -> torch.Tensor:
    """(M, K) {0,1} -> (M, G, 9) int32 view of the uint32 sequence-aligned
    packed words: word j of block g holds tap j of its 32 sequences, bit i
    = sequence i.  K is zero-padded (-1s) to a whole number of 288-bit
    blocks; :func:`popcount_dot` corrects for the padding."""
    m, k = bits.shape
    kp = -(-k // BLOCK_K) * BLOCK_K
    b = F.pad(bits.to(torch.int64), (0, kp - k))
    blocks = b.reshape(m, kp // BLOCK_K, SEQS_PER_BLOCK, SEQ_BITS)
    blocks = blocks.transpose(-1, -2)                   # (M, G, 9, 32)
    shifts = torch.arange(32, dtype=torch.int64, device=bits.device)
    return _as_int32_words((blocks << shifts).sum(-1))


def binarize_pack(x: torch.Tensor) -> torch.Tensor:
    """(M, K) real -> packed sign bits (1 <-> x >= 0)."""
    return pack_bits_runtime(x >= 0)


def im2col(x: torch.Tensor, stride: int):
    """NHWC -> ((N*Ho*Wo, Cin*9) 3x3 patches padded with -1, out spatial
    shape).

    Patch features are ordered (Cin, kh, kw), channel outermost, as
    ``jax.lax.conv_general_dilated_patches`` orders them: each 9 features
    are one channel's 3x3 window, the paper's bit sequence, matching
    ``w.reshape(Cout, Cin * 9)``.  The -1 padding is the BNN's SAME
    padding; as signs it packs to bit 0 like the reference's zero bits."""
    n, _, _, cin = x.shape
    xp = F.pad(x.permute(0, 3, 1, 2), (1, 1, 1, 1), value=-1.0)
    cols = F.unfold(xp, (3, 3), stride=stride)         # (N, Cin*9, L)
    ho = (xp.shape[2] - 3) // stride + 1
    wo = (xp.shape[3] - 3) // stride + 1
    cols = cols.transpose(1, 2).reshape(n * ho * wo, cin * 9)
    return cols.contiguous(), (n, ho, wo)


def binarize_pack_patches(x: torch.Tensor, stride: int) -> torch.Tensor:
    """NHWC real -> packed sign bits of its 3x3 patches (the signs' im2col
    columns, packed): (N*Ho*Wo, ceil(Cin/32), 9)."""
    cols, _ = im2col(torch.where(x >= 0, 1.0, -1.0), stride)
    return binarize_pack(cols)


def pack_sequences(seqs: torch.Tensor) -> torch.Tensor:
    """(N, G) int sequences -> (N, G/32, 9) int32 packed words: word j of
    block g packs bit j (MSB-first: bit 8-j of the 9-bit value) of 32
    consecutive sequences.  G must be a multiple of 32."""
    n, g = seqs.shape
    if g % SEQS_PER_BLOCK:
        raise ValueError(f"G={g} is not a multiple of {SEQS_PER_BLOCK}")
    s = seqs.to(torch.int64).reshape(n, g // SEQS_PER_BLOCK, SEQS_PER_BLOCK)
    taps = torch.arange(SEQ_BITS, dtype=torch.int64, device=seqs.device)
    bits = (s[:, :, None, :] >> (SEQ_BITS - 1 - taps)[None, None, :, None]) & 1
    shifts = torch.arange(32, dtype=torch.int64, device=seqs.device)
    return _as_int32_words((bits << shifts).sum(-1))       # (N, G', 9)


# ---------------------------------------------------------------------------
# binary contraction (xnor + popcount GEMM)
# ---------------------------------------------------------------------------

def _popcount32(v: torch.Tensor) -> torch.Tensor:
    """Set bits of each 32-bit word (int32 view) -> int64 counts."""
    v = v.to(torch.int64) & _U32
    v = v - ((v >> 1) & 0x55555555)
    v = (v & 0x33333333) + ((v >> 2) & 0x33333333)
    v = (v + (v >> 4)) & 0x0F0F0F0F
    return (v * 0x01010101 & _U32) >> 24


def popcount_dot(x_words: torch.Tensor, w_words: torch.Tensor,
                 k_true: int) -> torch.Tensor:
    """(M, G, 9) x (N, G, 9) packed words (or flat (M, KW) x (N, KW)) ->
    (M, N) int32 +-1 dot product.

    dot = 2 * true_matches - k_true, where padded positions (0 in both
    operands) are subtracted from the raw xnor-popcount match count."""
    xw = x_words.reshape(x_words.shape[0], -1)
    ww = w_words.reshape(w_words.shape[0], -1)
    m, kw = xw.shape
    n = ww.shape[0]
    n_pad = kw * 32 - k_true
    out = torch.empty((m, n), dtype=torch.int32, device=xw.device)
    rows = max(1, _DOT_CHUNK // max(1, n * kw))
    for r0 in range(0, m, rows):
        xnor = ~(xw[r0:r0 + rows, None, :] ^ ww[None, :, :])
        matches = _popcount32(xnor).sum(-1)
        out[r0:r0 + rows] = (2 * (matches - n_pad) - k_true).to(torch.int32)
    return out


def binary_matmul(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """Reference binary GEMM on real inputs: sign(x) @ sign(w).T -> (M, N)."""
    xs = torch.where(x >= 0, 1.0, -1.0)
    ws = torch.where(w >= 0, 1.0, -1.0)
    return (xs @ ws.T).float()


def binary_conv3x3(x: torch.Tensor, w: torch.Tensor,
                   stride: int = 1) -> torch.Tensor:
    """Reference BNN 3x3 conv, NHWC x (Cout, Cin, 3, 3), padding = -1
    (SAME).  Inputs are real; signs are taken inside (1 <-> >= 0)."""
    xs = torch.where(x >= 0, 1.0, -1.0).permute(0, 3, 1, 2)
    xs = F.pad(xs, (1, 1, 1, 1), value=-1.0)
    ws = torch.where(w >= 0, 1.0, -1.0)
    return F.conv2d(xs, ws, stride=stride).permute(0, 2, 3, 1).float()


def fused_decode_matmul(words: torch.Tensor, x_words: torch.Tensor,
                        tables_flat: torch.Tensor, *, k_true: int,
                        n_true: int, codes: int) -> torch.Tensor:
    """Plain fused decode + contraction: (NB, GB, W, S) compressed weight
    words and (M, GB, 9) packed activations -> (M, n_true) int32.  Each
    tile decodes to ``4 * codes`` weight rows x one 288-bit K block
    (row-major), which are repacked MSB-first and contracted."""
    nb, gb, w_rows, s = words.shape
    dec = decode_tiled(words.reshape(nb * gb, w_rows, s), tables_flat, codes)
    tile_rows = 4 * codes
    seqs = dec.reshape(nb, gb, tile_rows, SEQS_PER_BLOCK).permute(0, 2, 1, 3)
    w_words = pack_sequences(seqs.reshape(nb * tile_rows,
                                          gb * SEQS_PER_BLOCK))
    return popcount_dot(x_words, w_words, k_true)[:, :n_true].contiguous()

"""Bit sequences and sequence-aligned packing of binary weights (copy of
``repro.core.bitpack``).

A binary weight is one bit: ``1`` encodes +1, ``0`` encodes -1.  A *bit
sequence* is the 9-bit natural-mapped value of one 3x3 channel (position
(0, 0) -> MSB, (2, 2) -> LSB, paper Fig. 2); for GEMM weights it is
``SEQ_BITS`` consecutive bits along the contraction axis, MSB first.

K is grouped into blocks of 32 sequences x 9 bits = 288 K positions.
Within a block, word j (j < 9) holds bit j of the 32 sequences, so
decoding 32 sequences emits 9 complete words (the paper's packing unit).
Activations are packed with the same permutation, which leaves the dot
product unchanged.
"""

from __future__ import annotations

import numpy as np

SEQ_BITS = 9          # one 3x3 channel
NUM_SEQUENCES = 1 << SEQ_BITS  # 512
WORD_BITS = 32        # packing word
SEQS_PER_BLOCK = WORD_BITS            # 32 sequences per K-block
BLOCK_K = SEQS_PER_BLOCK * SEQ_BITS   # 288 K positions per block


def to_bits(x: np.ndarray) -> np.ndarray:
    """Full-precision (or +-1) tensor -> {0,1} uint8 bits. x >= 0 maps to 1."""
    return (np.asarray(x) >= 0).astype(np.uint8)


def from_bits(b: np.ndarray) -> np.ndarray:
    """{0,1} bits -> float32 {-1,+1}."""
    return np.asarray(b).astype(np.float32) * 2.0 - 1.0


def kernel_to_sequences(w_bits: np.ndarray) -> np.ndarray:
    """(Cout, Cin, 3, 3) {0,1} -> (Cout, Cin) uint16 natural-mapped sequences."""
    if w_bits.ndim != 4 or w_bits.shape[-2:] != (3, 3):
        raise ValueError(f"expected (Cout, Cin, 3, 3), got {w_bits.shape}")
    flat = w_bits.reshape(*w_bits.shape[:2], SEQ_BITS).astype(np.uint16)
    weights = (1 << np.arange(SEQ_BITS - 1, -1, -1, dtype=np.uint16))
    return (flat * weights).sum(-1).astype(np.uint16)


def sequences_to_kernel(seqs: np.ndarray) -> np.ndarray:
    """(Cout, Cin) uint16 -> (Cout, Cin, 3, 3) {0,1} uint8."""
    shifts = np.arange(SEQ_BITS - 1, -1, -1, dtype=np.uint16)
    bits = (seqs[..., None] >> shifts) & 1
    return bits.reshape(*seqs.shape, 3, 3).astype(np.uint8)


def gemm_to_sequences(w_bits: np.ndarray) -> np.ndarray:
    """(N, K) {0,1} -> (N, ceil(K/9)) uint16, padding K with zeros (-1s)."""
    n, k = w_bits.shape
    k_pad = (-k) % SEQ_BITS
    if k_pad:
        w_bits = np.concatenate(
            [w_bits, np.zeros((n, k_pad), dtype=w_bits.dtype)], axis=1)
    flat = w_bits.reshape(n, -1, SEQ_BITS).astype(np.uint16)
    weights = (1 << np.arange(SEQ_BITS - 1, -1, -1, dtype=np.uint16))
    return (flat * weights).sum(-1).astype(np.uint16)


def sequences_to_gemm(seqs: np.ndarray, k: int) -> np.ndarray:
    """(N, G) uint16 -> (N, K) {0,1} uint8 dropping the zero padding."""
    shifts = np.arange(SEQ_BITS - 1, -1, -1, dtype=np.uint16)
    bits = ((seqs[..., None] >> shifts) & 1).reshape(seqs.shape[0], -1)
    return bits[:, :k].astype(np.uint8)


def pack_bits(bits: np.ndarray, axis: int = -1) -> np.ndarray:
    """Pack {0,1} bits into uint32 words along ``axis`` (bit 0 = first
    element); the axis length must be a multiple of 32."""
    bits = np.moveaxis(np.asarray(bits), axis, -1)
    n = bits.shape[-1]
    if n % WORD_BITS:
        raise ValueError(f"pack axis length {n} not a multiple of {WORD_BITS}")
    grouped = bits.reshape(*bits.shape[:-1], n // WORD_BITS, WORD_BITS)
    shifts = np.arange(WORD_BITS, dtype=np.uint32)
    words = (grouped.astype(np.uint32) << shifts).sum(-1, dtype=np.uint32)
    return np.moveaxis(words, -1, axis)


def unpack_bits(words: np.ndarray, axis: int = -1) -> np.ndarray:
    """Inverse of :func:`pack_bits`."""
    words = np.moveaxis(np.asarray(words), axis, -1)
    shifts = np.arange(WORD_BITS, dtype=np.uint32)
    bits = ((words[..., None] >> shifts) & 1).astype(np.uint8)
    bits = bits.reshape(*bits.shape[:-2], -1)
    return np.moveaxis(bits, -1, axis)


def channel_pack_conv(w_bits: np.ndarray) -> np.ndarray:
    """(Cout, Cin, 3, 3) -> (Cout, Cin/32, 9) uint32: word j holds spatial tap j
    across 32 consecutive input channels (paper Fig. 5, R-register packing)."""
    cout, cin, kh, kw = w_bits.shape
    flat = w_bits.reshape(cout, cin, kh * kw)           # (Cout, Cin, 9)
    flat = np.moveaxis(flat, 1, -1)                     # (Cout, 9, Cin)
    packed = pack_bits(flat, axis=-1)                   # (Cout, 9, Cin/32)
    return np.moveaxis(packed, 1, -1)                   # (Cout, Cin/32, 9)


def channel_unpack_conv(words: np.ndarray) -> np.ndarray:
    """Inverse of :func:`channel_pack_conv` -> (Cout, Cin, 3, 3) uint8."""
    cout = words.shape[0]
    moved = np.moveaxis(words, -1, 1)                   # (Cout, 9, Cin/32)
    bits = unpack_bits(moved, axis=-1)                  # (Cout, 9, Cin)
    bits = np.moveaxis(bits, 1, -1)                     # (Cout, Cin, 9)
    return bits.reshape(cout, -1, 3, 3)


def pad_k(k: int) -> int:
    """K padded to a whole number of 288-bit blocks."""
    return ((k + BLOCK_K - 1) // BLOCK_K) * BLOCK_K


def pack_gemm_operand(bits: np.ndarray) -> np.ndarray:
    """(M, K) {0,1} -> (M, G, 9) uint32 sequence-aligned packed words.

    G = padded_K / 288.  Padding bits are zero; the contractions correct
    for them through ``k_true``."""
    m, k = bits.shape
    kp = pad_k(k)
    if kp != k:
        bits = np.concatenate(
            [bits, np.zeros((m, kp - k), dtype=bits.dtype)], axis=1)
    # (M, G, 32 seqs, 9 taps) -> word j packs tap j over the 32 sequences
    blocks = bits.reshape(m, kp // BLOCK_K, SEQS_PER_BLOCK, SEQ_BITS)
    blocks = np.moveaxis(blocks, -1, -2)                # (M, G, 9, 32)
    return pack_bits(blocks, axis=-1)[..., 0]           # (M, G, 9)


def unpack_gemm_operand(words: np.ndarray, k: int) -> np.ndarray:
    """Inverse of :func:`pack_gemm_operand` -> (M, K) uint8."""
    bits = unpack_bits(words[..., None], axis=-1)       # (M, G, 9, 32)
    bits = np.moveaxis(bits, -1, -2)                    # (M, G, 32, 9)
    return bits.reshape(bits.shape[0], -1)[:, :k]

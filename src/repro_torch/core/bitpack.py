"""Bit sequences of binary GEMM weights (copy of ``repro.core.bitpack``).

A binary weight is one bit: ``1`` encodes +1, ``0`` encodes -1.  A *bit
sequence* is ``SEQ_BITS`` consecutive bits along the contraction axis,
MSB first — the 9-bit natural mapping of one 3x3 channel in the paper.
Only the GEMM half of the reference module is needed by the serving path.
"""

from __future__ import annotations

import numpy as np

SEQ_BITS = 9          # one 3x3 channel
NUM_SEQUENCES = 1 << SEQ_BITS  # 512


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


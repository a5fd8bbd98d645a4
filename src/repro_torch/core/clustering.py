"""Hamming-1 clustering of rare bit sequences (copy of
``repro.core.clustering``, paper §III-C).

Replaces each of the N least-frequent sequences with the most-frequent
sequence from the M most-common set at Hamming distance exactly 1; a
sequence with no such neighbour is kept.
"""

from __future__ import annotations

import numpy as np

from repro_torch.core.bitpack import NUM_SEQUENCES
from repro_torch.core.frequency import ranked_sequences, sequence_histogram

# paper defaults: replace the 256 most-uncommon, candidates = top-64 set
DEFAULT_M = 64
DEFAULT_N = 256


def hamming_matrix() -> np.ndarray:
    """(512, 512) uint8 pairwise Hamming distances between 9-bit values."""
    v = np.arange(NUM_SEQUENCES, dtype=np.uint16)
    xor = v[:, None] ^ v[None, :]
    return np.array([bin(x).count("1") for x in range(NUM_SEQUENCES)],
                    dtype=np.uint8)[xor]


def build_replacement_map(
    hist: np.ndarray, m: int = DEFAULT_M, n: int = DEFAULT_N
) -> np.ndarray:
    """(512,) uint16 map value -> replacement (identity where no replacement)."""
    order = ranked_sequences(hist)
    present = hist > 0
    top = order[:m]
    # N least-common *present* sequences (ranked ascending by frequency)
    tail = order[present[order]][::-1][:n]
    # never fold a top-m sequence onto another (they are the cluster centres)
    tail = tail[~np.isin(tail, top)]
    repl = np.arange(NUM_SEQUENCES, dtype=np.uint16)
    hd = hamming_matrix()
    for sa in tail:
        cands = top[hd[sa, top] == 1]
        if cands.size:
            repl[sa] = cands[np.argmax(hist[cands])]
    return repl


def apply_clustering(
    seqs: np.ndarray, m: int = DEFAULT_M, n: int = DEFAULT_N,
    hist: np.ndarray | None = None,
) -> tuple[np.ndarray, np.ndarray]:
    """Replace rare sequences in ``seqs``.  Returns (new_seqs, replacement_map)."""
    if hist is None:
        hist = sequence_histogram(seqs)
    repl = build_replacement_map(hist, m, n)
    return repl[np.asarray(seqs, dtype=np.int64)], repl


def max_weight_flips(repl: np.ndarray) -> int:
    """Worst-case bit flips introduced per sequence (invariant: <= 1)."""
    v = np.arange(NUM_SEQUENCES, dtype=np.uint16)
    xor = v ^ repl
    return int(max(bin(int(x)).count("1") for x in xor))

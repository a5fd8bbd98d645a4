"""Frequency-of-use of bit sequences (copy of ``repro.core.frequency``)."""

from __future__ import annotations

import numpy as np

from repro_torch.core.bitpack import NUM_SEQUENCES


def sequence_histogram(seqs: np.ndarray) -> np.ndarray:
    """Counts of each of the 512 sequences. Returns (512,) int64."""
    return np.bincount(
        np.asarray(seqs, dtype=np.int64).ravel(), minlength=NUM_SEQUENCES
    ).astype(np.int64)


def ranked_sequences(hist: np.ndarray) -> np.ndarray:
    """Sequence values sorted by descending frequency (stable)."""
    # stable sort on -hist keeps the natural order among ties, which keeps the
    # node assignment deterministic across runs.
    return np.argsort(-hist, kind="stable").astype(np.uint16)

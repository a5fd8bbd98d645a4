"""Frequency-of-use of bit sequences (copy of ``repro.core.frequency``;
paper §III-A, Fig. 3, Table II)."""

from __future__ import annotations

import dataclasses

import numpy as np

from repro_torch.core.bitpack import NUM_SEQUENCES


def sequence_histogram(seqs: np.ndarray) -> np.ndarray:
    """Counts of each of the 512 sequences. Returns (512,) int64."""
    return np.bincount(
        np.asarray(seqs, dtype=np.int64).ravel(), minlength=NUM_SEQUENCES
    ).astype(np.int64)


def top_k_share(hist: np.ndarray, k: int) -> float:
    """Fraction of all sequence occurrences covered by the k most frequent."""
    total = hist.sum()
    if total == 0:
        return 0.0
    return float(np.sort(hist)[::-1][:k].sum() / total)


def ranked_sequences(hist: np.ndarray) -> np.ndarray:
    """Sequence values sorted by descending frequency (stable)."""
    # stable sort on -hist keeps the natural order among ties, which keeps the
    # node assignment deterministic across runs.
    return np.argsort(-hist, kind="stable").astype(np.uint16)


@dataclasses.dataclass(frozen=True)
class BlockStats:
    """Per-block distribution summary (one row of the paper's Table II)."""

    block: int
    total: int
    top16: float
    top64: float
    top256: float
    all_zero_one: float  # share of the all-(-1) + all-(+1) sequences

    @staticmethod
    def from_hist(block: int, hist: np.ndarray) -> "BlockStats":
        total = int(hist.sum())
        zo = float((hist[0] + hist[NUM_SEQUENCES - 1]) / total) if total else 0.0
        return BlockStats(
            block=block,
            total=total,
            top16=top_k_share(hist, 16),
            top64=top_k_share(hist, 64),
            top256=top_k_share(hist, 256),
            all_zero_one=zo,
        )


def block_table(histograms: list[np.ndarray]) -> list[BlockStats]:
    """Table II analogue: one row per basic block."""
    return [BlockStats.from_hist(i + 1, h) for i, h in enumerate(histograms)]


def synthetic_histogram(
    node_shares: tuple[float, float, float, float],
    total: int,
    rng: np.random.Generator,
) -> np.ndarray:
    """Draw a 512-bin histogram whose node-aggregate frequencies match the
    paper's published marginals (e.g. 46/24/23/5% over nodes of 32/64/64/352).

    Within a node, mass decays geometrically, mimicking the measured long
    tail (paper Fig. 3)."""
    sizes = (32, 64, 64, NUM_SEQUENCES - 160)
    probs = np.zeros(NUM_SEQUENCES)
    start = 0
    for share, size in zip(node_shares, sizes):
        decay = 0.96 ** np.arange(size)
        probs[start:start + size] = share * decay / decay.sum()
        start += size
    probs /= probs.sum()
    # Assign the most probable slots to "realistic" sequence values: all-zeros,
    # all-ones first (paper: ~25% combined), then random distinct values.
    order = np.concatenate(
        [[0, NUM_SEQUENCES - 1],
         rng.permutation(np.arange(1, NUM_SEQUENCES - 1))])
    hist = np.zeros(NUM_SEQUENCES, dtype=np.int64)
    draws = rng.choice(NUM_SEQUENCES, size=total, p=probs[np.argsort(order)])
    np.add.at(hist, draws, 1)
    return hist

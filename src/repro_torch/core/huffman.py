"""Simplified 4-node Huffman coder of bit sequences (copy of
``repro.core.huffman``, paper §III-B).

:func:`full_huffman_lengths` is a textbook Huffman build, the compression
bound the simplified tree is traded against.  Node prefixes are ``0 / 10 / 110 / 111`` and node index widths ``5 / 6 /
6 / 9``, giving code lengths 6 / 8 / 9 / 12.  The last node is the escape
node: after prefix ``111`` the raw 9-bit sequence follows literally.
Encoded streams are MSB-first: the first code bit is bit 31 of word 0.
"""

from __future__ import annotations

import dataclasses
import heapq

import numpy as np

from repro_torch.core.bitpack import NUM_SEQUENCES, SEQ_BITS
from repro_torch.core.frequency import ranked_sequences

NODE_CAPS = (32, 64, 64, NUM_SEQUENCES - 160)   # escape node holds the rest
PREFIX_LEN = (1, 2, 3, 3)                        # 0, 10, 110, 111
INDEX_BITS = (5, 6, 6, SEQ_BITS)                 # escape carries raw 9 bits
CODE_LEN = tuple(p + i for p, i in zip(PREFIX_LEN, INDEX_BITS))  # 6, 8, 9, 12
PREFIX_VAL = (0b0, 0b10, 0b110, 0b111)
MAX_CODE_LEN = CODE_LEN[-1]                      # 12


def full_huffman_lengths(hist: np.ndarray) -> np.ndarray:
    """Optimal Huffman code lengths per symbol ((512,) int32; 0 = unused)."""
    heap = [(int(c), i, (i,)) for i, c in enumerate(hist) if c > 0]
    if len(heap) == 1:
        lengths = np.zeros(NUM_SEQUENCES, dtype=np.int32)
        lengths[heap[0][1]] = 1
        return lengths
    heapq.heapify(heap)
    lengths = np.zeros(NUM_SEQUENCES, dtype=np.int32)
    tick = NUM_SEQUENCES  # tie-break counter keeps the heap total-ordered
    while len(heap) > 1:
        ca, _, sa = heapq.heappop(heap)
        cb, _, sb = heapq.heappop(heap)
        for s in sa + sb:
            lengths[s] += 1
        heapq.heappush(heap, (ca + cb, tick, sa + sb))
        tick += 1
    return lengths


def full_huffman_avg_bits(hist: np.ndarray) -> float:
    lengths = full_huffman_lengths(hist)
    total = hist.sum()
    return float((hist * lengths).sum() / total) if total else 0.0


@dataclasses.dataclass(frozen=True)
class NodeAssignment:
    """Mapping sequence value -> (node, index-within-node).

    ``tables`` holds three uint16 arrays (sizes 32/64/64): table[i] is the
    sequence value decoded from index i.  The escape node has no table.
    """

    node_of: np.ndarray
    index_of: np.ndarray
    tables: tuple[np.ndarray, np.ndarray, np.ndarray]

    def code_of(self, seq: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
        """(values, lengths) of the codes for an array of sequences."""
        seq = np.asarray(seq, dtype=np.int64)
        node = self.node_of[seq]
        idx = self.index_of[seq]
        plen = np.asarray(PREFIX_LEN)[node]
        ibits = np.asarray(INDEX_BITS)[node]
        pval = np.asarray(PREFIX_VAL)[node]
        return (pval.astype(np.int64) << ibits) | idx, plen + ibits

    def avg_bits(self, hist: np.ndarray) -> float:
        total = hist.sum()
        if total == 0:
            return 0.0
        lens = np.asarray(CODE_LEN)[self.node_of]
        return float((hist * lens).sum() / total)

    def compression_ratio(self, hist: np.ndarray) -> float:
        """vs. the 9-bit channel-packed baseline (paper Table V)."""
        avg = self.avg_bits(hist)
        return SEQ_BITS / avg if avg else 1.0

    def node_shares(self, hist: np.ndarray) -> np.ndarray:
        """Aggregate frequency share per node ((4,) float)."""
        total = hist.sum()
        shares = np.zeros(4)
        for n in range(4):
            shares[n] = hist[self.node_of == n].sum() / max(total, 1)
        return shares

    def decode_tables_flat(self) -> np.ndarray:
        """(160,) int32 concatenated tables for the decode kernels:
        [0:32) node0, [32:96) node1, [96:160) node2."""
        return np.concatenate([t.astype(np.int32) for t in self.tables])


def assign_nodes(hist: np.ndarray) -> NodeAssignment:
    """Fill the 4 nodes by descending frequency (paper §VI)."""
    order = ranked_sequences(hist)
    node_of = np.zeros(NUM_SEQUENCES, dtype=np.int32)
    index_of = np.zeros(NUM_SEQUENCES, dtype=np.int32)
    tables = []
    start = 0
    for n, cap in enumerate(NODE_CAPS):
        vals = order[start:start + cap]
        node_of[vals] = n
        if n < 3:
            index_of[vals] = np.arange(len(vals))
            tables.append(vals.astype(np.uint16).copy())  # rank order = table order
        else:  # escape node: the index IS the raw sequence
            index_of[vals] = vals
        start += cap
    return NodeAssignment(node_of, index_of, tuple(tables))


def encode_stream(seqs: np.ndarray, assign: NodeAssignment) -> tuple[np.ndarray, int]:
    """Encode a flat array of sequences -> (uint32 words MSB-first, nbits)."""
    vals, lens = assign.code_of(np.asarray(seqs).ravel())
    return _pack_codes(vals, lens)


def _pack_codes(vals: np.ndarray, lens: np.ndarray) -> tuple[np.ndarray, int]:
    """Vectorised variable-length bit packing (MSB-first)."""
    n = len(vals)
    if n == 0:
        return np.zeros(0, dtype=np.uint32), 0
    # (n, MAX) bit matrix, row i holds the code bits MSB-first, mask = validity
    j = np.arange(MAX_CODE_LEN)
    bitmat = (vals[:, None] >> (lens[:, None] - 1 - j)) & 1
    mask = j < lens[:, None]
    stream_bits = bitmat[mask].astype(np.uint8)  # row-major -> stream order
    nbits = int(stream_bits.size)
    pad = (-nbits) % 32
    if pad:
        stream_bits = np.concatenate([stream_bits, np.zeros(pad, np.uint8)])
    bytes_ = np.packbits(stream_bits)            # MSB-first within bytes
    words = bytes_.reshape(-1, 4).astype(np.uint32)
    words = (words[:, 0] << 24) | (words[:, 1] << 16) | (words[:, 2] << 8) | words[:, 3]
    return words.astype(np.uint32), nbits


def decode_stream(words: np.ndarray, nbits: int, assign: NodeAssignment,
                  count: int | None = None) -> np.ndarray:
    """Scalar reference decoder (tests + oracle). Returns uint16 sequences."""
    bits = np.unpackbits(
        np.concatenate([((words >> s) & 0xFF).astype(np.uint8)[:, None]
                        for s in (24, 16, 8, 0)], axis=1).ravel())[:nbits]
    out = []
    pos = 0
    while pos < nbits and (count is None or len(out) < count):
        node = 0
        if bits[pos] == 1:
            node = 1
            if bits[pos + 1] == 1:
                node = 2 if bits[pos + 2] == 0 else 3
        plen = PREFIX_LEN[node]
        ibits = INDEX_BITS[node]
        idx = 0
        for b in bits[pos + plen: pos + plen + ibits]:
            idx = (idx << 1) | int(b)
        if node < 3:
            out.append(int(assign.tables[node][idx]))
        else:
            out.append(idx)
        pos += plen + ibits
    return np.asarray(out, dtype=np.uint16)

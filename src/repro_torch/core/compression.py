"""Binary GEMM-weight compression (copy of the GEMM half of
``repro.core.compression``).

Produces two layouts from one node assignment:

* **stream** — one contiguous varlen bitstream (the paper's DRAM layout,
  the one the compression-ratio tables measure);
* **tiled** — the substream-parallel layout the decode kernel consumes:
  sequences are distributed round-robin over S substreams, each substream
  is padded to the per-tile maximum word count, and every tile decodes
  independently.
"""

from __future__ import annotations

import dataclasses

import numpy as np

from repro_torch.core import clustering, frequency, huffman

DEFAULT_SUBSTREAMS = 128      # substreams per tile (threads of a decode block)
DEFAULT_CODES_PER_SUB = 8     # C: codes decoded per substream per tile
                              # -> tile = 1024 sequences


@dataclasses.dataclass
class TiledStream:
    """Substream-parallel compressed layout.

    words    : (n_tiles, W, S) uint32 — lane s of row w is word w of substream
               s; MSB-first bit order within each word.
    n_seqs   : true number of sequences (tail tile may be partly padding)
    s, c     : substreams per tile, codes per substream per tile
    sequence (t, c, s) of the decode output = original sequence t*S*C + c*S + s.
    """

    words: np.ndarray
    n_seqs: int
    s: int
    c: int

    @property
    def n_tiles(self) -> int:
        return self.words.shape[0]

    @property
    def w(self) -> int:
        return self.words.shape[1]


@dataclasses.dataclass
class CompressedTensor:
    """A compressed binary GEMM weight."""

    assign: huffman.NodeAssignment
    stream_words: np.ndarray       # contiguous varlen stream (uint32)
    stream_bits: int
    tiled: TiledStream
    seq_shape: tuple[int, ...]     # shape of the sequence array, (N, G)
    orig_shape: tuple[int, ...]    # shape of the original bit tensor
    kind: str                      # "gemm"
    replacement: np.ndarray | None # clustering map if clustering was applied

    @property
    def n_seqs(self) -> int:
        return int(np.prod(self.seq_shape))

    def decode_tables(self) -> np.ndarray:
        return self.assign.decode_tables_flat()


def tile_stream(
    seqs: np.ndarray,
    assign: huffman.NodeAssignment,
    s: int = DEFAULT_SUBSTREAMS,
    c: int = DEFAULT_CODES_PER_SUB,
) -> TiledStream:
    flat = np.asarray(seqs, dtype=np.uint16).ravel()
    n = flat.size
    t = s * c                                     # sequences per tile
    n_tiles = (n + t - 1) // t
    # pad the tail with sequence 0 (decoded then discarded by the consumer)
    padded = np.zeros(n_tiles * t, dtype=np.uint16)
    padded[:n] = flat
    # (n_tiles, C, S): substream s consumes codes [t, :, s]
    grid = padded.reshape(n_tiles, c, s)
    vals, lens = assign.code_of(grid)             # (T, C, S) each
    # encode every (tile, substream) column at once: scatter the j-th bit of
    # every code into a per-column bit plane (12 vectorised passes)
    off = np.cumsum(lens, axis=1) - lens          # bit offset of code c
    sub_bits = lens.sum(axis=1)                   # (T, S)
    w = int(np.ceil(sub_bits.max() / 32.0))
    maxbits = w * 32
    bits = np.zeros((n_tiles, s, maxbits + 1), dtype=np.uint8)  # +1 = spill slot
    for j in range(huffman.MAX_CODE_LEN):
        valid = j < lens
        pos = np.where(valid, off + j, maxbits)
        val = np.where(valid, (vals >> (lens - 1 - j)) & 1, 0)
        np.put_along_axis(
            bits, pos.transpose(0, 2, 1), val.transpose(0, 2, 1).astype(np.uint8),
            axis=-1)
    planes = bits[..., :maxbits].reshape(n_tiles, s, w, 32)
    shifts = np.arange(31, -1, -1, dtype=np.uint32)   # MSB-first within words
    words = (planes.astype(np.uint32) << shifts).sum(-1, dtype=np.uint32)
    return TiledStream(words=words.transpose(0, 2, 1), n_seqs=n, s=s, c=c)


def compress_sequences(
    seqs: np.ndarray,
    orig_shape: tuple[int, ...],
    kind: str,
    cluster: bool = True,
    m: int = clustering.DEFAULT_M,
    n: int = clustering.DEFAULT_N,
    substreams: int = DEFAULT_SUBSTREAMS,
    codes_per_sub: int = DEFAULT_CODES_PER_SUB,
) -> CompressedTensor:
    seqs = np.asarray(seqs, dtype=np.uint16)
    repl = None
    if cluster:
        seqs, repl = clustering.apply_clustering(seqs, m=m, n=n)
    hist = frequency.sequence_histogram(seqs)
    assign = huffman.assign_nodes(hist)
    stream_words, stream_bits = huffman.encode_stream(seqs, assign)
    tiled = tile_stream(seqs, assign, s=substreams, c=codes_per_sub)
    return CompressedTensor(
        assign=assign,
        stream_words=stream_words,
        stream_bits=stream_bits,
        tiled=tiled,
        seq_shape=tuple(seqs.shape),
        orig_shape=tuple(orig_shape),
        kind=kind,
        replacement=repl,
    )


"""Binary-kernel compression (copy of ``repro.core.compression``: 3x3
conv and GEMM weights, the fused-kernel block layout and the model-level
report; paper §III).

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

import torch

from repro_torch.core import bitpack, clustering, frequency, huffman
from repro_torch.core.bitpack import SEQ_BITS
from repro_torch.kernels import ref

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

    def stored_bits(self) -> int:
        return int(self.words.size * 32)


@dataclasses.dataclass
class CompressedTensor:
    """A compressed binary weight tensor (one conv kernel or GEMM weight).

    ``tiled`` is None when compressed with ``tiled=False`` (storage-only
    stream layout)."""

    assign: huffman.NodeAssignment
    stream_words: np.ndarray       # contiguous varlen stream (uint32)
    stream_bits: int
    tiled: TiledStream | None
    seq_shape: tuple[int, ...]     # shape of the sequence array, e.g. (Cout, Cin)
    orig_shape: tuple[int, ...]    # shape of the original bit tensor
    kind: str                      # "conv3x3" | "gemm"
    replacement: np.ndarray | None # clustering map if clustering was applied

    @property
    def n_seqs(self) -> int:
        return int(np.prod(self.seq_shape))

    def ratio_stream(self) -> float:
        """Paper Table V ratio: 9-bit baseline vs varlen stream."""
        return self.n_seqs * SEQ_BITS / self.stream_bits

    def ratio_tiled(self) -> float:
        """Ratio of the tiled layout (includes substream padding)."""
        return self.n_seqs * SEQ_BITS / self.tiled.stored_bits()

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
    tiled: bool = True,
) -> CompressedTensor:
    seqs = np.asarray(seqs, dtype=np.uint16)
    repl = None
    if cluster:
        seqs, repl = clustering.apply_clustering(seqs, m=m, n=n)
    hist = frequency.sequence_histogram(seqs)
    assign = huffman.assign_nodes(hist)
    stream_words, stream_bits = huffman.encode_stream(seqs, assign)
    tiled = tile_stream(seqs, assign, s=substreams, c=codes_per_sub) \
        if tiled else None
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


def compress_conv3x3(w_bits: np.ndarray, **kw) -> CompressedTensor:
    """(Cout, Cin, 3, 3) {0,1} -> CompressedTensor."""
    seqs = bitpack.kernel_to_sequences(w_bits)
    return compress_sequences(seqs, w_bits.shape, "conv3x3", **kw)


def compress_gemm(w_bits: np.ndarray, **kw) -> CompressedTensor:
    """(N, K) {0,1} -> CompressedTensor (9-bit grouping along K)."""
    seqs = bitpack.gemm_to_sequences(w_bits)
    return compress_sequences(seqs, w_bits.shape, "gemm", **kw)


@dataclasses.dataclass
class FusedCompressed:
    """Compressed GEMM weight in the fused-kernel block layout.

    words  : (NB, GB, W, S) uint32 — tile (nb, gb) holds weight rows
             [tr*nb, tr*nb + tr) x K-block gb (32 sequences = 288 K
             positions), tr = 4 * codes_per_sub rows, row-major within the
             tile, round-robin over S=128 substreams.
    """

    ct: CompressedTensor
    words: np.ndarray
    n_true: int
    k_true: int

    def ratio_tiled(self) -> float:
        return self.n_true * np.ceil(self.k_true / 9) * 9 / (self.words.size * 32)


def compress_gemm_fused(w_bits: np.ndarray,
                        codes_per_sub: int = DEFAULT_CODES_PER_SUB,
                        **kw) -> FusedCompressed:
    """(N, K) {0,1} -> fused block layout for ``fused_decode_matmul``.

    One decode tile covers ``tile_rows = 4 * codes_per_sub`` weight rows x
    one 288-bit K block."""
    tile_rows = 4 * codes_per_sub
    seqs = bitpack.gemm_to_sequences(w_bits)            # (N, G)
    # clustering must not flip K-padding bits (would break the xnor pad
    # correction): cluster only the complete 9-bit columns, before padding
    if kw.pop("cluster", True):
        full = w_bits.shape[1] // 9
        if full:
            sub, _ = clustering.apply_clustering(
                seqs[:, :full],
                m=kw.pop("m", clustering.DEFAULT_M),
                n=kw.pop("n", clustering.DEFAULT_N))
            seqs = np.concatenate([sub, seqs[:, full:]], axis=1)
    n, g = seqs.shape
    npad, gpad = (-n) % tile_rows, (-g) % 32
    seqs = np.pad(seqs, ((0, npad), (0, gpad)))
    nb, gb = (n + npad) // tile_rows, (g + gpad) // 32
    blocks = seqs.reshape(nb, tile_rows, gb, 32) \
        .transpose(0, 2, 1, 3).reshape(-1)
    ct = compress_sequences(
        blocks, w_bits.shape, "gemm_fused", cluster=False,
        substreams=DEFAULT_SUBSTREAMS, codes_per_sub=codes_per_sub, **kw)
    words4 = ct.tiled.words.reshape(nb, gb, ct.tiled.w, DEFAULT_SUBSTREAMS)
    return FusedCompressed(ct=ct, words=words4, n_true=n,
                           k_true=w_bits.shape[1])


def decompress_fused(fc: FusedCompressed) -> np.ndarray:
    """Reverse the fused block layout -> (N, K) bits (clustered if
    clustering was applied at compression time).  Decodes with the plain
    tiled decode (``kernels.ref.decode_tiled``), which gives the
    reference's scalar per-substream ``decode_stream`` values."""
    ts = fc.ct.tiled
    words = torch.from_numpy(np.ascontiguousarray(
        fc.words.reshape(-1, ts.w, ts.s)).view(np.int32))
    out = ref.decode_tiled(words, torch.from_numpy(fc.ct.decode_tables()),
                           ts.c).numpy()
    nb, gb = fc.words.shape[:2]
    tile_rows = ts.c * 4
    seqs = out.reshape(nb, gb, tile_rows, 32).transpose(0, 2, 1, 3) \
        .reshape(nb * tile_rows, -1)
    g = -(-fc.k_true // 9)
    return bitpack.sequences_to_gemm(
        np.ascontiguousarray(seqs[:fc.n_true, :g]).astype(np.uint16),
        fc.k_true)


def decompress(ct: CompressedTensor) -> np.ndarray:
    """Stream-decode back to the (possibly clustered) bit tensor."""
    seqs = huffman.decode_stream(
        ct.stream_words, ct.stream_bits, ct.assign, count=ct.n_seqs
    ).reshape(ct.seq_shape)
    if ct.kind == "conv3x3":
        return bitpack.sequences_to_kernel(seqs)
    return bitpack.sequences_to_gemm(seqs, ct.orig_shape[-1])


# ---------------------------------------------------------------------------
# model-level compression (paper's 1.2x whole-model figure)
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class ModelCompressionReport:
    per_tensor: dict[str, float]        # name -> stream ratio
    binary_bits_before: int
    binary_bits_after: int
    fp_bits: int                        # uncompressed (non-binary) parameters

    @property
    def binary_ratio(self) -> float:
        return self.binary_bits_before / max(self.binary_bits_after, 1)

    @property
    def model_ratio(self) -> float:
        before = self.binary_bits_before + self.fp_bits
        after = self.binary_bits_after + self.fp_bits
        return before / max(after, 1)


def compress_model(
    binary_tensors: dict[str, np.ndarray],
    fp_bits: int,
    kinds: dict[str, str] | None = None,
    cluster: bool = True,
) -> tuple[dict[str, CompressedTensor], ModelCompressionReport]:
    """Compress every binarized weight tensor of a model.

    ``binary_tensors``: name -> {0,1} bit tensor (4-d conv or 2-d GEMM).
    ``fp_bits``: total bits of the model's full-precision remainder
    (8-bit input/output layers, BN, PReLU — paper Table I).
    """
    out: dict[str, CompressedTensor] = {}
    ratios: dict[str, float] = {}
    before = after = 0
    for name, bits in binary_tensors.items():
        kind = (kinds or {}).get(name, "conv3x3" if bits.ndim == 4 else "gemm")
        ct = (compress_conv3x3 if kind == "conv3x3" else compress_gemm)(
            bits, cluster=cluster)
        out[name] = ct
        ratios[name] = ct.ratio_stream()
        before += ct.n_seqs * SEQ_BITS
        after += ct.stream_bits
    report = ModelCompressionReport(
        per_tensor=ratios,
        binary_bits_before=before,
        binary_bits_after=after,
        fp_bits=fp_bits,
    )
    return out, report

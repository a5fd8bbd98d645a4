"""Plain PyTorch versions of the tiled Huffman decode (port of the decode
half of ``repro.kernels.ref``).

These run on any device and are the ground truth the CUDA kernel is held
to bit for bit (``kernels.huffman_decode``); on CPU tensors they *are* the
decode path.  Packed words arrive as int32 views of the uint32 stream:
torch has no shifts on ``uint32`` on the CPU, so the arithmetic here runs
in int64 masked to 32 bits.
"""

from __future__ import annotations

import torch

SEQ_BITS = 9
_U32 = 0xFFFFFFFF


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

"""Tiled simplified-Huffman decode: CUDA kernel + plain PyTorch version.

Replaces the Pallas TPU kernel ``repro/kernels/huffman_decode.py::
huffman_decode`` (``_kernel``, ``decode_step``).  The kernel is
``csrc/huffman_decode.cu``: one block per tile, one thread per substream,
the decode table in shared memory.  Its plain version is
``kernels.ref.decode_tiled``, which the kernel matches bit for bit.

What bounds it on the card: each substream's decode is a serial chain
(a code's length says where the next starts), so the kernel hides that
latency with one independent block per tile rather than with wide loads;
see the source note in the ``.cu`` file.

The table may come in either of the reference's two forms: the flat
(160,) int32 table, or the (5, 9) uint32 bit-plane LUT of
``pack_bitplane_tables``, which is unpacked on the host to the same 160
values (the two forms decode identically by construction).
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from repro_torch.kernels import _build, ref

TABLE_SIZE = 160


def pack_bitplane_tables(tables_flat) -> np.ndarray:
    """(160,) int32 -> (5, 9) uint32 bit-plane LUT (the reference's
    ``gather="bitplane"`` table form): bit c of word (g, j) is tap j (bit
    8 - j) of table entry 32 g + c."""
    t = np.asarray(tables_flat, dtype=np.uint32).reshape(5, 32)
    taps = np.arange(9)
    bits = (t[:, :, None] >> (8 - taps)[None, None, :]) & 1   # (5, 32, 9)
    shifts = np.arange(32, dtype=np.uint32)
    return (bits.transpose(0, 2, 1).astype(np.uint32)
            << shifts).sum(-1, dtype=np.uint32)               # (5, 9)


def unpack_bitplane_tables(lut) -> np.ndarray:
    """(5, 9) uint32 bit-plane LUT -> (160,) int32 flat table: bit c of
    word (g, j) is tap j (bit 8 - j) of table entry 32 g + c."""
    lut = np.asarray(lut, dtype=np.int64).reshape(5, 9) & 0xFFFFFFFF
    c = np.arange(32)
    bits = (lut[:, :, None] >> c[None, None, :]) & 1          # (5, 9, 32)
    taps = (1 << (8 - np.arange(9)))[None, :, None]
    return (bits * taps).sum(axis=1).reshape(TABLE_SIZE).astype(np.int32)


def flat_table(tables: torch.Tensor, device) -> torch.Tensor:
    """Either table form -> the (160,) int32 flat table on ``device``."""
    if tuple(tables.shape) == (TABLE_SIZE,):
        return tables.to(device=device, dtype=torch.int32).contiguous()
    if tuple(tables.shape) == (5, 9):
        flat = unpack_bitplane_tables(tables.cpu().numpy())
        return torch.from_numpy(flat).to(device)
    raise ValueError(f"decode table must be (160,) or the (5, 9) bit-plane "
                     f"LUT, got {tuple(tables.shape)}")


def huffman_decode(words: torch.Tensor, tables: torch.Tensor, *,
                   c: int) -> torch.Tensor:
    """Decode a tiled stream: ``words`` (T, W, S) int32 (the uint32 words'
    bit pattern) -> (T, C, S) int32 sequence values.

    CUDA tensors go through the kernel (or raise); CPU tensors take the
    plain version."""
    if words.dim() != 3:
        raise ValueError(f"words must be (T, W, S), got {tuple(words.shape)}")
    table = flat_table(tables, words.device)
    if words.device.type == "cpu":
        return ref.decode_tiled(words, table, c)
    if not words.is_cuda:
        raise ValueError(f"unsupported device {words.device}")
    if words.dtype != torch.int32 or not words.is_contiguous():
        raise ValueError("words must be a contiguous int32 view of the "
                         "uint32 stream")
    t, w, s = words.shape
    if not 1 <= s <= 1024 or w < 1 or c < 1:
        raise ValueError(f"unsupported tile shape W={w} S={s} C={c}")
    out = torch.empty((t, c, s), dtype=torch.int32, device=words.device)
    lib = _build.load("huffman_decode")
    fn = lib.huffman_decode_launch
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 4 \
            + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
    code = fn(words.data_ptr(), table.data_ptr(), out.data_ptr(), t, w, s,
              c, torch.cuda.current_stream(words.device).cuda_stream)
    _build.check(lib, "huffman_decode", code)
    huffman_decode.launches += 1
    return out


huffman_decode.launches = 0     # kernel launches (not plain-version calls)

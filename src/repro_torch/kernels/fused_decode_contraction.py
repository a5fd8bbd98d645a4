"""Fused Huffman decode + xnor-popcount GEMM: CUDA kernel + plain version.

Replaces the Pallas TPU kernel ``repro/kernels/fused_decode_contraction.
py::fused_decode_matmul``: compressed weight tiles are decoded, repacked
MSB-first and contracted against packed activations without the decoded
weights ever reaching device memory.  The kernel is
``csrc/fused_decode_contraction.cu`` (the decode step is shared with the
tile decode through ``csrc/huffman_decode_step.cuh``); its plain version
is ``kernels.ref.fused_decode_matmul``, which the kernel matches bit for
bit.

The table may come in either of the reference's two forms, the (160,)
flat table or the (5, 9) bit-plane LUT (the reference's ``gather``
flag): the LUT is unpacked on the host to the same 160 values, as
``kernels.huffman_decode`` does.  The reference's ``bm`` was a TPU block
size; the kernel's library plans its own launch (shared memory, M split,
slab chunks), and :func:`fused_plan` reads that plan back.

What bounds it on the card: the +-1 multiply-accumulates at the binary
tensor-core rate, or the bytes of the activations and the int32 output;
see the source note in the ``.cu`` file (the kernel's products run on the
binary MMA, popcounts of AND; :func:`mma_rate` times it against the int8
one).
"""

from __future__ import annotations

import ctypes
import dataclasses

import torch

from repro_torch.core.compression import DEFAULT_CODES_PER_SUB, \
    DEFAULT_SUBSTREAMS
from repro_torch.kernels import _build, ref
from repro_torch.kernels.huffman_decode import flat_table
from repro_torch.kernels.paged_attention import sm_count


@dataclasses.dataclass(frozen=True)
class FusedPlan:
    """One launch of the slab kernel, as its library plans it: ``bm``
    rows an M tile (by the slab's ``4 * codes`` columns, at least 32); the
    grid is ``m_splits`` x NB blocks, block (split, nb) walking M tiles
    split, split + m_splits, ...; ``slab_tiles`` decoded tiles fit in
    ``smem_bytes`` of shared memory: all ``gb`` of them, or else the block
    decodes a chunk of that many before each chunk of each M tile;
    ``vec``: activations are copied 16 bytes at a time (for an x that is
    16-byte aligned)."""
    gb: int
    bm: int
    m_splits: int
    slab_tiles: int
    smem_bytes: int
    vec: bool

    @property
    def chunked(self) -> bool:
        return self.slab_tiles < self.gb


def fused_plan(m: int, nb: int, gb: int, w_rows: int, codes: int,
               sms: int) -> FusedPlan:
    """The launch the slab kernel takes for M activation rows, NB slabs of
    ``4 * codes`` weight rows and GB K blocks of tiles of ``w_rows`` words
    a substream, on a card of ``sms`` SMs (read from its library, which
    builds on the machine with the card)."""
    lib = _build.load("fused_decode_contraction")
    fn = lib.fused_decode_contraction_plan
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_int] * 6 + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
    vals = (ctypes.c_int * 5)()
    _build.check(lib, "fused_decode_contraction",
                 fn(m, nb, gb, w_rows, codes, sms, vals))
    bm, m_splits, slab_tiles, smem_bytes, vec = vals
    return FusedPlan(gb, bm, m_splits, slab_tiles, smem_bytes, bool(vec))


def fused_decode_matmul(words: torch.Tensor, x_words: torch.Tensor,
                        tables: torch.Tensor, *, k_true: int, n_true: int,
                        codes: int = DEFAULT_CODES_PER_SUB) -> torch.Tensor:
    """(NB, GB, W, S=128) compressed weight words and (M, GB, 9) packed
    activations (int32 views of uint32 words) -> (M, n_true) int32 +-1 dot
    products.  ``codes`` must match the layout's ``codes_per_sub`` (a tile
    is ``4 * codes`` weight rows).

    CUDA tensors go through the kernel (or raise); CPU tensors take the
    plain version."""
    if words.dim() != 4 or x_words.dim() != 3 or x_words.shape[2] != 9:
        raise ValueError(f"words must be (NB, GB, W, S) and x_words "
                         f"(M, G, 9), got {tuple(words.shape)} and "
                         f"{tuple(x_words.shape)}")
    nb, gb, w_rows, s = words.shape
    m, g = x_words.shape[:2]
    bn = 4 * codes
    if s != DEFAULT_SUBSTREAMS:
        raise ValueError(f"S={s}: the layout has {DEFAULT_SUBSTREAMS} "
                         f"substreams")
    if g != gb:
        raise ValueError(f"activation K blocks G={g} != weight tiles GB={gb}")
    if codes < 1 or DEFAULT_SUBSTREAMS % bn:
        raise ValueError(f"codes={codes}: 4 * codes must divide "
                         f"{DEFAULT_SUBSTREAMS}")
    if not (0 <= n_true <= nb * bn and 0 <= k_true <= gb * 288):
        raise ValueError(f"n_true={n_true} / k_true={k_true} do not fit "
                         f"NB={nb} x {bn} rows / GB={gb} x 288")
    table = flat_table(tables, words.device)
    if words.device.type == "cpu" and x_words.device.type == "cpu":
        return ref.fused_decode_matmul(words, x_words, table, k_true=k_true,
                                       n_true=n_true, codes=codes)
    if not (words.is_cuda and x_words.device == words.device):
        raise ValueError(f"operands on {words.device} and {x_words.device}:"
                         f" both must be on one card")
    for t in (words, x_words):
        if t.dtype != torch.int32 or not t.is_contiguous():
            raise ValueError("words and x_words must be contiguous int32 "
                             "views of the uint32 words")
    out = torch.empty((m, n_true), dtype=torch.int32, device=words.device)
    if m == 0 or n_true == 0:
        return out
    if nb > 65535:
        raise ValueError(f"NB={nb} slabs exceed the grid's 65535")
    lib = _build.load("fused_decode_contraction")
    fn = lib.fused_decode_contraction_launch
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 8 \
            + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
    code = fn(words.data_ptr(), x_words.data_ptr(), table.data_ptr(),
              out.data_ptr(), m, n_true, nb, gb, w_rows, codes, k_true,
              sm_count(words.device.index),
              torch.cuda.current_stream(words.device).cuda_stream)
    _build.check(lib, "fused_decode_contraction", code)
    fused_decode_matmul.launches += 1
    return out


fused_decode_matmul.launches = 0  # kernel launches (not plain-version calls)


def fused_kernel_info(codes: int, chunked: bool = False) -> dict:
    """Registers and local (spill) bytes a thread of the slab kernel that
    launches with ``codes`` run, whole-slab or ``chunked``, on the current
    card."""
    lib = _build.load("fused_decode_contraction")
    fn = lib.fused_decode_contraction_info
    fn.argtypes = [ctypes.c_int] * 2 + [ctypes.c_void_p] * 2
    fn.restype = ctypes.c_int
    vals = [ctypes.c_int(0) for _ in range(2)]
    _build.check(lib, "fused_decode_contraction",
                 fn(codes, int(chunked), *(ctypes.byref(v) for v in vals)))
    return dict(zip(("registers", "local_bytes"), (v.value for v in vals)))


def mma_rate(kind: str, blocks: int, iters: int = 2048) -> float:
    """The probe: tera-ops a second of ``blocks`` blocks of 8 warps each
    issuing ``iters`` x 16 independent MMAs from registers, ``kind`` "s8"
    (m16n8k32, 8192 ops) or "b1" (m16n8k256 .and.popc, the kernel's, 65536
    ops: a multiply-accumulate of two bits counted as 2), on the current
    card."""
    lib = _build.load("fused_decode_contraction")
    fn = lib.fused_decode_contraction_mma_rate
    fn.argtypes = [ctypes.c_int] * 3 + [ctypes.c_void_p] * 2
    fn.restype = ctypes.c_int
    code = {"s8": 0, "b1": 1}[kind]
    out = torch.zeros(1, dtype=torch.int32, device="cuda")
    stream = torch.cuda.current_stream().cuda_stream
    _build.check(lib, "fused_decode_contraction",
                 fn(code, blocks, 16, out.data_ptr(), stream))
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    _build.check(lib, "fused_decode_contraction",
                 fn(code, blocks, iters, out.data_ptr(), stream))
    end.record()
    torch.cuda.synchronize()
    ops = blocks * 8 * iters * 16 * 16 * 8 * (32 if kind == "s8" else 256) * 2
    return ops / (start.elapsed_time(end) * 1e-3) / 1e12

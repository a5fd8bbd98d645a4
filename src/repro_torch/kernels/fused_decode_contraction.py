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
size; the kernel chooses its own.

What bounds it on the card: operations (popcounts, plus the decode);
see the source note in the ``.cu`` file.
"""

from __future__ import annotations

import ctypes

import torch

from repro_torch.core.compression import DEFAULT_CODES_PER_SUB, \
    DEFAULT_SUBSTREAMS
from repro_torch.kernels import _build, ref
from repro_torch.kernels.huffman_decode import flat_table


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
    lib = _build.load("fused_decode_contraction")
    fn = lib.fused_decode_contraction_launch
    fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 7 \
        + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    code = fn(words.data_ptr(), x_words.data_ptr(), table.data_ptr(),
              out.data_ptr(), m, n_true, nb, gb, w_rows, codes, k_true,
              torch.cuda.current_stream(words.device).cuda_stream)
    _build.check(lib, "fused_decode_contraction", code)
    fused_decode_matmul.launches += 1
    return out


fused_decode_matmul.launches = 0  # kernel launches (not plain-version calls)

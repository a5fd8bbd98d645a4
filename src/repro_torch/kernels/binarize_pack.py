"""Sign-binarise + sequence-aligned packing: CUDA kernel + plain version.

Replaces the Pallas TPU kernel ``repro/kernels/binarize_pack.py::
binarize_pack``.  The kernel is ``csrc/binarize_pack.cu``: one warp per
(row, 288-element K block), the block staged through shared memory and
packed by 9 warp ballots.  Its plain version is ``kernels.ref.
binarize_pack``, which the kernel matches bit for bit.

What bounds it on the card: bytes (each float read once, one bit written
for it); see the source note in the ``.cu`` file.
"""

from __future__ import annotations

import ctypes

import torch

from repro_torch.core.bitpack import BLOCK_K, SEQ_BITS
from repro_torch.kernels import _build, ref


def binarize_pack(x: torch.Tensor) -> torch.Tensor:
    """(M, K) real -> (M, ceil(K/288), 9) int32 view of the uint32 packed
    sign bits (1 <-> x >= 0); K is padded with -1 (bit 0).

    CUDA tensors go through the kernel (or raise); CPU tensors take the
    plain version."""
    if x.dim() != 2:
        raise ValueError(f"x must be (M, K), got {tuple(x.shape)}")
    if x.device.type == "cpu":
        return ref.binarize_pack(x)
    if not x.is_cuda:
        raise ValueError(f"unsupported device {x.device}")
    if x.dtype != torch.float32 or not x.is_contiguous():
        raise ValueError("x must be a contiguous float32 tensor")
    m, k = x.shape
    g = -(-k // BLOCK_K)
    out = torch.empty((m, g, SEQ_BITS), dtype=torch.int32, device=x.device)
    if m == 0 or g == 0:
        return out
    lib = _build.load("binarize_pack")
    fn = lib.binarize_pack_launch
    fn.argtypes = [ctypes.c_void_p] * 2 + [ctypes.c_longlong] \
        + [ctypes.c_int] * 2 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    code = fn(x.data_ptr(), out.data_ptr(), m, k, g,
              torch.cuda.current_stream(x.device).cuda_stream)
    _build.check(lib, "binarize_pack", code)
    binarize_pack.launches += 1
    return out


binarize_pack.launches = 0      # kernel launches (not plain-version calls)

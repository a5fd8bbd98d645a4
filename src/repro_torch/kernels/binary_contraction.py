"""xnor-popcount binary GEMM over packed words: CUDA kernel + plain version.

Replaces the Pallas TPU kernel ``repro/kernels/binary_contraction.py::
binary_contraction``.  The kernel is ``csrc/binary_contraction.cu``: a
64 x 64 output tile per block, K words staged through shared memory,
``__popc(~(x ^ w))`` into int32 registers.  Its plain version is
``kernels.ref.popcount_dot``, which the kernel matches bit for bit.

The reference's ``bm/bn/ck`` were TPU block sizes (it padded M, N and K
to them); the kernel masks its own ragged edges and takes none.

What bounds it on the card: operations, the popcount's issue rate; see
the source note in the ``.cu`` file.
"""

from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build, ref


def binary_contraction(x_words: torch.Tensor, w_words: torch.Tensor, *,
                       k_true: int) -> torch.Tensor:
    """(M, KW) x (N, KW) int32 views of packed uint32 words -> (M, N)
    int32 ``2 * (popcount(xnor) - pad_bits) - k_true`` with
    ``pad_bits = KW * 32 - k_true``.

    CUDA tensors go through the kernel (or raise); CPU tensors take the
    plain version."""
    if x_words.dim() != 2 or w_words.dim() != 2 or \
            x_words.shape[1] != w_words.shape[1]:
        raise ValueError(f"operands must be (M, KW) and (N, KW), got "
                         f"{tuple(x_words.shape)} and {tuple(w_words.shape)}")
    m, kw = x_words.shape
    n = w_words.shape[0]
    if not 0 <= k_true <= kw * 32:
        raise ValueError(f"k_true={k_true} outside [0, {kw * 32}]")
    if x_words.device.type == "cpu" and w_words.device.type == "cpu":
        return ref.popcount_dot(x_words, w_words, k_true)
    if not (x_words.is_cuda and x_words.device == w_words.device):
        raise ValueError(f"operands on {x_words.device} and "
                         f"{w_words.device}: both must be on one card")
    for t in (x_words, w_words):
        if t.dtype != torch.int32 or not t.is_contiguous():
            raise ValueError("operands must be contiguous int32 views of "
                             "the uint32 words")
    out = torch.empty((m, n), dtype=torch.int32, device=x_words.device)
    if m == 0 or n == 0:
        return out
    lib = _build.load("binary_contraction")
    fn = lib.binary_contraction_launch
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 4 \
            + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
    code = fn(x_words.data_ptr(), w_words.data_ptr(), out.data_ptr(), m, n,
              kw, k_true, torch.cuda.current_stream(x_words.device).cuda_stream)
    _build.check(lib, "binary_contraction", code)
    binary_contraction.launches += 1
    return out


binary_contraction.launches = 0  # kernel launches (not plain-version calls)

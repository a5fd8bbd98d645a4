"""xnor-popcount binary GEMM over packed words: CUDA kernel + plain version.

Replaces the Pallas TPU kernel ``repro/kernels/binary_contraction.py::
binary_contraction``.  The kernel is ``csrc/binary_contraction.cu``: its
products run on the binary tensor cores (``mma.sync m16n8k256 .and.popc``
on the packed words, helpers shared with the fused kernel through
``csrc/binary_mma.cuh``), corrected by the rows' set bits; a block stages
its weight slab in shared memory once and walks M tiles whose k steps
come in through a ``cp.async`` ring; outputs leave as 8-byte stores that
fill whole sectors.  Its plain version is ``kernels.ref.popcount_dot``,
which the kernel matches bit for bit.

The reference's ``bm/bn/ck`` were TPU block sizes (it padded M, N and K
to them); the kernel's library plans its own launch (slab width, M split,
K chunks) and masks its own ragged edges; :func:`contraction_plan` reads
that plan back.

What bounds it on the card: the bytes of the operands and of the int32
output at every ReActNet-A shape; see the source note in the ``.cu``
file.
"""

from __future__ import annotations

import ctypes
import dataclasses

import torch

from repro_torch.kernels import _build, ref
from repro_torch.kernels.paged_attention import sm_count


@dataclasses.dataclass(frozen=True)
class ContractionPlan:
    """One launch, as the kernel's library plans it: N in ``n_slabs``
    slabs of ``bn`` columns, M in tiles of ``bm`` rows; the grid is
    ``m_splits`` x ``n_slabs`` blocks, block (split, slab) walking M tiles
    split, split + m_splits, ...; ``slab_steps`` k steps (8 words each) of
    the slab fit in ``smem_bytes`` of shared memory beside the activation
    ring: all ``steps`` of them, or else the block stages a chunk of that
    many before each chunk of each M tile; ``vec``: 16-byte copies (for
    operands that are 16-byte aligned)."""
    steps: int
    bn: int
    bm: int
    n_slabs: int
    m_splits: int
    slab_steps: int
    smem_bytes: int
    vec: bool

    @property
    def chunked(self) -> bool:
        return self.slab_steps < self.steps


def contraction_plan(m: int, n: int, kw: int, sms: int) -> ContractionPlan:
    """The launch the kernel takes for (M, KW) x (N, KW) words on a card of
    ``sms`` SMs (read from its library, which builds on the machine with
    the card)."""
    lib = _build.load("binary_contraction")
    fn = lib.binary_contraction_plan
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_int] * 4 + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
    vals = (ctypes.c_int * 7)()
    _build.check(lib, "binary_contraction", fn(m, n, kw, sms, vals))
    bn, bm, n_slabs, m_splits, slab_steps, smem_bytes, vec = vals
    return ContractionPlan(max(1, -(-kw // 8)), bn, bm, n_slabs, m_splits,
                           slab_steps, smem_bytes, bool(vec))


def contraction_kernel_info(bn: int, chunked: bool = False) -> dict:
    """Registers and local (spill) bytes a thread of the kernel with a
    slab of ``bn`` columns (32, 64 or 128), whole or ``chunked``, runs on
    the current card."""
    lib = _build.load("binary_contraction")
    fn = lib.binary_contraction_info
    fn.argtypes = [ctypes.c_int] * 2 + [ctypes.c_void_p] * 2
    fn.restype = ctypes.c_int
    vals = [ctypes.c_int(0) for _ in range(2)]
    _build.check(lib, "binary_contraction",
                 fn(bn, int(chunked), *(ctypes.byref(v) for v in vals)))
    return dict(zip(("registers", "local_bytes"), (v.value for v in vals)))


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
        fn.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 5 \
            + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
    code = fn(x_words.data_ptr(), w_words.data_ptr(), out.data_ptr(), m, n,
              kw, k_true, sm_count(x_words.device.index),
              torch.cuda.current_stream(x_words.device).cuda_stream)
    _build.check(lib, "binary_contraction", code)
    binary_contraction.launches += 1
    return out


binary_contraction.launches = 0  # kernel launches (not plain-version calls)

"""Sign-binarise + sequence-aligned packing: CUDA kernels + plain versions.

Replaces the Pallas TPU kernel ``repro/kernels/binarize_pack.py::
binarize_pack`` and, for 3x3 convolutions, the reference's pair
``ref.pack_bits_runtime(ops._im2col_bits(x, stride))``.  Both kernels are
in ``csrc/binarize_pack.cu``: :func:`binarize_pack` packs (M, K) rows,
:func:`binarize_pack_patches` packs the 3x3 patches of an NHWC tensor
straight from it, without the f32 im2col columns.  Each loads its floats
as sign words in shared memory (16-byte loads where aligned), then emits
the packed words.  Their plain versions are ``kernels.ref.binarize_pack``
and ``kernels.ref.binarize_pack_patches``, which the kernels match bit
for bit.  The tiling of both launches is chosen here (:func:`pack_plan`,
:func:`patch_plan`); the launches size their shared memory from it.

What bounds them on the card: bytes (each float read once, one bit
written for it, or for each tap that reads it); see the source note in
the ``.cu`` file.
"""

from __future__ import annotations

import ctypes
import dataclasses

import torch

from repro_torch.core.bitpack import BLOCK_K, SEQ_BITS
from repro_torch.kernels import _build, ref
from repro_torch.kernels.paged_attention import sm_count

PACK_RUN = 8192             # floats a block of the (M, K) kernel loads
PACK_MAX_BLOCKS = 256       # 288-element blocks a block of it, at most


def pack_plan(m: int, k: int) -> int:
    """288-element blocks a thread block of an (M, K) launch packs: about
    PACK_RUN floats a block, whole rows when K <= 288."""
    g = -(-k // BLOCK_K)
    return max(1, min(PACK_MAX_BLOCKS, PACK_RUN * g // max(k, 1)))


@dataclasses.dataclass(frozen=True)
class PatchPlan:
    """A patch launch: a thread block emits ``rows`` output rows x ``gbs``
    channel groups of one image; ``row_tiles`` x ``gb_tiles`` blocks an
    image (the launch takes fewer rows a block where their input rows
    would not fit in its shared memory)."""
    ho: int
    wo: int
    g: int
    rows: int
    gbs: int
    row_tiles: int
    gb_tiles: int


def patch_plan(n: int, h: int, w: int, cin: int, stride: int,
               sms: int) -> PatchPlan:
    """Tile an (N, H, W, Cin) patch pack into about four blocks an SM, as
    many output rows a block as that allows (each block re-reads one halo
    row on each side from L2)."""
    ho, wo = (h - 1) // stride + 1, (w - 1) // stride + 1
    g = -(-cin // 32)
    gbs = min(g, 4)
    gb_tiles = -(-g // gbs)
    row_tiles = min(ho, -(-4 * sms // max(1, n * gb_tiles)))
    rows = -(-ho // row_tiles)
    return PatchPlan(ho, wo, g, rows, gbs, -(-ho // rows), gb_tiles)


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
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_void_p] * 2 + [ctypes.c_longlong] \
            + [ctypes.c_int] * 3 + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
    code = fn(x.data_ptr(), out.data_ptr(), m, k, g, pack_plan(m, k),
              torch.cuda.current_stream(x.device).cuda_stream)
    _build.check(lib, "binarize_pack", code)
    binarize_pack.launches += 1
    return out


binarize_pack.launches = 0      # kernel launches (not plain-version calls)


def binarize_pack_patches(x: torch.Tensor, stride: int) -> torch.Tensor:
    """NHWC (N, H, W, Cin) real -> (N*Ho*Wo, ceil(Cin/32), 9) int32 view of
    the packed sign bits of its 3x3 patches at ``stride`` with the BNN's
    (1, 1) padding of -1: equal to ``binarize_pack`` of the signs' im2col
    columns (features (Cin, kh, kw), channel outermost).

    CUDA tensors go through the kernel (or raise); CPU tensors take the
    plain version."""
    if x.dim() != 4:
        raise ValueError(f"x must be NHWC (N, H, W, Cin), got "
                         f"{tuple(x.shape)}")
    if stride < 1:
        raise ValueError(f"stride={stride} must be >= 1")
    if x.device.type == "cpu":
        return ref.binarize_pack_patches(x, stride)
    if not x.is_cuda:
        raise ValueError(f"unsupported device {x.device}")
    if x.dtype != torch.float32 or not x.is_contiguous():
        raise ValueError("x must be a contiguous float32 tensor")
    n, h, w, cin = x.shape
    ho = (h - 1) // stride + 1 if h else 0
    wo = (w - 1) // stride + 1 if w else 0
    g = -(-cin // 32)
    out = torch.empty((n * ho * wo, g, SEQ_BITS), dtype=torch.int32,
                      device=x.device)
    if out.numel() == 0:
        return out
    plan = patch_plan(n, h, w, cin, stride, sm_count(x.device.index))
    lib = _build.load("binarize_pack")
    fn = lib.binarize_pack_patches_launch
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_void_p] * 2 + [ctypes.c_int] * 7 \
            + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
    code = fn(x.data_ptr(), out.data_ptr(), n, h, w, cin, stride, plan.rows,
              plan.gbs, torch.cuda.current_stream(x.device).cuda_stream)
    _build.check(lib, "binarize_pack", code)
    binarize_pack_patches.launches += 1
    return out


binarize_pack_patches.launches = 0   # kernel launches (not plain calls)

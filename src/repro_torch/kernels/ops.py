"""Public wrappers around the binary kernels (port of ``repro.kernels.ops``).

Same names and signatures as the reference, minus ``interpret`` and the
TPU block sizes.  Every call goes through the kernel wrappers, which
launch their CUDA kernel for tensors on the card and take their plain
version for tensors on the CPU.  Activations are always packed by the
``binarize_pack`` kernel on the card (the reference's ``use_kernel=True``
route), so ``binarize_pack`` takes no ``use_kernel`` flag.

Packed words are int32 views of the reference's uint32 words.
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.core import compression
from repro_torch.core.compression import DEFAULT_CODES_PER_SUB
from repro_torch.kernels import ref
from repro_torch.kernels.binarize_pack import binarize_pack, \
    binarize_pack_patches
from repro_torch.kernels.binary_contraction import binary_contraction
from repro_torch.kernels.fused_decode_contraction import fused_decode_matmul
from repro_torch.kernels.huffman_decode import huffman_decode, \
    pack_bitplane_tables


def _f32(x: torch.Tensor) -> torch.Tensor:
    """The kernel's input form: contiguous float32 (signs unchanged)."""
    return x.to(torch.float32).contiguous()


# ---------------------------------------------------------------------------
# binary matmul (uncompressed baseline path)
# ---------------------------------------------------------------------------

def binary_matmul_packed(x_words: torch.Tensor, w_words: torch.Tensor,
                         k_true: int) -> torch.Tensor:
    """(M, G, 9) x (N, G, 9) packed operands -> (M, N) int32 +-1 dot."""
    return binary_contraction(x_words.reshape(x_words.shape[0], -1),
                              w_words.reshape(w_words.shape[0], -1),
                              k_true=k_true)


def binary_matmul(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """sign(x) @ sign(w).T via the packed xnor/popcount kernel -> (M, N)
    f32; ``x`` (M, K) real activations, ``w`` (N, K) latent weights."""
    return binary_matmul_packed(binarize_pack(_f32(x)), binarize_pack(_f32(w)),
                                x.shape[-1]).float()


# ---------------------------------------------------------------------------
# compressed path (the paper's contribution)
# ---------------------------------------------------------------------------

def compressed_binary_matmul(x: torch.Tensor, words: torch.Tensor,
                             tables: torch.Tensor, *, k_true: int,
                             n_true: int,
                             codes: int = DEFAULT_CODES_PER_SUB
                             ) -> torch.Tensor:
    """sign(x) @ decoded-weights.T, decoding fused into the GEMM -> f32."""
    return fused_decode_matmul(words, binarize_pack(_f32(x)), tables,
                               k_true=k_true, n_true=n_true,
                               codes=codes).float()


def decode_sequences(words: torch.Tensor, tables: torch.Tensor, *, c: int,
                     n_seqs: int) -> torch.Tensor:
    """Standalone decode: tiled stream -> flat (n_seqs,) int32 sequences."""
    return ref.tiled_to_sequences(huffman_decode(words, tables, c=c), n_seqs)


# ---------------------------------------------------------------------------
# 3x3 BNN convolution (packed patches + contraction)
# ---------------------------------------------------------------------------

_im2col = ref.im2col


def _im2col_signs(x: torch.Tensor, stride: int):
    """NHWC real -> (f32 +-1 patches of its signs, out spatial shape)."""
    return _im2col(torch.where(x >= 0, 1.0, -1.0), stride)


def _im2col_bits(x: torch.Tensor, stride: int):
    """NHWC real -> ((N*Ho*Wo, Cin*9) {0,1} bits, out spatial shape).

    Zero bits encode -1, so the SAME padding is the BNN's -1 padding
    (``ref.binary_conv3x3`` semantics)."""
    cols, shape = _im2col_signs(x, stride)
    return (cols > 0).float(), shape


def _conv_shape(x: torch.Tensor, stride: int) -> tuple[int, int, int]:
    """(N, Ho, Wo) of a 3x3 conv of NHWC ``x`` with (1, 1) padding."""
    n, h, w = x.shape[:3]
    return n, (h - 1) // stride + 1, (w - 1) // stride + 1


def binary_conv3x3(x: torch.Tensor, w: torch.Tensor, *,
                   stride: int = 1) -> torch.Tensor:
    """BNN 3x3 conv via packed patches + packed contraction -> (N, Ho, Wo,
    Cout) f32; ``x`` NHWC real, ``w`` (Cout, Cin, 3, 3) latent weights."""
    cout, cin = w.shape[:2]
    xw = binarize_pack_patches(_f32(x), stride)
    ww = binarize_pack(_f32(w.reshape(cout, cin * 9)))
    out = binary_matmul_packed(xw, ww, cin * 9)
    return out.reshape(*_conv_shape(x, stride), cout).float()


def compressed_binary_conv3x3(x: torch.Tensor, words: torch.Tensor,
                              tables: torch.Tensor, *, cin: int, cout: int,
                              stride: int = 1,
                              codes: int = DEFAULT_CODES_PER_SUB
                              ) -> torch.Tensor:
    """BNN 3x3 conv with weights Huffman-decoded inside the GEMM kernel."""
    out = fused_decode_matmul(words, binarize_pack_patches(_f32(x), stride),
                              tables, k_true=cin * 9, n_true=cout,
                              codes=codes)
    return out.reshape(*_conv_shape(x, stride), cout).float()


# ---------------------------------------------------------------------------
# offline helpers: numpy weights -> device tensors for the compressed path
# ---------------------------------------------------------------------------

def prepare_compressed_gemm(w_bits: np.ndarray, cluster: bool = True,
                            gather: str = "onehot",
                            codes: int = DEFAULT_CODES_PER_SUB,
                            device="cuda"):
    """(N, K) {0,1} -> (words, tables, meta dict) on ``device``, ready for
    the fused kernel.  ``gather="bitplane"`` gives the (5, 9) LUT form of
    the table, ``"onehot"`` the flat (160,) form."""
    if gather not in ("onehot", "bitplane"):
        raise ValueError(f"gather must be 'onehot' or 'bitplane', got "
                         f"{gather!r}")
    device = resolve_device(device)
    fc = compression.compress_gemm_fused(w_bits, cluster=cluster,
                                         codes_per_sub=codes)
    tables = fc.ct.decode_tables()
    if gather == "bitplane":
        tables = pack_bitplane_tables(tables).view(np.int32)
    words = torch.from_numpy(np.ascontiguousarray(fc.words).view(np.int32))
    return (words.to(device), torch.from_numpy(tables).to(device),
            dict(k_true=fc.k_true, n_true=fc.n_true, codes=codes,
                 ratio_stream=fc.ct.ratio_stream(),
                 ratio_tiled=fc.ratio_tiled()))


def prepare_compressed_conv(w_bits: np.ndarray, cluster: bool = True,
                            gather: str = "onehot",
                            codes: int = DEFAULT_CODES_PER_SUB,
                            device="cuda"):
    """(Cout, Cin, 3, 3) {0,1} -> fused-kernel operands (GEMM view)."""
    cout, cin = w_bits.shape[:2]
    return prepare_compressed_gemm(
        w_bits.reshape(cout, cin * 9), cluster=cluster, gather=gather,
        codes=codes, device=device)

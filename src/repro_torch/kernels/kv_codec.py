"""KV-page codec: codebook quantization + Huffman archive for paged KV
(port of ``repro.kernels.kv_codec``).

The paper compresses binary-weight kernels by exploiting a skewed
bit-sequence distribution; at serving time the paged KV pool is the
activation-side analogue.  Under ``kv_codec="cluster"`` every (page,
token) of a K or V pool is clustered onto a 256-entry codebook
(symmetric int8 levels) with one f32 scale, the pages rest as int8 codes,
and ``kernels.paged_attention`` decodes them inside the kernel — the
codebook staged in shared memory, each code turned into
``codebook[code + ZERO_CODE] * scale`` on its way into the score and the
value sum.  ``"none"`` keeps the pages in the model dtype.

Same operation order as the reference, so the codes and scales are
byte-identical to it on the CPU and on the card: cast to f32, amax over
the feature axes, ``v / safe * MAX_CODE``, round half to even, clip,
cast to int8.  ``encode`` is plain PyTorch on either device (the
reference runs it as plain jnp outside any kernel).

Properties the serving stack relies on:

* ``codebook()[ZERO_CODE] == 0`` exactly, so all-zero tokens (the page-0
  dummy sink) encode to code 0 / scale 0 and decode back to exactly 0;
* encode∘decode is idempotent: the amax element maps to ±MAX_CODE, so
  re-encoding a decoded page recovers the same scale and codes;
* the reconstruction error is elementwise bounded by ``scale / 254``.

:func:`huffman_report` / :func:`archive_pages` / :func:`restore_pages`
run the port's copy of the paper's coder (``repro_torch.core``) over the
int8 codes on the host: the at-rest layer for cold pages.
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch.core.bitpack import NUM_SEQUENCES
from repro_torch.core.clustering import apply_clustering
from repro_torch.core.huffman import assign_nodes, decode_stream, encode_stream

KV_CODECS = ("none", "cluster")

LEVELS = 256            # codebook entries == int8 code space
ZERO_CODE = LEVELS // 2  # codebook index of code 0 (decodes to exactly 0.0)
MAX_CODE = LEVELS // 2 - 1  # 127: symmetric clip range for codes


def codebook(device=None) -> torch.Tensor:
    """``(LEVELS,)`` f32 centroids in units of the per-token scale:
    ``codebook()[code + ZERO_CODE] == code / MAX_CODE``."""
    return (torch.arange(LEVELS, dtype=torch.float32, device=device)
            - ZERO_CODE) / MAX_CODE


def encode(values: torch.Tensor, axes) -> tuple[torch.Tensor, torch.Tensor]:
    """Quantize ``values`` onto the codebook -> ``(codes, scale)``:
    ``codes`` int8 of ``values.shape``, ``scale`` f32 with the feature
    ``axes`` (reduced into one amax scale per remaining index) squeezed
    out.  All-zero tokens get scale 0 and code 0."""
    v = values.to(torch.float32)
    axes = tuple(ax % v.ndim for ax in axes)
    scale = v.abs().amax(dim=axes, keepdim=True)
    safe = torch.where(scale > 0, scale, torch.ones_like(scale))
    codes = torch.clamp(torch.round(v / safe * MAX_CODE), -MAX_CODE,
                        MAX_CODE)
    return codes.to(torch.int8), scale.squeeze(axes)


def decode(codes: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    """Inverse of :func:`encode`: ``codebook[codes + ZERO_CODE] * scale``
    in f32; ``scale`` must broadcast against ``codes``."""
    vals = codebook(codes.device)[codes.long() + ZERO_CODE]
    return vals * scale.to(torch.float32)


def error_bound(scale) -> torch.Tensor:
    """Elementwise bound: ``|decode(encode(v)) - v| <= scale / 254``."""
    return torch.as_tensor(scale, dtype=torch.float32) / (2 * MAX_CODE)


# ---------------------------------------------------------------------------
# At-rest Huffman layer (host-side, exact) over the port's coder copy.
# ---------------------------------------------------------------------------

def _symbols(codes) -> np.ndarray:
    if isinstance(codes, torch.Tensor):
        codes = codes.cpu().numpy()
    return np.asarray(codes).ravel().astype(np.int64) + ZERO_CODE


def huffman_report(codes) -> dict:
    """Entropy report of an int8 code pool through the paper's coder:
    average bits per code of the exact node-limited Huffman stream, and
    what Hamming-1 clustering would add (a report only: the resident pool
    keeps raw int8 codes)."""
    flat = _symbols(codes)
    hist = np.bincount(flat, minlength=NUM_SEQUENCES).astype(np.int64)
    avg = assign_nodes(hist).avg_bits(hist)
    clustered, _ = apply_clustering(flat, hist=hist)
    chist = np.bincount(np.asarray(clustered, np.int64),
                        minlength=NUM_SEQUENCES).astype(np.int64)
    cavg = assign_nodes(chist).avg_bits(chist)
    return {
        "symbols": int(flat.size),
        "avg_bits": float(avg),
        "ratio": (8.0 / avg) if avg else float("inf"),
        "clustered_avg_bits": float(cavg),
        "clustered_ratio": (8.0 / cavg) if cavg else float("inf"),
    }


def archive_pages(codes):
    """Huffman-encode int8 codes into an exact uint32 bit stream ->
    ``(words, nbits, assign)`` for :func:`restore_pages` (lossless)."""
    flat = _symbols(codes)
    hist = np.bincount(flat, minlength=NUM_SEQUENCES).astype(np.int64)
    assign = assign_nodes(hist)
    words, nbits = encode_stream(flat, assign)
    return words, nbits, assign


def restore_pages(words, nbits, assign, shape) -> np.ndarray:
    """Exact inverse of :func:`archive_pages` back to int8 codes (the
    scalar decoder: small arrays only)."""
    seqs = decode_stream(words, nbits, assign,
                         count=int(np.prod(shape)) if shape else 1)
    return (np.asarray(seqs, np.int64) - ZERO_CODE).astype(np.int8) \
        .reshape(shape)

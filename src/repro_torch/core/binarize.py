"""Binarisation with a straight-through estimator (port of
``repro.core.binarize``; paper Eq. 1, ReActNet).

The forward pass sees sign(w) (x >= 0 maps to +1), optionally scaled by
the per-output-channel mean magnitude; gradients flow straight through
with the usual |x| <= 1 clip.
"""

from __future__ import annotations

import torch


class _SteSign(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x):
        ctx.save_for_backward(x)
        return torch.where(x >= 0, 1.0, -1.0).to(x.dtype)

    @staticmethod
    def backward(ctx, g):
        (x,) = ctx.saved_tensors
        return g * (x.abs() <= 1.0).to(g.dtype)


def ste_sign(x: torch.Tensor) -> torch.Tensor:
    """sign(x) in {-1, +1} with straight-through gradient (clip at |x|<=1)."""
    return _SteSign.apply(x)


def binarize_weights(w: torch.Tensor, scale: bool = True) -> torch.Tensor:
    """Latent fp weights -> {-a, +a} with per-output-channel scale a=mean|w|.

    The leading axis is the output-channel axis; gradients reach the
    latent weights through the STE only (the scale is detached)."""
    wb = ste_sign(w)
    if not scale:
        return wb
    alpha = w.detach().abs().mean(dim=tuple(range(1, w.ndim)), keepdim=True)
    return wb * alpha


def binarize_activations(x: torch.Tensor) -> torch.Tensor:
    """RSign without the learned shift (the shift lives in the model layer)."""
    return ste_sign(x)


def weight_bits(w: torch.Tensor) -> torch.Tensor:
    """{0,1} uint8 view of latent weights (1 <-> +1), for offline compression."""
    return (w >= 0).to(torch.uint8)

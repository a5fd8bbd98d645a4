"""ReActNet (Liu et al., ECCV 2020) — the paper's baseline BNN (port of
``repro.models.reactnet``).

MobileNetV1-shaped binary network: a full-precision stem conv, 13 basic
blocks (binary 3x3 + binary 1x1, each wrapped with RSign / RPReLU and
BatchNorm-style normalisation), global pooling and an FC head.

Each binary conv runs in one of three modes:
  * "ste"        — float sign path with the straight-through estimator
                   (training; the integers as float GEMMs);
  * "packed"     — xnor/popcount kernel on packed bits;
  * "compressed" — Huffman-compressed 3x3 weights, decode fused into the
                   conv's GEMM kernel (the paper's contribution end to end).
With ±1 operands every binary product is an exact integer in float32, so
the three modes give the same logits.

``train=True`` normalises with the batch's statistics (population
variance), as the reference does; the running ``mean``/``var`` leaves are
never updated by the forward.  Training runs in ``ste`` mode: gradients
reach the latent weights through ``ste_sign`` (:func:`loss_and_grads`).

Layouts are the reference's: images and activations NHWC, weights
(Cout, Cin, 3, 3), params a nested dict/list tree with the reference's
paths, so a JAX tree carries across leaf for leaf (:func:`params_from_numpy`).
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch import resolve_device
from repro_torch.core.binarize import ste_sign
from repro_torch.kernels import ops
from repro_torch.tree import params_from_numpy  # noqa: F401
from repro_torch.tree import tree_leaves, tree_unflatten

CONV_MODES = ("ste", "packed", "compressed")


@dataclasses.dataclass(frozen=True)
class ReActNetConfig:
    name: str = "reactnet"
    num_classes: int = 1000
    in_channels: int = 3
    width: int = 32                  # stem width (ReActNet-A: 32)
    # (out_mult, stride) per basic block; ReActNet-A MobileNet schedule
    blocks: tuple = ((2, 1), (2, 2), (1, 1), (2, 2), (1, 1), (2, 2),
                     (1, 1), (1, 1), (1, 1), (1, 1), (1, 1), (2, 2), (1, 1))
    image_size: int = 224
    conv_mode: str = "ste"           # ste | packed | compressed
    dtype: str = "float32"


CONFIG = ReActNetConfig()


# ---------------------------------------------------------------------------
# layer pieces
# ---------------------------------------------------------------------------

def _bn_init(c, device):
    return {"scale": torch.ones(c, device=device),
            "bias": torch.zeros(c, device=device),
            "mean": torch.zeros(c, device=device),
            "var": torch.ones(c, device=device)}


def _bn(p, x, train: bool):
    if train:
        mean = x.mean(dim=(0, 1, 2))
        var = x.var(dim=(0, 1, 2), correction=0)
    else:
        mean, var = p["mean"], p["var"]
    inv = torch.rsqrt(var + 1e-5)
    return (x - mean) * inv * p["scale"] + p["bias"]


def _rsign(p, x):
    """ReAct-Sign: learnable per-channel shift before binarisation."""
    return ste_sign(x - p["beta"])


def _rprelu(p, x):
    """ReAct-PReLU: y = PReLU(x - gamma) + zeta with learnable shifts."""
    xs = x - p["gamma"]
    return torch.where(xs >= 0, xs, xs * p["slope"]) + p["zeta"]


def _avg_pool2(x):
    """2x2 stride-2 VALID mean of NHWC ``x``, summed in the window's row-
    major order (as the reference's ``reduce_window``) then divided by 4."""
    h, w = x.shape[1] // 2 * 2, x.shape[2] // 2 * 2
    return (x[:, 0:h:2, 0:w:2] + x[:, 0:h:2, 1:w:2] + x[:, 1:h:2, 0:w:2]
            + x[:, 1:h:2, 1:w:2]) / 4.0


def _same_pads(size: int, k: int, s: int) -> tuple[int, int]:
    """XLA's "SAME" padding (before, after) of one spatial axis: the odd
    pixel goes after, so a 3x3 stride-2 conv of an even size pads (0, 1)."""
    total = max((-(-size // s) - 1) * s + k - size, 0)
    return total // 2, total - total // 2


def _stem(w, images):
    """Full-precision 3x3 stride-2 "SAME" conv, NHWC -> NHWC."""
    x = images.permute(0, 3, 1, 2)
    ph, pw = _same_pads(x.shape[2], 3, 2), _same_pads(x.shape[3], 3, 2)
    x = F.pad(x, (*pw, *ph))
    return F.conv2d(x, w, stride=2).permute(0, 2, 3, 1)


def _binary_conv_apply(w, x, stride: int, mode: str, compressed=None):
    """x is already binarised (+-1).  Returns (N, Ho, Wo, Cout) f32."""
    alpha = w.detach().abs().mean(dim=(1, 2, 3))
    if mode == "ste":
        # a float GEMM over the +-1 patches, not F.conv2d: without TF32 the
        # GEMM sums the integers exactly, where cuDNN may pick a conv
        # algorithm (Winograd, FFT) that rounds them
        cols, (n, ho, wo) = ops._im2col(x, stride)
        out = (cols @ ste_sign(w).reshape(w.shape[0], -1).T).reshape(
            n, ho, wo, -1)
    elif mode == "packed":
        out = ops.binary_conv3x3(x, w, stride=stride)
    else:
        words, tables, meta = compressed
        out = ops.compressed_binary_conv3x3(
            x, words, tables, cin=w.shape[1], cout=w.shape[0], stride=stride,
            codes=meta["codes"])
    return out * alpha


# ---------------------------------------------------------------------------
# model
# ---------------------------------------------------------------------------

def init_params(cfg: ReActNetConfig, generator: torch.Generator,
                device="cuda") -> dict:
    """Random params in the reference's tree (Gaussian latent weights,
    identity BN, zero shifts), drawn from ``generator`` on ``device``."""
    device = resolve_device(device)

    def normal(shape, scale):
        return torch.randn(shape, generator=generator, device=device) * scale

    c = cfg.width
    params: dict = {
        "stem": {"w": normal((c, cfg.in_channels, 3, 3),
                             (9 * cfg.in_channels) ** -0.5),
                 "bn": _bn_init(c, device)},
        "blocks": [],
    }
    for mult, _stride in cfg.blocks:
        cout = c * mult
        params["blocks"].append({
            "rsign1": {"beta": torch.zeros(c, device=device)},
            "w3": normal((c, c, 3, 3), (9 * c) ** -0.5),
            "bn1": _bn_init(c, device),
            "rprelu1": {"gamma": torch.zeros(c, device=device),
                        "zeta": torch.zeros(c, device=device),
                        "slope": torch.full((c,), 0.25, device=device)},
            "rsign2": {"beta": torch.zeros(c, device=device)},
            "w1": normal((cout, c, 1, 1), c ** -0.5),
            "bn2": _bn_init(cout, device),
            "rprelu2": {"gamma": torch.zeros(cout, device=device),
                        "zeta": torch.zeros(cout, device=device),
                        "slope": torch.full((cout,), 0.25, device=device)},
        })
        c = cout
    params["head"] = {"w": normal((c, cfg.num_classes), c ** -0.5),
                      "b": torch.zeros(cfg.num_classes, device=device)}
    return params


def _block_apply(blk, x, mult: int, stride: int, mode: str, train: bool,
                 compressed=None):
    c_in = x.shape[-1]
    # --- 3x3 binary conv sub-layer (the paper's compression target) -------
    xb = _rsign(blk["rsign1"], x)
    y = _bn(blk["bn1"], _binary_conv_apply(blk["w3"], xb, stride, mode,
                                           compressed), train)
    short = _avg_pool2(x) if stride == 2 else x
    y = _rprelu(blk["rprelu1"], y + short)

    # --- 1x1 binary conv sub-layer (as a binary GEMM) ---------------------
    yb = _rsign(blk["rsign2"], y)
    w1 = blk["w1"][:, :, 0, 0]                       # (Cout, Cin)
    alpha = w1.detach().abs().mean(dim=1)
    n, h, w_, _ = yb.shape
    if mode == "ste":
        z = yb.reshape(-1, c_in) @ ste_sign(w1).T
    else:
        z = ops.binary_matmul(yb.reshape(-1, c_in), w1)
    z = _bn(blk["bn2"], z.reshape(n, h, w_, -1) * alpha, train)
    if z.shape[-1] == y.shape[-1]:
        z = z + y
    else:                                            # channel duplication
        z = z + torch.cat([y] * mult, dim=-1)
    return _rprelu(blk["rprelu2"], z)


def forward(cfg: ReActNetConfig, params, images, *, train: bool = False,
            compressed: list | None = None):
    """images (N, H, W, 3) -> logits (N, num_classes).

    ``compressed`` is :func:`prepare_compressed`'s list, needed by
    ``conv_mode="compressed"``; ``train`` takes BN statistics from the
    batch."""
    if cfg.conv_mode not in CONV_MODES:
        raise ValueError(f"conv_mode must be one of {CONV_MODES}, got "
                         f"{cfg.conv_mode!r}")
    if cfg.conv_mode == "compressed" and compressed is None:
        raise ValueError("conv_mode='compressed' needs prepare_compressed's "
                         "operands")
    x = _bn(params["stem"]["bn"], _stem(params["stem"]["w"], images), train)
    for i, ((mult, stride), blk) in enumerate(zip(cfg.blocks,
                                                  params["blocks"])):
        comp = compressed[i] if compressed is not None else None
        x = _block_apply(blk, x, mult, stride, cfg.conv_mode, train, comp)
    x = x.mean(dim=(1, 2))
    return x @ params["head"]["w"] + params["head"]["b"]


def loss_fn(cfg, params, batch, *, train: bool = True):
    """Mean softmax cross-entropy of ``batch["images"]`` against
    ``batch["labels"]`` (logsumexp minus the gold logit)."""
    logits = forward(cfg, params, batch["images"], train=train)
    logz = torch.logsumexp(logits, dim=-1)
    gold = torch.gather(logits, 1,
                        batch["labels"].to(torch.int64)[:, None])[:, 0]
    return torch.mean(logz - gold)


def loss_and_grads(cfg, params, batch, *, train: bool = True):
    """(loss, grads): the reference's ``jax.value_and_grad(loss_fn)``.

    ``grads`` has the params' tree; a leaf the loss does not read (the BN
    running ``mean``/``var`` in train mode) gets zeros, as under jax.
    Only ``conv_mode="ste"`` is differentiable: the kernels of the other
    modes have no backward."""
    if cfg.conv_mode != "ste":
        raise ValueError(f"gradients need conv_mode='ste', got "
                         f"{cfg.conv_mode!r}")
    leaves = [t.detach().requires_grad_(True) for t in tree_leaves(params)]
    loss = loss_fn(cfg, tree_unflatten(params, leaves), batch, train=train)
    grads = torch.autograd.grad(loss, leaves, allow_unused=True,
                                materialize_grads=True)
    return loss.detach(), tree_unflatten(params, grads)


# ---------------------------------------------------------------------------
# offline compression of a trained model (paper pipeline)
# ---------------------------------------------------------------------------

def binary_weight_bits(params) -> dict[str, np.ndarray]:
    """name -> {0,1} bit tensors of every binary conv (3x3 and 1x1)."""
    out = {}
    for i, blk in enumerate(params["blocks"]):
        out[f"block{i}/w3"] = (blk["w3"] >= 0).cpu().numpy().astype(np.uint8)
        out[f"block{i}/w1"] = (blk["w1"][:, :, 0, 0] >= 0).cpu().numpy() \
            .astype(np.uint8)
    return out


def prepare_compressed(params, cluster: bool = True, gather: str = "onehot"):
    """Per-block fused-kernel operands for conv_mode="compressed", on the
    params' device."""
    comp = []
    for blk in params["blocks"]:
        w_bits = (blk["w3"] >= 0).cpu().numpy().astype(np.uint8)
        comp.append(ops.prepare_compressed_conv(
            w_bits, cluster=cluster, gather=gather, device=blk["w3"].device))
    return comp


def fp_bits(cfg: ReActNetConfig, params) -> int:
    """Bits of the non-binary remainder (8-bit stem + head, fp32 BN/PReLU),
    per the paper's Table I quantisation choices."""
    stem = params["stem"]["w"].numel() * 8
    head = (params["head"]["w"].numel() + params["head"]["b"].numel()) * 8
    other = 0
    for blk in params["blocks"]:
        for k in ("rsign1", "rsign2", "rprelu1", "rprelu2", "bn1", "bn2"):
            other += sum(v.numel() for v in blk[k].values()) * 32
    other += sum(v.numel() for v in params["stem"]["bn"].values()) * 32
    return stem + head + other

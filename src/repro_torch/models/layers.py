"""Core layers: init helpers, norms, RoPE, MLPs, losses (port of
``repro.models.layers``).

Functional style as in the reference: params are dicts of tensors and
every layer is ``f(params, x, ...) -> y``.  The projections are plain
``torch.matmul``, as the reference left them to XLA.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from repro_torch.core.binarize import binarize_weights


def dense_init(gen: torch.Generator, d_in: int, d_out: int, dtype,
               device) -> torch.Tensor:
    w = torch.randn((d_in, d_out), generator=gen, device=device)
    return (w * d_in ** -0.5).to(dtype)


def embed_init(gen: torch.Generator, vocab: int, d: int, dtype,
               device) -> torch.Tensor:
    w = torch.randn((vocab, d), generator=gen, device=device)
    return (w * 0.02).to(dtype)


def linear(w: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    return x @ w


def binary_linear(w: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """BNN linear: sign(x) @ sign(w) * alpha (per-output-channel scale)."""
    wb = binarize_weights(w.T).T
    xb = torch.where(x >= 0, 1.0, -1.0).to(x.dtype)
    return xb @ wb


def rms_norm(g: torch.Tensor, x: torch.Tensor,
             eps: float = 1e-6) -> torch.Tensor:
    x32 = x.float()
    var = (x32 * x32).mean(dim=-1, keepdim=True)
    return ((x32 * torch.rsqrt(var + eps)) * (1.0 + g.float())).to(x.dtype)


def rms_norm_init(d: int, dtype, device) -> torch.Tensor:
    return torch.zeros((d,), dtype=dtype, device=device)


def softcap(x: torch.Tensor, cap: float) -> torch.Tensor:
    return torch.tanh(x / cap) * cap if cap else x


def rope_frequencies(head_dim: int, theta: float, device) -> torch.Tensor:
    exps = torch.arange(0, head_dim, 2, dtype=torch.float32,
                        device=device) / head_dim
    return 1.0 / (theta ** exps)


def apply_rope(x: torch.Tensor, positions: torch.Tensor,
               theta: float) -> torch.Tensor:
    """x: (..., S, H, D); positions: broadcastable to (..., S)."""
    d = x.shape[-1]
    freqs = rope_frequencies(d, theta, x.device)                # (D/2,)
    angles = positions[..., None].float() * freqs               # (..., S, D/2)
    angles = angles[..., None, :]                               # (..., S, 1, D/2)
    cos, sin = torch.cos(angles), torch.sin(angles)
    x1, x2 = torch.chunk(x.float(), 2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


# |t| from which the reference's float32 tanh (XLA on the CPU) returns
# exactly +-1.  Past it the reference's tanh-gelu of a negative input is
# exactly 0, not a tiny negative number, and in a binarised MLP only the
# activation's sign survives (0 binarises to +1), so the port keeps the
# boundary where the reference has it rather than where torch.tanh's falls.
TANH_SATURATES_AT = 7.99881172180175781


def gelu_tanh(x: torch.Tensor) -> torch.Tensor:
    """The reference's ``jax.nn.gelu(x, approximate=True)``:
    x * 0.5 * (1 + tanh(t)), t = sqrt(2/pi) (x + 0.044715 x^3), written as
    x * sigmoid(2 t) (the same function) with the cdf saturating to
    exactly 0 or 1 at |t| >= ``TANH_SATURATES_AT``."""
    t = (2 / torch.pi) ** 0.5 * (x + 0.044715 * x ** 3)
    cdf = torch.where(t.abs() >= TANH_SATURATES_AT, (t > 0).to(x.dtype),
                      torch.sigmoid(2 * t))
    return x * cdf


def mlp_init(gen: torch.Generator, d_model: int, d_ff: int, act: str, dtype,
             device) -> dict:
    """Same tree as the reference: ``down`` plus ``up`` (and ``gate`` for
    the gated activations)."""
    p = {}
    if act in ("swiglu", "geglu"):
        p["gate"] = dense_init(gen, d_model, d_ff, dtype, device)
    p["up"] = dense_init(gen, d_model, d_ff, dtype, device)
    p["down"] = dense_init(gen, d_ff, d_model, dtype, device)
    return p


def mlp_apply(p: dict, x: torch.Tensor, act: str,
              binarized: bool = False) -> torch.Tensor:
    lin = binary_linear if binarized else linear
    if act == "swiglu":
        return lin(p["down"], F.silu(lin(p["gate"], x)) * lin(p["up"], x))
    if act == "geglu":
        return lin(p["down"], gelu_tanh(lin(p["gate"], x)) * lin(p["up"], x))
    return lin(p["down"], gelu_tanh(lin(p["up"], x)))


# ---------------------------------------------------------------------------
# losses
# ---------------------------------------------------------------------------

def cross_entropy(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """Mean CE over all positions; logits (..., V) taken in f32."""
    logits = logits.float()
    logz = torch.logsumexp(logits, dim=-1)
    gold = torch.gather(logits, -1, labels[..., None].long())[..., 0]
    return (logz - gold).mean()


def _chunk_ce_sum(xc, head, lc, softcap_val: float) -> torch.Tensor:
    logits = softcap((xc @ head).float(), softcap_val)
    logz = torch.logsumexp(logits, dim=-1)
    gold = torch.gather(logits, -1, lc[..., None].long())[..., 0]
    return (logz - gold).sum()


def chunked_cross_entropy(x: torch.Tensor, head: torch.Tensor,
                          labels: torch.Tensor, *, softcap_val: float = 0.0,
                          chunk: int = 256) -> torch.Tensor:
    """CE of ``softcap(x @ head)`` without the full (B, S, V) logits.

    The sequence is cut into ``gcd(S, chunk)``-long chunks and each
    chunk's summed CE is recomputed in the backward
    (``torch.utils.checkpoint``), so one (B, chunk, V) block of logits is
    live at a time and the head's gradient accumulates over the chunks.
    The gold logit is gathered from the chunk's logits, as the reference
    does (its note: a gather from the head scatters into the whole
    (D, V) head in the backward, once a chunk)."""
    b, s, _ = x.shape
    chunk = math.gcd(s, chunk)
    total = torch.zeros((), dtype=torch.float32, device=x.device)
    for c in range(0, s, chunk):
        total = total + checkpoint(_chunk_ce_sum, x[:, c:c + chunk], head,
                                   labels[:, c:c + chunk], softcap_val,
                                   use_reentrant=False)
    return total / (b * s)

"""RG-LRU recurrent block (port of ``repro.models.rglru``; Griffin /
RecurrentGemma, arXiv:2402.19427).

The recurrence h_t = a_t * h_{t-1} + sqrt(1 - a_t^2) * (i_t * x_t) is a
linear first-order recurrence: prefill evaluates it with the reference's
log-depth associative scan (:func:`associative_scan`, the same pairings in
the same order as ``jax.lax.associative_scan``), decode with one fused
update.  The cache ({"conv", "h"}) is updated in place.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.models.layers import dense_init, gelu_tanh
from repro_torch.models.ssm import carried_conv_state

_C = 8.0  # Griffin's fixed temperature on the recurrence gate


def rglru_init(gen: torch.Generator, cfg, dtype, device) -> dict:
    d, w = cfg.d_model, cfg.lru_width
    conv = torch.randn((4, w), generator=gen, device=device)
    lam = torch.linspace(0.9, 0.999, w, device=device) ** (-1.0 / _C) - 1.0
    return {
        "w_x": dense_init(gen, d, w, dtype, device),
        "w_gate": dense_init(gen, d, w, dtype, device),
        "conv_w": (conv * 0.1).to(dtype),
        "w_r": dense_init(gen, w, w, dtype, device),
        "w_i": dense_init(gen, w, w, dtype, device),
        # Lambda init so that a^c in (0.9, 0.999) at r=1 (Griffin appendix)
        "lam": torch.log(torch.expm1(lam)).float() * -1.0,
        "w_out": dense_init(gen, w, d, dtype, device),
    }


def _interleave(a: torch.Tensor, b: torch.Tensor, dim: int) -> torch.Tensor:
    """``a`` at the even and ``b`` at the odd indices of ``dim``
    (len(a) == len(b) or len(b) + 1)."""
    n = a.shape[dim] + b.shape[dim]
    out = torch.empty((*a.shape[:dim], n, *a.shape[dim + 1:]),
                      dtype=a.dtype, device=a.device)
    out[(slice(None),) * dim + (slice(0, None, 2),)] = a
    out[(slice(None),) * dim + (slice(1, None, 2),)] = b
    return out


def associative_scan(combine, elems: tuple, dim: int) -> tuple:
    """Inclusive scan of ``elems`` (tensors with the same length on
    ``dim``) under the associative ``combine(left, right)``, by
    ``jax.lax.associative_scan``'s recursion: combine adjacent pairs, scan
    the halved sequence, then combine its results with the even
    elements.  Every element is reached by the reference's pairings in its
    order, so with IEEE elementwise arithmetic the results are the
    reference's bit for bit."""
    def sl(t, start, stop=None, step=1):
        return t[(slice(None),) * dim + (slice(start, stop, step),)]

    n = elems[0].shape[dim]
    if n < 2:
        return elems
    reduced = combine([sl(e, 0, n - 1, 2) for e in elems],
                      [sl(e, 1, None, 2) for e in elems])
    odd = associative_scan(combine, tuple(reduced), dim)
    if n % 2 == 0:
        even = combine([sl(e, 0, -1) for e in odd],
                       [sl(e, 2, None, 2) for e in elems])
    else:
        even = combine(list(odd), [sl(e, 2, None, 2) for e in elems])
    even = [torch.cat([sl(e, 0, 1), r], dim=dim)
            for e, r in zip(elems, even)]
    return tuple(_interleave(e, o, dim) for e, o in zip(even, odd))


def _combine(left, right):
    a1, b1 = left
    a2, b2 = right
    return [a1 * a2, b1 * a2 + b2]


def _conv(x, conv_w, state=None, q_lens=None):
    """Depthwise causal conv (no activation) -> (out, carried-out state),
    with ``ssm``'s ragged rule for the state."""
    k = conv_w.shape[0]
    pad = torch.zeros((x.shape[0], k - 1, x.shape[-1]), dtype=x.dtype,
                      device=x.device) if state is None else state.to(x.dtype)
    full = torch.cat([pad, x], dim=1)
    s = x.shape[1]
    out = sum(full[:, i:i + s] * conv_w[i] for i in range(k))
    return out, carried_conv_state(full, k, q_lens)


def _gates(p, xw):
    xf = xw.float()
    r = torch.sigmoid(xf @ p["w_r"].float())
    i = torch.sigmoid(xf @ p["w_i"].float())
    log_a = -_C * F.softplus(p["lam"]) * r                    # (B, S, W)
    a = torch.exp(log_a)
    gated = torch.sqrt(torch.clamp(1.0 - a * a, min=1e-9)) * (i * xf)
    return a, gated


def rglru_apply(p: dict, x: torch.Tensor, cfg, *, cache=None, pos=None,
                q_lens=None):
    """-> (y, cache).  ``cache`` = {"conv": (B, 3, W), "h": (B, W) f32},
    updated in place.

    One token with a cache and no ``q_lens`` decodes; with a cache and
    ``pos`` the recurrence *resumes* from the cached state, the scan's
    prefix products folding the incoming ``h`` into every position as
    ``h_t = h_scan_t + (a_1 ... a_t) h_0`` (the reference's formula);
    otherwise the prompt starts from zero.  Ragged ``q_lens`` masks padded
    positions to the identity update (``a = 1``, input 0), so a
    ``q_lens[b] == 0`` lane leaves its cache bit for bit as it was."""
    s = x.shape[1]
    decode = cache is not None and s == 1 and q_lens is None
    resume = cache is not None and pos is not None and not decode

    gate = gelu_tanh(x @ p["w_gate"])
    xw, new_conv = _conv(x @ p["w_x"], p["conv_w"],
                         cache["conv"] if (decode or resume) else None,
                         q_lens=q_lens)
    a, gated = _gates(p, xw)
    if q_lens is not None:
        valid = (torch.arange(s, device=x.device)[None, :, None]
                 < torch.as_tensor(q_lens, device=x.device)[:, None, None])
        a = torch.where(valid, a, 1.0)
        gated = torch.where(valid, gated, 0.0)

    if decode:
        h = cache["h"] * a[:, 0] + gated[:, 0]
        y = h[:, None]
        cache["conv"].copy_(new_conv)
        cache["h"].copy_(h)
    else:
        a_sc, h_sc = associative_scan(_combine, (a, gated), dim=1)
        if resume:
            h_sc = h_sc + a_sc * cache["h"].float()[:, None]
        y = h_sc
        if cache is not None:
            cache["conv"].copy_(new_conv.to(cache["conv"].dtype))
            cache["h"].copy_(h_sc[:, -1])
    y = (y.to(x.dtype) * gate) @ p["w_out"]
    return y, cache


def rglru_cache_spec(cfg, batch: int) -> dict:
    """Shape/dtype stand-ins (meta tensors) of one RG-LRU block's cache."""
    w = cfg.lru_width
    return {"conv": torch.empty((batch, 3, w), dtype=cfg.torch_dtype,
                                device="meta"),
            "h": torch.empty((batch, w), dtype=torch.float32,
                             device="meta")}

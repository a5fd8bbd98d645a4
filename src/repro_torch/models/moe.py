"""Mixture-of-Experts (port of ``repro.models.moe``: DeepSeek-V2 shared +
routed experts, Mixtral top-k).

Capacity-bounded dispatch as in the reference: per sequence, each token's
top-k expert choices take positions from a cumsum of one-hots over the
(S*k) choices in order; a choice whose position reaches the capacity is
dropped (routed to an overflow row), the kept ones are scattered into an
(E, C, D) buffer, every expert runs its SwiGLU on its C rows as one
batched product per projection, and the rows are gathered back and
combined weighted by their normalised router probability.  Which token
goes where, and which are dropped, is the reference's bit for bit.

The expert products are plain ``torch.einsum`` (bmm), as the reference
leaves them to XLA outside any Pallas kernel.  The reference's sharding
constraints have no counterpart here and are dropped.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.models.layers import dense_init

# The reference regroups decode rows across the batch into groups of its
# data-parallel size, which is 16 when no device mesh is active (serving
# and every test run without one).  The port has no mesh, so it keeps that
# constant: the grouping decides which tokens share an expert's capacity,
# and with it which are dropped.
_DECODE_GROUPS = (16, 16, 8, 4, 2)


def moe_init(gen: torch.Generator, cfg, dtype, device) -> dict:
    """Same tree as the reference: an f32 ``router`` (d, E), expert stacks
    ``w_gate``/``w_up`` (E, d, f) and ``w_down`` (E, f, d), and a
    ``shared`` SwiGLU of width f * num_shared_experts.  The expert stacks
    are drawn in ``dtype`` directly (no f32 copy of them is ever made)."""
    d, f, e = cfg.d_model, cfg.moe_d_ff or cfg.d_ff, cfg.num_experts

    def stack(shape, scale):
        w = torch.randn(shape, generator=gen, device=device, dtype=dtype)
        return w.mul_(scale)

    p = {
        "router": dense_init(gen, d, e, torch.float32, device),
        "w_gate": stack((e, d, f), d ** -0.5),
        "w_up": stack((e, d, f), d ** -0.5),
        "w_down": stack((e, f, d), f ** -0.5),
    }
    if cfg.num_shared_experts:
        fs = f * cfg.num_shared_experts
        p["shared"] = {"gate": dense_init(gen, d, fs, dtype, device),
                       "up": dense_init(gen, d, fs, dtype, device),
                       "down": dense_init(gen, fs, d, dtype, device)}
    return p


def _capacity(tokens: int, cfg) -> int:
    c = -(-int(tokens * cfg.top_k * cfg.capacity_factor)
          // cfg.num_experts)
    # floor at top_k (a group must fit one token's own experts), round to 4
    return max(cfg.top_k, -(-c // 4) * 4)


def _top_k(probs: torch.Tensor, k: int):
    """``jax.lax.top_k``: the k largest, ties to the lower index.
    ``torch.topk`` promises no order among ties; a stable descending sort
    keeps equal values in index order."""
    vals, idx = torch.sort(probs, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def moe_apply(p: dict, x: torch.Tensor, cfg, *, regroup: bool = True):
    """x (B, S, D) -> (out (B, S, D), aux load-balance loss, f32 scalar).

    Every row of ``x`` is routed and takes capacity, padded rows of a
    ragged mixed block included, as in the reference.  ``regroup=False``
    keeps every batch row its own sequence for decode too (the reference's
    per-slot decode, where a vmap over slots hands it one row at a time)."""
    b0, s0, d = x.shape
    e, k = cfg.num_experts, cfg.top_k
    # decode (s=1): regroup tokens across the batch so capacity is shared
    if s0 == 1 and b0 > 1 and regroup:
        g = next((c for c in _DECODE_GROUPS if b0 % c == 0), 1)
        b, s = g, b0 // g
        x = x.reshape(b, s, d)
    else:
        b, s = b0, s0
    cap = _capacity(s, cfg)

    logits = torch.einsum("bsd,de->bse", x.float(), p["router"].float())
    probs = torch.softmax(logits, dim=-1)
    gate, eid = _top_k(probs, k)                             # (B, S, k)
    gate = gate / gate.sum(-1, keepdim=True).clamp_min(1e-9)

    # Switch aux loss: E * sum_e (fraction routed to e) * (mean prob of e)
    onehot = (eid[..., None] == torch.arange(e, device=x.device)).int()
    frac = onehot.any(2).float().mean((0, 1))
    aux = e * torch.sum(frac * probs.mean((0, 1)))

    # ---- per-sequence positions: cumsum of one-hot along (S*k) -----------
    oh = onehot.reshape(b, s * k, e)
    cum = torch.cumsum(oh, dim=1)                            # (B, S*k, E)
    flat_eid = eid.reshape(b, s * k)
    pos = torch.gather(cum, -1, flat_eid[..., None])[..., 0] - 1
    keep = pos < cap
    dest = torch.where(keep, flat_eid * cap + pos, e * cap)  # (B, S*k)
    src = torch.arange(s * k, device=x.device) // k

    # ---- row-local scatter into the expert buffer (row e*cap: overflow) ---
    buf = torch.zeros((b, e * cap + 1, d), dtype=x.dtype, device=x.device)
    rows = torch.arange(b, device=x.device)[:, None]
    buf[rows, dest] = x[:, src]
    hidden = buf[:, :-1].reshape(b, e, cap, d)

    # ---- expert compute (batched products over E) -------------------------
    act = F.silu(torch.einsum("becd,edf->becf", hidden, p["w_gate"]))
    up = torch.einsum("becd,edf->becf", hidden, p["w_up"])
    out_e = torch.einsum("becf,efd->becd", act * up, p["w_down"])
    out_rows = out_e.reshape(b, e * cap, d)

    # ---- row-local gather + static-index combine --------------------------
    slot_out = out_rows[rows, dest.clamp_max(e * cap - 1)]  # (B, S*k, D)
    w = (gate.reshape(b, s * k) * keep).to(x.dtype)
    combined = (slot_out * w[..., None]).reshape(b, s, k, d).sum(2)

    if "shared" in p:
        sp = p["shared"]
        combined = combined + (F.silu(x @ sp["gate"]) * (x @ sp["up"])) \
            @ sp["down"]
    return combined.reshape(b0, s0, d), aux

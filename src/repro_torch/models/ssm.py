"""Mamba-2 SSD block (port of ``repro.models.ssm``; state-space duality,
arXiv:2405.21060).

Prefill runs the chunked SSD algorithm (quadratic within a chunk, linear
state passing between chunks); decode is the O(1) recurrent update on a
(B, H, P, N) state.  The group count G divides the heads (mamba2-780m:
G = 1).  Formulas, orders of reduction and dtypes follow the reference:
the segment sums are differences of one cumsum with ``-inf`` above the
diagonal, and the carried state is cast to ``c``'s dtype before the
off-diagonal product.  The cache ({"conv", "state"}) is updated in place.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.models.layers import dense_init, rms_norm


def _segsum(a: torch.Tensor) -> torch.Tensor:
    """(..., Q) -> (..., Q, Q) lower-triangular segment sums:
    out[..., i, j] = sum_{j < l <= i} a[..., l] (-inf above the
    diagonal)."""
    q = a.shape[-1]
    cs = torch.cumsum(a, dim=-1)
    diff = cs[..., :, None] - cs[..., None, :]
    mask = torch.tril(torch.ones((q, q), dtype=torch.bool, device=a.device))
    return torch.where(mask, diff, -torch.inf)


def ssm_init(gen: torch.Generator, cfg, dtype, device) -> dict:
    d = cfg.d_model
    d_in = cfg.expand * d
    h, n, g = cfg.ssm_heads, cfg.ssm_state, cfg.ssm_groups
    proj_out = 2 * d_in + 2 * g * n + h
    conv = torch.randn((cfg.conv_kernel, d_in + 2 * g * n), generator=gen,
                       device=device)
    return {
        "in_proj": dense_init(gen, d, proj_out, dtype, device),
        "conv_w": (conv * 0.1).to(dtype),
        "A_log": torch.zeros((h,), dtype=torch.float32, device=device),
        "D": torch.ones((h,), dtype=torch.float32, device=device),
        "dt_bias": torch.zeros((h,), dtype=torch.float32, device=device),
        "norm": torch.zeros((d_in,), dtype=dtype, device=device),
        "out_proj": dense_init(gen, d_in, d, dtype, device),
    }


def _split_proj(cfg, z_all):
    """-> (gate z, conv input xbc, dt (.., H))."""
    d_in = cfg.expand * cfg.d_model
    g, n = cfg.ssm_groups, cfg.ssm_state
    return (z_all[..., :d_in], z_all[..., d_in:2 * d_in + 2 * g * n],
            z_all[..., 2 * d_in + 2 * g * n:])


def carried_conv_state(full: torch.Tensor, k: int, q_lens) -> torch.Tensor:
    """The K-1 context rows a causal conv carries out of ``full`` (B, K-1
    + S, C): its last rows, or with ragged ``q_lens`` each lane's rows
    ending at its own valid length (``q_lens[b] == 0``: the incoming
    state)."""
    if q_lens is None:
        return full[:, full.shape[1] - (k - 1):]
    idx = torch.as_tensor(q_lens, device=full.device).long()[:, None] \
        + torch.arange(k - 1, device=full.device)[None]
    return torch.gather(full, 1, idx[..., None].expand(-1, -1,
                                                       full.shape[-1]))


def _causal_conv(xbc, conv_w, state=None, q_lens=None):
    """Depthwise causal conv over time, then SiLU.  xbc (B, S, C); conv_w
    (K, C); ``state`` (B, K-1, C) carries context across steps (None:
    zeros).  -> (activations (B, S, C), carried-out state (B, K-1, C))."""
    k = conv_w.shape[0]
    if state is None:
        pad = torch.zeros((xbc.shape[0], k - 1, xbc.shape[-1]),
                          dtype=xbc.dtype, device=xbc.device)
    else:
        pad = state.to(xbc.dtype)
    full = torch.cat([pad, xbc], dim=1)
    s = xbc.shape[1]
    out = sum(full[:, i:i + s] * conv_w[i] for i in range(k))
    return F.silu(out), carried_conv_state(full, k, q_lens)


def ssd_chunked(x, dt, a_log, b, c, chunk: int, init=None):
    """Chunked SSD scan.

    x (B, S, H, P); dt (B, S, H) post-softplus f32; b, c (B, S, G, N).
    ``init`` (B, H, P, N) seeds the inter-chunk recurrence (resuming from
    a cached state); None starts from zeros.  -> (y (B, S, H, P) f32,
    final state (B, H, P, N) f32)."""
    bsz, s, h, p_dim = x.shape
    g = b.shape[2]
    assert s % chunk == 0, (s, chunk)
    nc = s // chunk
    rep = h // g
    a = -torch.exp(a_log)                                     # (H,)

    xc = x.reshape(bsz, nc, chunk, h, p_dim)
    dtc = dt.reshape(bsz, nc, chunk, h)
    n_state = b.shape[-1]
    bc = b.reshape(bsz, nc, chunk, g, n_state)
    cc = c.reshape(bsz, nc, chunk, g, n_state)
    if g != h:
        bc = torch.repeat_interleave(bc, rep, dim=3)
        cc = torch.repeat_interleave(cc, rep, dim=3)

    da = dtc * a                                              # (B,nc,Q,H)
    da_cs = torch.cumsum(da, dim=2)
    xdt = xc * dtc[..., None]                                 # f32

    # intra-chunk (diagonal) term
    l_mat = torch.exp(_segsum(da.movedim(2, 3)))              # (B,nc,H,Q,Q)
    scores = torch.einsum("bcqhn,bckhn->bchqk", cc, bc)
    y_diag = torch.einsum("bchqk,bchqk,bckhp->bcqhp",
                          scores.float(), l_mat, xdt)

    # chunk-final states
    decay_states = torch.exp(da_cs[:, :, -1:, :] - da_cs)    # (B,nc,Q,H)
    states = torch.einsum("bckhn,bckh,bckhp->bchpn", bc.float(),
                          decay_states, xdt)

    # inter-chunk recurrence over the chunks, in order
    chunk_decay = torch.exp(da_cs[:, :, -1, :])               # (B,nc,H)
    h_prev = torch.zeros((bsz, h, p_dim, n_state), dtype=torch.float32,
                         device=x.device) if init is None else init.float()
    h_init = []
    for ci in range(nc):
        h_init.append(h_prev)
        h_prev = h_prev * chunk_decay[:, ci, :, None, None] \
            + states[:, ci].float()
    h_init = torch.stack(h_init, dim=1)                       # (B,nc,H,P,N)

    # contribution of the incoming state to each position
    decay_out = torch.exp(da_cs)                              # (B,nc,Q,H)
    y_off = torch.einsum("bcqhn,bchpn,bcqh->bcqhp", cc,
                         h_init.to(cc.dtype), decay_out.to(cc.dtype))
    y = (y_diag + y_off).reshape(bsz, s, h, p_dim)
    return y, h_prev


def ssm_apply(p: dict, x: torch.Tensor, cfg, *, cache=None, pos=None,
              q_lens=None):
    """Mamba2 mixer -> (y, cache).  ``cache`` = {"conv": (B, K-1, C),
    "state": (B, H, P, N) f32}, updated in place.

    The reference's three branches: one token with a cache and no
    ``q_lens`` decodes (the recurrent update); with a cache and ``pos``
    the chunked scan *resumes* from the cached state and conv context
    (chunked prefill, speculative verification); otherwise the prompt
    starts from zeros (filling ``cache`` when given).  Prefill pads S up
    to ``cfg.ssm_chunk``.  Ragged ``q_lens`` gives padded positions
    ``dt = 0`` (decay 1, no input: the state passes through) and reads the
    carried-out conv state at each lane's length, so a ``q_lens[b] == 0``
    lane leaves its cache bit for bit as it was."""
    bsz, s, _ = x.shape
    d_in = cfg.expand * cfg.d_model
    h, n, g = cfg.ssm_heads, cfg.ssm_state, cfg.ssm_groups
    p_dim = d_in // h
    decode = cache is not None and s == 1 and q_lens is None
    resume = cache is not None and pos is not None and not decode

    z, xbc, dt = _split_proj(cfg, x @ p["in_proj"])
    dt = F.softplus(dt.float() + p["dt_bias"])
    if q_lens is not None:
        valid = torch.arange(s, device=x.device)[None] < \
            torch.as_tensor(q_lens, device=x.device)[:, None]   # (B, S)
        dt = torch.where(valid[..., None], dt, 0.0)

    xbc, new_conv = _causal_conv(xbc, p["conv_w"],
                                 cache["conv"] if (decode or resume)
                                 else None, q_lens=q_lens)
    xs = xbc[..., :d_in].reshape(bsz, s, h, p_dim)
    b = xbc[..., d_in:d_in + g * n].reshape(bsz, s, g, n)
    c = xbc[..., d_in + g * n:].reshape(bsz, s, g, n)

    if decode:
        a = -torch.exp(p["A_log"])                            # (H,)
        da = torch.exp(dt[:, 0] * a)                          # (B, H)
        rep = h // g
        bfull = torch.repeat_interleave(b[:, 0], rep, dim=1)  # (B, H, N)
        cfull = torch.repeat_interleave(c[:, 0], rep, dim=1)
        xdt = xs[:, 0] * dt[:, 0][..., None]                  # (B, H, P)
        state = cache["state"] * da[..., None, None] \
            + torch.einsum("bhp,bhn->bhpn", xdt.float(), bfull.float())
        y = torch.einsum("bhpn,bhn->bhp", state, cfull.float())
        y = y[:, None] + xs * p["D"][None, None, :, None]
        cache["conv"].copy_(new_conv)
        cache["state"].copy_(state)
    else:
        pad = (-s) % cfg.ssm_chunk
        if pad:
            xs_p = F.pad(xs, (0, 0, 0, 0, 0, pad))
            dt_p = F.pad(dt, (0, 0, 0, pad))
            b_p = F.pad(b, (0, 0, 0, 0, 0, pad))
            c_p = F.pad(c, (0, 0, 0, 0, 0, pad))
        else:
            xs_p, dt_p, b_p, c_p = xs, dt, b, c
        y, final = ssd_chunked(xs_p, dt_p, p["A_log"], b_p, c_p,
                               cfg.ssm_chunk,
                               init=cache["state"] if resume else None)
        y = y[:, :s] + xs * p["D"][None, None, :, None]
        if cache is not None:
            cache["conv"].copy_(new_conv.to(cache["conv"].dtype))
            cache["state"].copy_(final)

    y = y.reshape(bsz, s, d_in).to(x.dtype)
    y = rms_norm(p["norm"], y * F.silu(z), cfg.norm_eps)
    return y @ p["out_proj"], cache


def ssm_cache_spec(cfg, batch: int) -> dict:
    """Shape/dtype stand-ins (meta tensors) of one SSM block's cache: the
    conv context and the f32 recurrent state, neither scaling with
    length."""
    d_in = cfg.expand * cfg.d_model
    g, n, h = cfg.ssm_groups, cfg.ssm_state, cfg.ssm_heads
    return {
        "conv": torch.empty((batch, cfg.conv_kernel - 1, d_in + 2 * g * n),
                            dtype=cfg.torch_dtype, device="meta"),
        "state": torch.empty((batch, h, d_in // h, n), dtype=torch.float32,
                             device="meta"),
    }

"""Attention: GQA and MLA over per-slot lane caches or paged KV pools
(port of ``repro.models.attention``).

Two ways to read the KV cache, as in the reference:

* **lanes** (the ``gathered`` backend, monolithic slots, standalone
  prefill caches): plain PyTorch in the reference's own formulation —
  :func:`flash_attention` for a whole prompt, :func:`chunk_attention` for
  a prefill chunk against a partially filled cache, :func:`decode_attention`
  for one token.  These run on whatever device the tensors sit on and are
  the port's oracle for the hand-written kernels, so they never call them.
* **page pools** (``cuda_paged``): this step's token block is scattered
  into each slot's pages and ``kernels.paged_attention`` walks the page
  table.  Under ``kv_codec="cluster"`` the pools hold int8 codebook codes
  with f32 scale pools beside them, decoded inside the kernel.

Caches are updated in place and returned (the reference's donated
buffers): a lane cache's rows, a prefill's whole cache, a pool's pages.
"""

from __future__ import annotations

import dataclasses
import math

import torch

from repro_torch.kernels import kv_codec
from repro_torch.kernels.paged_attention import paged_mixed_attention
from repro_torch.models.layers import apply_rope, dense_init, rms_norm, softcap

NEG_INF = -1e30


@dataclasses.dataclass(frozen=True)
class PagedContext:
    """Per-step state of the ``cuda_paged`` attention backend: ``table``
    maps each slot's logical pages to physical pages of the shared pool
    and ``page_size`` is the logical positions-per-page constant."""

    table: torch.Tensor      # (S, pages_per_slot) int32
    page_size: int

    def write(self, pool: torch.Tensor, values: torch.Tensor, pos,
              q_lens=None) -> torch.Tensor:
        """Scatter this step's per-slot token block ``values`` (S, Q, ...)
        into each slot's pages of ``pool`` (n_pages, page, ...): token
        ``i`` of slot ``s`` lands at absolute position ``pos[s] + i`` for
        ``i < q_lens[s]``; padded tokens go to the page-0 dummy sink.

        Unlike the reference's functional ``.at[].set``, the pool is
        updated in place (it is the only copy of the cache) and returned."""
        qn = values.shape[1]
        p = pos.long()[:, None] + torch.arange(qn, device=pool.device)[None]
        tab = self.table.long()
        lidx = (p // self.page_size).clamp(0, tab.shape[1] - 1)
        pids = torch.gather(tab, 1, lidx)
        if q_lens is not None:
            valid = torch.arange(qn, device=pool.device)[None] \
                < q_lens.long()[:, None]
            pids = torch.where(valid, pids, 0)
            p = torch.where(valid, p, 0)
        pool[pids, p % self.page_size] = values.to(pool.dtype)
        return pool


# ---------------------------------------------------------------------------
# masks
# ---------------------------------------------------------------------------

def _allowed(q_pos, k_pos, *, causal: bool, window: int, prefix_len: int):
    """Boolean mask (..., Sq, Sk) of attendable pairs."""
    q = q_pos[..., :, None]
    k = k_pos[..., None, :]
    ok = (k <= q) if causal else torch.ones(
        torch.broadcast_shapes(q.shape, k.shape), dtype=torch.bool,
        device=q.device)
    if window:
        ok &= k > q - window
    if prefix_len:
        ok |= k < prefix_len
    return ok


# ---------------------------------------------------------------------------
# lane attention: whole prompt, decode token, prefill chunk
# ---------------------------------------------------------------------------

def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, window: int = 0,
                    prefix_len: int = 0, attn_softcap: float = 0.0,
                    q_offset: int = 0, q_chunk: int = 4096) -> torch.Tensor:
    """q (B, Sq, H, D), k (B, Sk, KH, D), v (B, Sk, KH, Dv) -> (B, Sq, H,
    Dv) f32: attention over q blocks of ``gcd(Sq, q_chunk)`` rows, each
    against every key with its own softmax, so no (Sq, Sk) score matrix
    of the whole prompt is held at once.

    As the reference: q is scaled in the model dtype, products accumulate
    in f32 (bf16 operands are exact in f32), the probabilities are cast
    back to the value dtype before the second product."""
    b, sq, h, d = q.shape
    sk, kh, dv = k.shape[1], k.shape[2], v.shape[-1]
    g = h // kh
    q_chunk = math.gcd(sq, q_chunk)
    nq = sq // q_chunk
    qs = (q * torch.tensor(d ** -0.5, dtype=q.dtype)).reshape(
        b, nq, q_chunk, kh, g, d)
    kf, vf = k.float(), v.float()
    k_pos = torch.arange(sk, device=q.device)
    outs = []
    for qi in range(nq):
        q_pos = q_offset + qi * q_chunk + torch.arange(q_chunk,
                                                       device=q.device)
        s = torch.einsum("bqhgd,bkhd->bhgqk", qs[:, qi].float(), kf)
        if attn_softcap:
            s = softcap(s, attn_softcap)
        mask = _allowed(q_pos, k_pos, causal=causal, window=window,
                        prefix_len=prefix_len)               # (cq, Sk)
        s = torch.where(mask, s, NEG_INF)
        p = torch.exp(s - s.amax(-1, keepdim=True))
        p = p / p.sum(-1, keepdim=True).clamp_min(1e-20)
        outs.append(torch.einsum("bhgqk,bkhd->bqhgd",
                                 p.to(v.dtype).float(), vf))
    return torch.cat(outs, dim=1).reshape(b, sq, h, dv)


def decode_attention(q: torch.Tensor, k_cache: torch.Tensor,
                     v_cache: torch.Tensor, cur_pos, *, window: int = 0,
                     attn_softcap: float = 0.0,
                     rolling: bool = False) -> torch.Tensor:
    """q (B, 1, H, D) over a contiguous per-lane cache (B, Smax, KH, D)
    -> (B, 1, H, Dv) f32.  ``cur_pos`` is shared (a scalar: every lane at
    one depth) or per lane ``(B,)``.  A ``rolling`` cache holds the last
    ``min(cur_pos + 1, Smax)`` keys in slots ``p % Smax``."""
    b, smax, kh, d = k_cache.shape
    h = q.shape[2]
    g = h // kh
    qs = (q.float() * d ** -0.5).reshape(b, kh, g, d)
    s = torch.einsum("bhgd,bkhd->bhgk", qs, k_cache.float())
    if attn_softcap:
        s = softcap(s, attn_softcap)
    slot = torch.arange(smax, device=q.device)
    cur = torch.as_tensor(cur_pos, device=q.device)[..., None]  # (1,)|(B, 1)
    if rolling:
        valid = slot < torch.clamp(cur + 1, max=smax)
    else:
        valid = slot <= cur
        if window:
            valid &= slot > cur - window
    valid = valid if valid.ndim == 2 else valid[None]          # (B|1, Smax)
    s = torch.where(valid[:, None, None], s, NEG_INF)
    p = torch.softmax(s, dim=-1)
    out = torch.einsum("bhgk,bkhd->bhgd", p, v_cache.float())
    return out.reshape(b, 1, h, v_cache.shape[-1])


def chunk_attention(q, k, v, k_past, v_past, q_pos, k_pos, *,
                    window: int = 0, attn_softcap: float = 0.0,
                    q_lens=None) -> torch.Tensor:
    """A prefill chunk q (B, S, H, D) with its own keys k/v (B, S, KH, .)
    against the resident cache k_past/v_past (B, P, KH, .) -> (B, S, H,
    Dv) f32.

    ``k_pos`` (P,) or (B, P) is each cache row's absolute position
    (negative: never written; a rolling cache is physically reordered),
    ``q_pos`` (S,) or (B, S) the chunk's; causality and the window are
    enforced on absolute positions, as monolithic prefill's mask does.  The
    chunk's keys come after the resident ones, so a rolling cache whose
    write-back would overwrite still-needed keys reads them first.
    ``q_lens`` (B,) marks ragged padding: tokens ``i >= q_lens[b]`` act as
    no key and their rows are garbage the caller drops."""
    dev = q.device
    kk = torch.cat([k_past.float(), k.float()], dim=1)
    vv = torch.cat([v_past.float(), v.float()], dim=1)
    b, s, h, d = q.shape
    q_pos2 = torch.as_tensor(q_pos, device=dev)
    q_pos2 = q_pos2[None] if q_pos2.ndim == 1 else q_pos2       # (B|1, S)
    k_pos2 = torch.as_tensor(k_pos, device=dev)
    k_pos2 = k_pos2[None] if k_pos2.ndim == 1 else k_pos2       # (B|1, P)
    chunk_pos = q_pos2
    if q_lens is not None:
        chunk_pos = torch.where(
            torch.arange(s, device=dev)[None]
            < torch.as_tensor(q_lens, device=dev)[:, None], q_pos2, -1)
    bb = max(q_pos2.shape[0], k_pos2.shape[0], chunk_pos.shape[0])
    pos_all = torch.cat([k_pos2.expand(bb, k_pos2.shape[1]),
                         chunk_pos.expand(bb, s)], dim=1)     # (B|1, P+S)
    kh = kk.shape[2]
    g = h // kh
    qs = (q.float() * d ** -0.5).reshape(b, s, kh, g, d)
    sc = torch.einsum("bqhgd,bkhd->bhgqk", qs, kk)
    if attn_softcap:
        sc = softcap(sc, attn_softcap)
    ok = (pos_all[:, None, :] <= q_pos2[..., None]) & \
        (pos_all[:, None, :] >= 0)
    if window:
        ok &= pos_all[:, None, :] > q_pos2[..., None] - window
    sc = torch.where(ok[:, None, None], sc, NEG_INF)
    p = torch.softmax(sc, dim=-1)
    out = torch.einsum("bhgqk,bkhd->bqhgd", p, vv)
    return out.reshape(b, s, h, vv.shape[-1])


def _codec_roundtrip(x: torch.Tensor, axes: tuple) -> torch.Tensor:
    """``x`` quantised onto the ``kv_codec="cluster"`` codebook and
    decoded straight back (one scale per block of the trailing ``axes``).

    Lane paths under the codec attend to these values, as the kernel
    attends to its decoded code pools; the encode is idempotent, so
    writing them into the code pools later re-encodes them losslessly."""
    codes, sc = kv_codec.encode(x, axes)
    rest = codes.ndim - sc.ndim
    return kv_codec.decode(
        codes, sc.reshape(*sc.shape, *(1,) * rest)).to(x.dtype)


def _rolling_slot_positions(pos, smax: int) -> torch.Tensor:
    """Absolute position held by each slot of a rolling cache before
    positions >= ``pos`` are written (negative: never written): slot j
    holds the largest p < pos with p = j (mod smax).  ``pos`` scalar ->
    (smax,); ``pos`` (B,) -> (B, smax)."""
    pos = torch.as_tensor(pos)
    slot = torch.arange(smax, device=pos.device)
    last = pos[..., None] - 1
    return (last - (last - slot) % smax).reshape(
        (-1, smax) if pos.ndim else (smax,))


def _lane_chunk_write(cache: torch.Tensor, new: torch.Tensor, pos,
                      q_lens=None, *, rolling: bool) -> torch.Tensor:
    """Write chunk K/V ``new`` (B, S, ...) into per-lane caches (B, Smax,
    ...) at positions ``pos`` (scalar or (B,)) + i, in place.  A rolling
    cache wraps at ``p % Smax`` and keeps only a lane's last ``Smax`` real
    tokens; rows ``i >= q_lens[b]`` are padding and are not written."""
    b, s = new.shape[:2]
    smax = cache.shape[1]
    dev = cache.device
    i = torch.arange(s, device=dev)[None]                       # (1, S)
    pos = torch.as_tensor(pos, device=dev).long().reshape(-1, 1) \
        .expand(b, 1)
    ql = torch.full((b, 1), s, device=dev) if q_lens is None \
        else torch.as_tensor(q_lens, device=dev).long()[:, None]
    keep = i < ql
    if rolling:
        keep &= i >= ql - smax
        idx = (pos + i) % smax
    else:
        keep &= pos + i < smax
        idx = pos + i
    lane = torch.arange(b, device=dev)[:, None].expand(b, s)
    cache[lane[keep], idx[keep]] = new[keep].to(cache.dtype)
    return cache


def _fill(cache: torch.Tensor, rows: torch.Tensor) -> torch.Tensor:
    """Monolithic prefill's cache: ``rows`` (B, n <= Smax, ...) at slots
    0..n-1, zeros after them; written in place."""
    cache.zero_()
    cache[:, :rows.shape[1]] = rows.to(cache.dtype)
    return cache


# ---------------------------------------------------------------------------
# GQA attention layer
# ---------------------------------------------------------------------------

def attn_init(gen: torch.Generator, cfg, dtype, device) -> dict:
    d, h, kh, hd = cfg.d_model, cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    return {
        "wq": dense_init(gen, d, h * hd, dtype, device),
        "wk": dense_init(gen, d, kh * hd, dtype, device),
        "wv": dense_init(gen, d, kh * hd, dtype, device),
        "wo": dense_init(gen, h * hd, d, dtype, device),
    }


def _qkv(p, x, cfg, positions):
    b, s, _ = x.shape
    h, kh, hd = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    q = (x @ p["wq"]).reshape(b, s, h, hd)
    k = (x @ p["wk"]).reshape(b, s, kh, hd)
    v = (x @ p["wv"]).reshape(b, s, kh, hd)
    q = apply_rope(q, positions, cfg.rope_theta)
    k = apply_rope(k, positions, cfg.rope_theta)
    return q, k, v


def _attn_paged(p, x, cfg, window, cache, pos, paged, q_lens, scales):
    """``cuda_paged``: one ragged block of 1..s tokens per slot straight
    over the page pools ``cache`` ({"k", "v"}, updated in place).

    ``scales`` (``kv_codec="cluster"``): the {"k", "v"} scale pools
    (n_pages, page) f32 beside int8 code pools; this step's K/V are
    encoded (one scale per (slot, token)), codes and scales are written
    in place, and the return grows to ``(y, cache, scales)``."""
    b, s, _ = x.shape
    ql = (torch.full((b,), s, dtype=torch.int32, device=x.device)
          if q_lens is None else q_lens)
    positions = pos[:, None] + torch.arange(s, device=x.device)[None]
    q, k, v = _qkv(p, x, cfg, positions)
    hd = cfg.head_dim
    kw = {}
    if scales is not None:
        k, k_sc = kv_codec.encode(k, axes=(-2, -1))
        v, v_sc = kv_codec.encode(v, axes=(-2, -1))
        scales = {"k": paged.write(scales["k"], k_sc, pos, q_lens),
                  "v": paged.write(scales["v"], v_sc, pos, q_lens)}
        kw = dict(k_scales=scales["k"], v_scales=scales["v"],
                  codebook=kv_codec.codebook(x.device))
    k_pool = paged.write(cache["k"], k, pos, q_lens)
    v_pool = paged.write(cache["v"], v, pos, q_lens)
    out = paged_mixed_attention(
        q.float() * hd ** -0.5, k_pool, v_pool, paged.table, pos + ql, ql,
        window=window, softcap_val=cfg.attn_logit_softcap,
        page_size=paged.page_size, **kw)[..., :hd]
    y = out.reshape(b, s, -1).to(x.dtype) @ p["wo"]
    if scales is not None:
        return y, {"k": k_pool, "v": v_pool}, scales
    return y, {"k": k_pool, "v": v_pool}


def attn_apply(p: dict, x: torch.Tensor, cfg, *, kind: str,
               cache: dict | None = None, pos=None, prefix_len: int = 0,
               paged: PagedContext | None = None,
               q_lens: torch.Tensor | None = None,
               scales: dict | None = None, kv_quant: bool = False):
    """-> (y, cache); with ``scales`` -> (y, cache, scales).  The branch
    follows the reference:

    * ``paged``: the page pools, through the kernel (``_attn_paged``);
    * a lane cache with ``pos`` and more than one token (or ragged
      ``q_lens``): a chunk at absolute positions ``pos + i`` against the
      resident rows, written back after attending (write-after-attend, so
      a rolling window never reads its own overwrites);
    * a lane cache with ``pos`` and one token: decode, shared ``pos`` or
      per lane ``(B,)``, written before attending;
    * otherwise the whole prompt from position 0 (``cache=None``: no
      cache), filling ``cache`` when given — a window shorter than the
      prompt keeps the last ``Smax`` keys rolled to ``p % Smax``.

    ``kv_quant`` (``kv_codec="cluster"`` on a lane cache) rounds the new
    rows through the codec before they are written and attended, on
    full-history lanes only: rolling lanes stay raw, as they never enter
    the code pools."""
    window = cfg.window if kind in ("swa", "local") else 0
    if paged is not None:
        return _attn_paged(p, x, cfg, window, cache, pos, paged, q_lens,
                           scales)
    b, s, _ = x.shape
    dev = x.device
    causal = kind != "bidir"
    rolling = bool(window)
    if cache is not None and pos is not None:
        pos = torch.as_tensor(pos, device=dev)
    if cache is not None and pos is not None and \
            (s > 1 or q_lens is not None):
        q_pos = pos[..., None] + torch.arange(s, device=dev)   # (S,)|(B, S)
        q, k, v = _qkv(p, x, cfg, q_pos if q_pos.ndim == 2 else q_pos[None])
        smax = cache["k"].shape[1]
        if kv_quant and not rolling:
            k = _codec_roundtrip(k, (-2, -1))
            v = _codec_roundtrip(v, (-2, -1))
        if rolling:
            k_pos = _rolling_slot_positions(pos, smax)
        else:
            slot = torch.arange(smax, device=dev)
            k_pos = torch.where(slot < pos[..., None], slot, -1)
        out = chunk_attention(q, k, v, cache["k"], cache["v"], q_pos, k_pos,
                              window=window,
                              attn_softcap=cfg.attn_logit_softcap,
                              q_lens=q_lens)
        for name, new in (("k", k), ("v", v)):
            _lane_chunk_write(cache[name], new, pos, q_lens, rolling=rolling)
    elif cache is not None and pos is not None:
        positions = pos.reshape(-1, 1).expand(b, 1)
        q, k, v = _qkv(p, x, cfg, positions)
        if kv_quant and not rolling:
            k = _codec_roundtrip(k, (-2, -1))
            v = _codec_roundtrip(v, (-2, -1))
        slot = positions[:, 0] % cache["k"].shape[1] if rolling \
            else positions[:, 0]
        lane = torch.arange(b, device=dev)
        cache["k"][lane, slot] = k[:, 0].to(cache["k"].dtype)
        cache["v"][lane, slot] = v[:, 0].to(cache["v"].dtype)
        out = decode_attention(q, cache["k"], cache["v"], pos, window=window,
                               attn_softcap=cfg.attn_logit_softcap,
                               rolling=rolling)
    else:
        q, k, v = _qkv(p, x, cfg, torch.arange(s, device=dev)[None])
        out = flash_attention(q, k, v, causal=causal, window=window,
                              prefix_len=prefix_len,
                              attn_softcap=cfg.attn_logit_softcap)
        if cache is not None:
            smax = cache["k"].shape[1]
            for name, new in (("k", k), ("v", v)):
                keep = torch.roll(new[:, -smax:], s % smax, dims=1) \
                    if window and smax < s else new[:, :smax]
                _fill(cache[name], keep)
    y = out.reshape(b, s, -1).to(x.dtype) @ p["wo"]
    return y, cache


def attn_cache_spec(cfg, kind: str, batch: int, max_len: int) -> dict:
    """Shape/dtype stand-ins (meta tensors) of one attention block's
    cache: a window shorter than ``max_len`` keeps a rolling cache of
    ``window`` rows."""
    window = cfg.window if kind in ("swa", "local") else 0
    length = min(window, max_len) if window else max_len
    shp = (batch, length, cfg.num_kv_heads, cfg.head_dim)
    return {"k": torch.empty(shp, dtype=cfg.torch_dtype, device="meta"),
            "v": torch.empty(shp, dtype=cfg.torch_dtype, device="meta")}


# ---------------------------------------------------------------------------
# cross attention (whisper decoder)
# ---------------------------------------------------------------------------

def cross_attn_init(gen: torch.Generator, cfg, dtype, device) -> dict:
    return attn_init(gen, cfg, dtype, device)


def cross_attn_apply(p: dict, x: torch.Tensor, cfg, *, enc_kv=None,
                     enc_out=None):
    """Decoder queries ``x`` (B, S, D) over the encoder's keys and values,
    bidirectionally and without rope -> (y, {"k", "v"}).  ``enc_kv``: the
    cached {"k", "v"} (B, Se, KH, hd) a prefill computed; else they are
    computed from ``enc_out`` (B, Se, D)."""
    b, s, _ = x.shape
    h, kh, hd = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    q = (x @ p["wq"]).reshape(b, s, h, hd)
    if enc_kv is None:
        se = enc_out.shape[1]
        k = (enc_out @ p["wk"]).reshape(b, se, kh, hd)
        v = (enc_out @ p["wv"]).reshape(b, se, kh, hd)
    else:
        k, v = enc_kv["k"], enc_kv["v"]
    out = flash_attention(q, k, v, causal=False)
    return out.reshape(b, s, -1).to(x.dtype) @ p["wo"], {"k": k, "v": v}


# ---------------------------------------------------------------------------
# MLA (DeepSeek-V2): latent KV compression, absorbed attention
# ---------------------------------------------------------------------------

def mla_init(gen: torch.Generator, cfg, dtype, device) -> dict:
    d, h = cfg.d_model, cfg.num_heads
    r_kv, r_q = cfg.kv_lora_rank, cfg.q_lora_rank
    dn, dr, dv = cfg.nope_head_dim, cfg.rope_head_dim, cfg.v_head_dim
    return {
        "w_dq": dense_init(gen, d, r_q, dtype, device),
        "q_norm": torch.zeros((r_q,), dtype=dtype, device=device),
        "w_uq": dense_init(gen, r_q, h * (dn + dr), dtype, device),
        "w_dkv": dense_init(gen, d, r_kv + dr, dtype, device),
        "kv_norm": torch.zeros((r_kv,), dtype=dtype, device=device),
        "w_uk": dense_init(gen, r_kv, h * dn, dtype, device),
        "w_uv": dense_init(gen, r_kv, h * dv, dtype, device),
        "wo": dense_init(gen, h * dv, d, dtype, device),
    }


def mla_apply(p: dict, x: torch.Tensor, cfg, *, cache: dict | None = None,
              pos=None, paged: PagedContext | None = None,
              q_lens: torch.Tensor | None = None,
              scales: dict | None = None, kv_quant: bool = False):
    """-> (y, cache); with ``scales`` -> (y, cache, scales).  Caches are
    {"c_kv": latent rows (.., r_kv), "k_pe": rope-key rows (.., dr)}.

    * ``paged``: absorbed attention over the latent page pools, one
      ragged block of 1..s tokens per slot.  The latent is one shared KV
      "head" whose key has a latent part (``c_kv``, scored against
      ``q_nope`` absorbed through ``w_uk``) and a rope part (``k_pe``):
      the kernel's ``(q, k) + (q2, k2)`` split, with the latent pool
      doubling as the value pool and the scale applied to the summed
      score.  ``scales`` (``kv_codec="cluster"``): the {"c_kv", "k_pe"}
      scale pools; the latent's scale serves as key and value scale.
    * a lane cache with ``pos`` (shared, or per lane ``(B,)``): the same
      absorbed attention over the lane, for a decode token or a chunk,
      rows written before attending (ragged ``q_lens``: padding rows are
      not written); ``kv_quant`` rounds the new rows through the codec.
    * otherwise the whole prompt: the latent expanded to per-head keys and
      values through :func:`flash_attention`, filling ``cache`` when
      given."""
    b, s, _ = x.shape
    h, r_kv = cfg.num_heads, cfg.kv_lora_rank
    dn, dr, dv = cfg.nope_head_dim, cfg.rope_head_dim, cfg.v_head_dim
    dev = x.device
    decode = cache is not None and pos is not None
    if decode:
        pos = torch.as_tensor(pos, device=dev)
        positions = pos.reshape(-1, 1) + torch.arange(s, device=dev)[None]
    else:
        positions = torch.arange(s, device=dev)[None]

    cq = rms_norm(p["q_norm"], x @ p["w_dq"], cfg.norm_eps)
    q = (cq @ p["w_uq"]).reshape(b, s, h, dn + dr)
    q_nope, q_pe = q[..., :dn], q[..., dn:]
    q_pe = apply_rope(q_pe, positions, cfg.rope_theta)
    dkv = x @ p["w_dkv"]                                  # (B, S, r_kv + dr)
    c_kv = rms_norm(p["kv_norm"], dkv[..., :r_kv], cfg.norm_eps)
    k_pe = apply_rope(dkv[..., None, r_kv:], positions,
                      cfg.rope_theta)[:, :, 0]
    w_uk = p["w_uk"].reshape(r_kv, h, dn)
    w_uv = p["w_uv"].reshape(r_kv, h, dv)

    if paged is not None:
        ql = (torch.full((b,), s, dtype=torch.int32, device=dev)
              if q_lens is None else q_lens)
        kw = {}
        if scales is not None:
            c_kv, c_sc = kv_codec.encode(c_kv, axes=(-1,))
            k_pe, pe_sc = kv_codec.encode(k_pe, axes=(-1,))
            scales = {"c_kv": paged.write(scales["c_kv"], c_sc, pos, q_lens),
                      "k_pe": paged.write(scales["k_pe"], pe_sc, pos,
                                          q_lens)}
            kw = dict(k_scales=scales["c_kv"], v_scales=scales["c_kv"],
                      k2_scales=scales["k_pe"],
                      codebook=kv_codec.codebook(dev))
        c_pool = paged.write(cache["c_kv"], c_kv, pos, q_lens)
        pe_pool = paged.write(cache["k_pe"], k_pe, pos, q_lens)
        q_lat = torch.einsum("bshn,rhn->bshr", q_nope.float(),
                             w_uk.float())                # (B, S, H, r_kv)
        ctx = paged_mixed_attention(
            q_lat, c_pool[:, :, None], c_pool[:, :, None], paged.table,
            pos + ql, ql, q_pe.float(), pe_pool[:, :, None],
            scale=(dn + dr) ** -0.5, page_size=paged.page_size,
            **kw)[..., :r_kv]
        out = torch.einsum("bshr,rhv->bshv", ctx, w_uv.float())
        y = out.reshape(b, s, h * dv).to(x.dtype) @ p["wo"]
        new_cache = {"c_kv": c_pool, "k_pe": pe_pool}
        if scales is not None:
            return y, new_cache, scales
        return y, new_cache

    if decode:
        if kv_quant:
            c_kv = _codec_roundtrip(c_kv, (-1,))
            k_pe = _codec_roundtrip(k_pe, (-1,))
        c_cache, pe_cache = cache["c_kv"], cache["k_pe"]
        smax = c_cache.shape[1]
        i = torch.arange(s, device=dev)[None]
        rows = positions.expand(b, s)
        keep = rows < smax
        if q_lens is not None:
            keep &= i < torch.as_tensor(q_lens, device=dev)[:, None]
        lane = torch.arange(b, device=dev)[:, None].expand(b, s)
        c_cache[lane[keep], rows[keep]] = c_kv[keep].to(c_cache.dtype)
        pe_cache[lane[keep], rows[keep]] = k_pe[keep].to(pe_cache.dtype)
        # absorbed attention in latent space
        q_lat = torch.einsum("bshn,rhn->bshr", q_nope.float(), w_uk.float())
        s_lat = torch.einsum("bshr,bkr->bhsk", q_lat, c_cache.float())
        s_pe = torch.einsum("bshd,bkd->bhsk", q_pe.float(), pe_cache.float())
        scores = (s_lat + s_pe) * (dn + dr) ** -0.5          # (B, H, s, K)
        valid = torch.arange(smax, device=dev)[None, None] \
            <= positions[..., None]                          # (B|1, s, K)
        scores = torch.where(valid[:, None], scores, NEG_INF)
        probs = torch.softmax(scores, dim=-1)
        ctx = torch.einsum("bhsk,bkr->bshr", probs, c_cache.float())
        out = torch.einsum("bshr,rhv->bshv", ctx, w_uv.float())
        new_cache = {"c_kv": c_cache, "k_pe": pe_cache}
    else:
        k_nope = (c_kv @ p["w_uk"]).reshape(b, s, h, dn)
        v = (c_kv @ p["w_uv"]).reshape(b, s, h, dv)
        k = torch.cat([k_nope, k_pe[:, :, None].expand(b, s, h, dr)], -1)
        out = flash_attention(torch.cat([q_nope, q_pe], -1), k, v,
                              causal=True)
        new_cache = cache
        if cache is not None:
            _fill(cache["c_kv"], c_kv)
            _fill(cache["k_pe"], k_pe)
    y = out.reshape(b, s, h * dv).to(x.dtype) @ p["wo"]
    return y, new_cache


def mla_cache_spec(cfg, batch: int, max_len: int) -> dict:
    """Shape/dtype stand-ins (meta tensors) of one MLA block's cache: the
    latent and the rope key, one row per position, no head axis."""
    dt = cfg.torch_dtype
    return {"c_kv": torch.empty((batch, max_len, cfg.kv_lora_rank),
                                dtype=dt, device="meta"),
            "k_pe": torch.empty((batch, max_len, cfg.rope_head_dim),
                                dtype=dt, device="meta")}

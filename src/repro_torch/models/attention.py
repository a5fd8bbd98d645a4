"""GQA and MLA attention over paged KV pools (port of the paged branches
of ``repro.models.attention``).

Only the in-kernel backend is ported: the cache leaves are the physical
page pools shared by every slot, this step's token block is scattered into
each slot's pages, and ``kernels.paged_attention`` walks the page table.
Under ``kv_codec="cluster"`` the pools hold int8 codebook codes with f32
scale pools beside them, decoded inside the kernel.  The gathered
backend's lane paths (and with them MLA's monolithic prefill over
``flash_attention`` and its gathered decode) wait for a later slice.
"""

from __future__ import annotations

import dataclasses

import torch

from repro_torch.kernels import kv_codec
from repro_torch.kernels.paged_attention import paged_mixed_attention
from repro_torch.models.layers import apply_rope, dense_init, rms_norm


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


def attn_apply(p: dict, x: torch.Tensor, cfg, *, kind: str, cache: dict,
               pos: torch.Tensor, paged: PagedContext,
               q_lens: torch.Tensor | None = None,
               scales: dict | None = None):
    """-> (y, cache): one ragged block of 1..s tokens per slot straight
    over the page pools ``cache`` ({"k", "v"}, updated in place).

    ``scales`` (``kv_codec="cluster"``): the {"k", "v"} scale pools
    (n_pages, page) f32 beside int8 code pools; this step's K/V are
    encoded (one scale per (slot, token)), codes and scales are written
    in place, and the return grows to ``(y, cache, scales)``."""
    b, s, _ = x.shape
    window = cfg.window if kind in ("swa", "local") else 0
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


def mla_apply(p: dict, x: torch.Tensor, cfg, *, cache: dict,
              pos: torch.Tensor, paged: PagedContext,
              q_lens: torch.Tensor | None = None,
              scales: dict | None = None):
    """-> (y, cache): absorbed MLA over the latent page pools ``cache``
    ({"c_kv": (n_pages, page, r_kv), "k_pe": (n_pages, page, dr)}, updated
    in place), one ragged block of 1..s tokens per slot.

    The latent is one shared KV "head" whose key has a latent part
    (``c_kv``, scored against ``q_nope`` absorbed through ``w_uk``) and a
    rope part (``k_pe``): the kernel's ``(q, k) + (q2, k2)`` split, with
    the latent pool doubling as the value pool and the scale applied to
    the summed score.  ``scales`` (``kv_codec="cluster"``): the
    {"c_kv", "k_pe"} scale pools; the latent's scale serves as key and
    value scale, and the return grows to ``(y, cache, scales)``."""
    b, s, _ = x.shape
    h, r_kv = cfg.num_heads, cfg.kv_lora_rank
    dn, dr, dv = cfg.nope_head_dim, cfg.rope_head_dim, cfg.v_head_dim
    positions = pos[:, None] + torch.arange(s, device=x.device)[None]

    cq = rms_norm(p["q_norm"], x @ p["w_dq"], cfg.norm_eps)
    q = (cq @ p["w_uq"]).reshape(b, s, h, dn + dr)
    q_nope, q_pe = q[..., :dn], q[..., dn:]
    q_pe = apply_rope(q_pe, positions, cfg.rope_theta)
    dkv = x @ p["w_dkv"]                                  # (B, S, r_kv + dr)
    c_kv = rms_norm(p["kv_norm"], dkv[..., :r_kv], cfg.norm_eps)
    k_pe = apply_rope(dkv[..., None, r_kv:], positions,
                      cfg.rope_theta)[:, :, 0]

    ql = (torch.full((b,), s, dtype=torch.int32, device=x.device)
          if q_lens is None else q_lens)
    kw = {}
    if scales is not None:
        c_kv, c_sc = kv_codec.encode(c_kv, axes=(-1,))
        k_pe, pe_sc = kv_codec.encode(k_pe, axes=(-1,))
        scales = {"c_kv": paged.write(scales["c_kv"], c_sc, pos, q_lens),
                  "k_pe": paged.write(scales["k_pe"], pe_sc, pos, q_lens)}
        kw = dict(k_scales=scales["c_kv"], v_scales=scales["c_kv"],
                  k2_scales=scales["k_pe"],
                  codebook=kv_codec.codebook(x.device))
    c_pool = paged.write(cache["c_kv"], c_kv, pos, q_lens)
    pe_pool = paged.write(cache["k_pe"], k_pe, pos, q_lens)
    w_uk = p["w_uk"].reshape(r_kv, h, dn)
    q_lat = torch.einsum("bshn,rhn->bshr", q_nope.float(),
                         w_uk.float())                    # (B, S, H, r_kv)
    ctx = paged_mixed_attention(
        q_lat, c_pool[:, :, None], c_pool[:, :, None], paged.table,
        pos + ql, ql, q_pe.float(), pe_pool[:, :, None],
        scale=(dn + dr) ** -0.5, page_size=paged.page_size, **kw)[..., :r_kv]
    w_uv = p["w_uv"].reshape(r_kv, h, dv)
    out = torch.einsum("bshr,rhv->bshv", ctx, w_uv.float())  # (B, S, H, dv)
    y = out.reshape(b, s, h * dv).to(x.dtype) @ p["wo"]
    new_cache = {"c_kv": c_pool, "k_pe": pe_pool}
    if scales is not None:
        return y, new_cache, scales
    return y, new_cache


def mla_cache_spec(cfg, batch: int, max_len: int) -> dict:
    """Shape/dtype stand-ins (meta tensors) of one MLA block's cache: the
    latent and the rope key, one row per position, no head axis."""
    dt = cfg.torch_dtype
    return {"c_kv": torch.empty((batch, max_len, cfg.kv_lora_rank),
                                dtype=dt, device="meta"),
            "k_pe": torch.empty((batch, max_len, cfg.rope_head_dim),
                                dtype=dt, device="meta")}

"""GQA attention over paged KV pools (port of the paged branch of
``repro.models.attention``).

Only the in-kernel backend is ported: the cache leaves are the physical
page pools shared by every slot, this step's token block is scattered into
each slot's pages, and ``kernels.paged_attention`` walks the page table.
Under ``kv_codec="cluster"`` the pools hold int8 codebook codes with f32
scale pools beside them, decoded inside the kernel.  The gathered
backend's lane paths wait for a later slice.
"""

from __future__ import annotations

import dataclasses

import torch

from repro_torch.kernels import kv_codec
from repro_torch.kernels.paged_attention import paged_mixed_attention
from repro_torch.models.layers import apply_rope, dense_init


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

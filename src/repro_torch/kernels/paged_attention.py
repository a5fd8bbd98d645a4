"""Ragged paged attention: CUDA kernel + plain PyTorch version.

Replaces the Pallas TPU kernel ``repro/kernels/paged_attention.py::
paged_mixed_attention`` (``_kernel``) for fp page pools.  The kernel is
``csrc/paged_attention.cu``: one warp per (slot, query token, head), lanes
splitting the head dim, an online softmax over the positions the token
may see, walked through the slot's page table.  What bounds it on the card
is the K/V bytes it reads; the source note says how this first version
stands against that.

Layout contract (shared with ``runtime.scheduler.SlotPool``), as in the
reference: slot ``s`` contributes ``q_lens[s]`` tokens at positions
``lengths[s] - q_lens[s] + i``; page 0 is the dummy sink and never read as
a valid position; ``page_size`` is the logical page length and physical
rows at or past it are padding; rows ``i >= q_lens[s]`` are padding (both
versions write zeros there, the reference wrote finite garbage).

Not ported yet (they raise): the int8 KV codec, the MLA second score
operand ``q2``/``k2_pages``, and ``pages_per_step > 1``.
"""

from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build

NEG_INF = -1e30
_POOL_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_MAX_HEAD_DIM = 256


def _check_unported(q2, k2_pages, k_scales, v_scales, k2_scales, codebook,
                    pages_per_step) -> None:
    if q2 is not None or k2_pages is not None:
        raise NotImplementedError("the MLA second score operand (q2, "
                                  "k2_pages) is not ported yet")
    if any(x is not None for x in (k_scales, v_scales, k2_scales, codebook)):
        raise NotImplementedError("the int8 KV codec is not ported yet")
    if pages_per_step != 1:
        raise NotImplementedError("pages_per_step > 1 is not ported yet")


def paged_mixed_attention_plain(q, k_pages, v_pages, table, lengths, q_lens,
                                *, window: int = 0, softcap_val: float = 0.0,
                                scale: float = 1.0,
                                page_size: int = 0) -> torch.Tensor:
    """Plain PyTorch version: gather each slot's pages into a contiguous
    view, score every (query, key) pair with the causal/window/ragged
    masks, softmax, and weight the values.  (S, Q, H, Dv) float32."""
    s_n, qn, h, d = q.shape
    _, page, kh, _ = k_pages.shape
    dv = v_pages.shape[-1]
    logical = page_size or page
    g = h // kh
    tab = table.long()
    span = tab.shape[1] * logical
    k = k_pages[:, :logical][tab].reshape(s_n, span, kh, -1).float()
    v = v_pages[:, :logical][tab].reshape(s_n, span, kh, dv).float()
    qf = q.float().reshape(s_n, qn, kh, g, d)
    sc = torch.einsum("sqkgd,spkd->skgqp", qf, k)
    if scale != 1.0:
        sc = sc * scale
    if softcap_val:
        sc = torch.tanh(sc / softcap_val) * softcap_val
    ql = q_lens.long()[:, None]
    qi = torch.arange(qn, device=q.device)[None]
    qpos = lengths.long()[:, None] - ql + qi                      # (S, Q)
    kpos = torch.arange(span, device=q.device)[None, None]
    valid = (kpos <= qpos[..., None]) & (qi < ql)[..., None]       # (S, Q, P)
    if window:
        valid &= kpos > qpos[..., None] - window
    sc = torch.where(valid[:, None, None], sc, NEG_INF)
    p = torch.softmax(sc, dim=-1)
    out = torch.einsum("skgqp,spkv->sqkgv", p, v).reshape(s_n, qn, h, dv)
    return torch.where((qi < ql)[..., None, None], out, 0.0)


def paged_mixed_attention(q, k_pages, v_pages, table, lengths, q_lens,
                          q2=None, k2_pages=None, k_scales=None,
                          v_scales=None, k2_scales=None, codebook=None, *,
                          window: int = 0, softcap_val: float = 0.0,
                          scale: float = 1.0, page_size: int = 0,
                          pages_per_step: int = 1) -> torch.Tensor:
    """out (S, Q, H, Dv) float32 — ragged mixed-step paged attention.

    ``q`` (S, Q, H, D) is pre-scaled (GQA callers fold ``D ** -0.5`` in);
    ``scale`` multiplies the summed scores.  CUDA tensors go through the
    kernel (or raise); CPU tensors take the plain version."""
    _check_unported(q2, k2_pages, k_scales, v_scales, k2_scales, codebook,
                    pages_per_step)
    s_n, qn, h, d = q.shape
    n_pages, page, kh, dk = k_pages.shape
    dv = v_pages.shape[-1]
    logical = page_size or page
    if not 0 < logical <= page:
        raise ValueError(f"page_size {page_size} outside (0, {page}]")
    if dk != d or h % kh:
        raise ValueError(f"q (H={h}, D={d}) does not fit pools "
                         f"(KH={kh}, D={dk})")
    if q.device.type == "cpu":
        return paged_mixed_attention_plain(
            q, k_pages, v_pages, table, lengths, q_lens, window=window,
            softcap_val=softcap_val, scale=scale, page_size=page_size)
    if not q.is_cuda:
        raise ValueError(f"unsupported device {q.device}")
    if k_pages.dtype not in _POOL_DTYPES or v_pages.dtype != k_pages.dtype:
        raise ValueError(f"pools must both be float32 or bfloat16, got "
                         f"{k_pages.dtype} / {v_pages.dtype}")
    if max(d, dv) > _MAX_HEAD_DIM:
        raise ValueError(f"head dims {d}/{dv} exceed {_MAX_HEAD_DIM}")
    q = q.float().contiguous()
    table = table.to(torch.int32).contiguous()
    lengths = lengths.to(torch.int32).contiguous()
    q_lens = q_lens.to(torch.int32).contiguous()
    for name, t in (("k_pages", k_pages), ("v_pages", v_pages),
                    ("table", table), ("lengths", lengths),
                    ("q_lens", q_lens)):
        if t.device != q.device or not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous on {q.device}")
    out = torch.empty((s_n, qn, h, dv), dtype=torch.float32, device=q.device)
    lib = _build.load("paged_attention")
    fn = lib.paged_attention_launch
    fn.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int] \
        + [ctypes.c_void_p] * 4 + [ctypes.c_int] * 10 \
        + [ctypes.c_float] * 2 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    code = fn(q.data_ptr(), k_pages.data_ptr(), v_pages.data_ptr(),
              _POOL_DTYPES[k_pages.dtype], table.data_ptr(),
              lengths.data_ptr(), q_lens.data_ptr(), out.data_ptr(),
              s_n, qn, h, kh, d, dv, page, logical, table.shape[1],
              int(window), float(softcap_val), float(scale),
              torch.cuda.current_stream(q.device).cuda_stream)
    _build.check(lib, "paged_attention", code)
    paged_mixed_attention.launches += 1
    return out


paged_mixed_attention.launches = 0   # kernel launches (not plain calls)

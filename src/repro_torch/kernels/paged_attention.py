"""Ragged paged attention: CUDA kernel + plain PyTorch version.

Replaces the Pallas TPU kernel ``repro/kernels/paged_attention.py::
paged_mixed_attention`` (``_kernel``, ``_dequant``) for fp page pools, for
the int8 KV-page codec (``kv_codec="cluster"``) and for the MLA second
score operand.  Two kernels, both with their products on tensor cores in
split TF32 and each 16-key tile staged, and decoded for codec pools, once
per block: ``csrc/paged_attention.cu`` for GQA (one block per (slot, KV
head, tile of query tokens), its 64, 32 or 16 rows the tokens x the G
query heads that read that KV head) and ``csrc/paged_mla_attention.cu``
for MLA (one block per (slot, query token, 64 or 32 heads)).  The source
notes say what bounds each on the card and how it stands against that.

Layout contract (shared with ``runtime.scheduler.SlotPool``), as in the
reference: slot ``s`` contributes ``q_lens[s]`` tokens at positions
``lengths[s] - q_lens[s] + i``; page 0 is the dummy sink and never read as
a valid position; ``page_size`` is the logical page length and physical
rows at or past it are padding; rows ``i >= q_lens[s]`` are padding (both
versions write zeros there, the reference wrote finite garbage).

Codec pools (``k_scales`` given): ``k_pages``/``v_pages`` (and
``k2_pages``) hold int8 codebook codes and ``k_scales``/``v_scales`` (and
``k2_scales``) (n_pages, rows) one f32 scale per (page, token), shared by
every KV head; each element decodes to ``codebook[code + 128] * scale``
before it is used.  The result equals the fp path on the pools decoded up
front into f32, bit for bit, on either device.

MLA (``q2``/``k2_pages`` given): scores are ``(q . k + q2 . k2) * scale``;
MLA's absorbed attention passes one latent KV head whose pool is both
``k_pages`` and ``v_pages`` (``models.attention.mla_apply``), and that is
all the MLA kernel takes (KH = 1, the same pool, and under the codec the
same scale pool, as key and value; D <= 512, D2 <= 64).

Not ported (it raises): ``pages_per_step > 1``, a TPU launch knob.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels import _build, kv_codec

NEG_INF = -1e30
# the kernel's pool codes: fp pools by dtype, codec pools by dequant mode
_POOL_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_DEQUANT = {"gather": 2, "onehot": 3}
# the GQA kernel's widths (D and Dv), and its query rows a block: the
# widest choice whose launch has a block for every SM of the card
_MAX_HEAD_DIM = 256
_GQA_ROWS = (64, 32, 16)
# the MLA kernel's widths: latent D (key and value) and rope D2
_MLA_MAX_D, _MLA_MAX_D2 = 512, 64


def _check_mla(q, k_pages, q2, k2_pages, k2_scales, codec: bool) -> bool:
    """True when the MLA second score operand is given; raise on a
    half-given or mistyped one."""
    if q2 is None and k2_pages is None:
        if k2_scales is not None:
            raise ValueError("k2_scales without q2 and k2_pages")
        return False
    if q2 is None or k2_pages is None:
        raise ValueError("the MLA second score operand needs both q2 and "
                         "k2_pages")
    if k2_pages.dtype != k_pages.dtype:
        raise ValueError(f"k2_pages ({k2_pages.dtype}) must have k_pages' "
                         f"dtype ({k_pages.dtype})")
    if (k2_scales is not None) != codec:
        raise ValueError("k2_scales comes with codec pools (k_scales, "
                         "v_scales, codebook) and only with them")
    s_n, qn, h, _ = q.shape
    if q2.shape[:3] != (s_n, qn, h) or \
            k2_pages.shape[:3] != k_pages.shape[:3] or \
            q2.shape[-1] != k2_pages.shape[-1]:
        raise ValueError(f"q2 {tuple(q2.shape)} / k2_pages "
                         f"{tuple(k2_pages.shape)} do not fit q "
                         f"{tuple(q.shape)} / k_pages "
                         f"{tuple(k_pages.shape)}")
    if codec and k2_scales.shape != k2_pages.shape[:2]:
        raise ValueError(f"k2_scales {tuple(k2_scales.shape)} must be "
                         f"(n_pages, rows) = {tuple(k2_pages.shape[:2])}")
    return True


def _check_codec(k_pages, v_pages, k_scales, v_scales, codebook,
                 dequant) -> bool:
    """True for codec pools; raise on a half-given or mistyped codec."""
    given = [x is not None for x in (k_scales, v_scales, codebook)]
    if not any(given):
        return False
    if not all(given):
        raise ValueError("the codec needs k_scales, v_scales and codebook")
    if k_pages.dtype != torch.int8 or v_pages.dtype != torch.int8:
        raise ValueError(f"codec pools must be int8 codes, got "
                         f"{k_pages.dtype} / {v_pages.dtype}")
    rows = k_pages.shape[:2]
    if k_scales.shape != rows or v_scales.shape != v_pages.shape[:2]:
        raise ValueError(f"scale pools {tuple(k_scales.shape)} / "
                         f"{tuple(v_scales.shape)} must be (n_pages, rows) "
                         f"= {tuple(rows)}")
    if codebook.shape != (kv_codec.LEVELS,):
        raise ValueError(f"codebook must be ({kv_codec.LEVELS},), got "
                         f"{tuple(codebook.shape)}")
    if dequant not in _DEQUANT:
        raise ValueError(f"dequant {dequant!r} not in {tuple(_DEQUANT)}")
    return True


def decode_pool(pages: torch.Tensor, scales: torch.Tensor,
                codebook: torch.Tensor) -> torch.Tensor:
    """An int8 code pool (n_pages, rows, KH, D) decoded up front into f32
    with its (n_pages, rows) scales, as ``kv_codec.decode`` does: the fp
    pool the codec stands for."""
    return codebook[pages.long() + kv_codec.ZERO_CODE] \
        * scales[..., None, None]


def paged_mixed_attention_plain(q, k_pages, v_pages, table, lengths, q_lens,
                                k_scales=None, v_scales=None, codebook=None,
                                *, q2=None, k2_pages=None, k2_scales=None,
                                window: int = 0, softcap_val: float = 0.0,
                                scale: float = 1.0,
                                page_size: int = 0) -> torch.Tensor:
    """Plain PyTorch version: decode codec pools up front (when
    ``k_scales`` is given), gather each slot's pages into a contiguous
    view, score every (query, key) pair (``q . k``, plus ``q2 . k2`` for
    MLA) with the causal/window/ragged masks, softmax, and weight the
    values.  (S, Q, H, Dv) float32."""
    if k_scales is not None:
        k_pages = decode_pool(k_pages, k_scales, codebook)
        v_pages = decode_pool(v_pages, v_scales, codebook)
        if k2_pages is not None:
            k2_pages = decode_pool(k2_pages, k2_scales, codebook)
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
    if q2 is not None:
        k2 = k2_pages[:, :logical][tab].reshape(s_n, span, kh, -1).float()
        q2f = q2.float().reshape(s_n, qn, kh, g, -1)
        sc = sc + torch.einsum("sqkgd,spkd->skgqp", q2f, k2)
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
                          pages_per_step: int = 1,
                          dequant: str = "gather") -> torch.Tensor:
    """out (S, Q, H, Dv) float32 — ragged mixed-step paged attention.

    ``q`` (S, Q, H, D) is pre-scaled (GQA callers fold ``D ** -0.5`` in);
    ``scale`` multiplies the summed scores.  ``q2`` (S, Q, H, D2) and
    ``k2_pages`` (n_pages, rows, KH, D2), both or neither, add MLA's
    second score operand ``q2 . k2``.  With ``k_scales`` the pools are
    int8 codec codes decoded against ``codebook`` (``dequant``:
    ``"gather"`` or ``"onehot"``, the same bits), ``k2_pages`` with its
    own ``k2_scales``.  CUDA tensors go through a kernel (or raise): the
    MLA kernel when ``q2`` is given, else the GQA one; CPU tensors take the
    plain version."""
    if pages_per_step != 1:
        raise NotImplementedError("pages_per_step > 1 is not ported yet")
    codec = _check_codec(k_pages, v_pages, k_scales, v_scales, codebook,
                         dequant)
    mla = _check_mla(q, k_pages, q2, k2_pages, k2_scales, codec)
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
            q, k_pages, v_pages, table, lengths, q_lens, k_scales, v_scales,
            codebook, q2=q2, k2_pages=k2_pages, k2_scales=k2_scales,
            window=window, softcap_val=softcap_val, scale=scale,
            page_size=page_size)
    if not q.is_cuda:
        raise ValueError(f"unsupported device {q.device}")
    if codec:
        pools = _DEQUANT[dequant]
    elif k_pages.dtype in _POOL_DTYPES and v_pages.dtype == k_pages.dtype:
        pools = _POOL_DTYPES[k_pages.dtype]
    else:
        raise ValueError(f"pools must both be float32 or bfloat16 (or int8 "
                         f"codes with scales), got {k_pages.dtype} / "
                         f"{v_pages.dtype}")
    q = q.float().contiguous()
    if mla:
        q2 = q2.float().contiguous()
    table = table.to(torch.int32).contiguous()
    lengths = lengths.to(torch.int32).contiguous()
    q_lens = q_lens.to(torch.int32).contiguous()
    named = [("k_pages", k_pages), ("v_pages", v_pages), ("table", table),
             ("lengths", lengths), ("q_lens", q_lens)]
    if mla:
        named += [("q2", q2), ("k2_pages", k2_pages)]
    if codec:
        f32s = [k_scales, v_scales, codebook] + ([k2_scales] if mla else [])
        named += [("scales and codebook", t) for t in f32s]
        if any(t.dtype != torch.float32 for t in f32s):
            raise ValueError("scales and codebook must be float32")
    for name, t in named:
        if t.device != q.device or not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous on {q.device}")
    out = torch.empty((s_n, qn, h, dv), dtype=torch.float32, device=q.device)
    stream = torch.cuda.current_stream(q.device).cuda_stream
    if mla:
        _launch_mla(q, q2, k_pages, v_pages, k2_pages, k_scales, v_scales,
                    k2_scales, codebook, pools, table, lengths, q_lens, out,
                    page, logical, window, softcap_val, scale, stream)
        paged_mixed_attention.mla_launches += 1
    else:
        if max(d, dv) > _MAX_HEAD_DIM:
            raise ValueError(f"head dims {d}/{dv} exceed {_MAX_HEAD_DIM}")
        lib = _build.load("paged_attention")
        fn = lib.paged_attention_launch
        if fn.argtypes is None:        # once: a decode step's launch is short
            fn.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int] \
                + [ctypes.c_void_p] * 7 + [ctypes.c_int] * 11 \
                + [ctypes.c_float] * 2 + [ctypes.c_void_p]
            fn.restype = ctypes.c_int
        ptr = (lambda t: t.data_ptr()) if codec else (lambda t: None)
        code = fn(q.data_ptr(), k_pages.data_ptr(), v_pages.data_ptr(),
                  pools, ptr(k_scales), ptr(v_scales), ptr(codebook),
                  table.data_ptr(), lengths.data_ptr(), q_lens.data_ptr(),
                  out.data_ptr(), s_n, qn, h, kh, d, dv,
                  _gqa_rows(s_n, qn, h, kh, q.device.index), page, logical,
                  table.shape[1], int(window), float(softcap_val),
                  float(scale), stream)
        _build.check(lib, "paged_attention", code)
    paged_mixed_attention.launches += 1
    return out


def paged_decode_attention(q, k_pages, v_pages, table, lengths, q2=None,
                           k2_pages=None, k_scales=None, v_scales=None,
                           k2_scales=None, codebook=None, *,
                           window: int = 0, softcap_val: float = 0.0,
                           scale: float = 1.0, page_size: int = 0,
                           pages_per_step: int = 1,
                           dequant: str = "gather") -> torch.Tensor:
    """out (S, H, Dv) float32 — single-token decode, the ``Q == 1`` case
    of :func:`paged_mixed_attention`: ``q`` (S, H, D) (and ``q2``
    (S, H, D2)) one query a slot, at position ``lengths[s] - 1``.  It
    launches the same kernels (GQA, or MLA with ``q2``) with
    ``q_lens = 1``; CPU tensors take their plain version."""
    out = paged_mixed_attention(
        q[:, None], k_pages, v_pages, table, lengths,
        torch.ones((q.shape[0],), dtype=torch.int32, device=q.device),
        None if q2 is None else q2[:, None], k2_pages, k_scales, v_scales,
        k2_scales, codebook, window=window, softcap_val=softcap_val,
        scale=scale, page_size=page_size, pages_per_step=pages_per_step,
        dequant=dequant)
    return out[:, 0]


@functools.lru_cache(maxsize=None)
def sm_count(device: int | None = None) -> int:
    """Streaming multiprocessors of card ``device`` (the current one when
    None)."""
    if device is None:
        device = torch.cuda.current_device()
    return torch.cuda.get_device_properties(device).multi_processor_count


def _gqa_rows(n_slots: int, qn: int, h: int, kh: int,
              device: int | None = None) -> int:
    """The GQA kernel's query rows a block (tokens x the query heads of one
    KV head): 64 when a launch of ``n_slots`` x ``qn`` tokens then has a
    block for every SM of card ``device``, else 32 under the same rule,
    else 16 (a decode step's few tokens spread over more blocks)."""
    g, sms = h // kh, sm_count(device)
    for rows in _GQA_ROWS[:-1]:
        hb = min(g, rows)
        blocks = n_slots * kh * -(-qn // (rows // hb)) * -(-g // hb)
        if blocks >= sms:
            return rows
    return _GQA_ROWS[-1]


def _same_tensor(a, b) -> bool:
    """``a`` and ``b`` view the same elements (``mla_apply`` passes the
    latent pool twice, as two views of one tensor)."""
    return a.data_ptr() == b.data_ptr() and a.dtype == b.dtype and \
        a.shape == b.shape and a.stride() == b.stride()


def _launch_mla(q, q2, k_pages, v_pages, k2_pages, k_scales, v_scales,
                k2_scales, codebook, pools, table, lengths, q_lens, out,
                page, logical, window, softcap_val, scale, stream) -> None:
    """Raise on what ``csrc/paged_mla_attention.cu`` does not take, else
    launch it on ``stream`` into ``out``."""
    s_n, qn, h, d = q.shape
    kh, d2 = k_pages.shape[2], q2.shape[-1]
    if kh != 1:
        raise ValueError(f"the MLA kernel takes one latent KV head (KH = 1), "
                         f"got KH={kh}")
    if not _same_tensor(v_pages, k_pages):
        raise ValueError("the MLA kernel takes the latent pool as key and "
                         "value: v_pages must be k_pages")
    if k_scales is not None and not _same_tensor(v_scales, k_scales):
        raise ValueError("the MLA kernel takes one latent scale pool: "
                         "v_scales must be k_scales")
    if d > _MLA_MAX_D:
        raise ValueError(f"MLA latent dim {d} exceeds {_MLA_MAX_D}")
    if d2 > _MLA_MAX_D2:
        raise ValueError(f"q2 head dim {d2} exceeds {_MLA_MAX_D2}")
    for name, width in (("latent", d), ("rope", d2)):
        if width * k_pages.element_size() % 4:
            raise ValueError(f"MLA {name} pool rows of {width} "
                             f"{k_pages.dtype} values are not a multiple "
                             f"of 4 bytes")
    lib = _build.load("paged_mla_attention")
    fn = lib.paged_mla_attention_launch
    fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] \
        + [ctypes.c_void_p] * 7 + [ctypes.c_int] * 9 \
        + [ctypes.c_float] * 2 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    codec = k_scales is not None
    ptr = (lambda t: t.data_ptr()) if codec else (lambda t: None)
    code = fn(q.data_ptr(), q2.data_ptr(), k_pages.data_ptr(),
              k2_pages.data_ptr(), pools, ptr(k_scales), ptr(k2_scales),
              ptr(codebook), table.data_ptr(), lengths.data_ptr(),
              q_lens.data_ptr(), out.data_ptr(), s_n, qn, h, d, d2, page,
              logical, table.shape[1], int(window), float(softcap_val),
              float(scale), stream)
    _build.check(lib, "paged_mla_attention", code)


def mla_kernel_info(pools: str, n_slots: int, qn: int, h: int, d: int,
                    d2: int) -> dict:
    """The MLA kernel's query rows a block, registers and local (spill)
    bytes a thread, and dynamic shared memory a block, for a launch of
    ``n_slots`` x ``qn`` tokens of ``h`` heads over ``pools`` ("float32",
    "bfloat16", "gather" or "onehot") at latent width ``d`` and rope width
    ``d2``."""
    code = {"float32": 0, "bfloat16": 1, **_DEQUANT}[pools]
    lib = _build.load("paged_mla_attention")
    fn = lib.paged_mla_attention_info
    fn.argtypes = [ctypes.c_int] * 6 + [ctypes.c_void_p] * 4
    fn.restype = ctypes.c_int
    vals = [ctypes.c_int(0) for _ in range(4)]
    _build.check(lib, "paged_mla_attention",
                 fn(code, n_slots, qn, h, d, d2,
                    *(ctypes.byref(v) for v in vals)))
    return dict(zip(("rows", "registers", "local_bytes", "smem_bytes"),
                    (v.value for v in vals)))


def gqa_kernel_info(pools: str, n_slots: int, qn: int, h: int, kh: int,
                    d: int, dv: int) -> dict:
    """The GQA kernel's query rows a block, registers and local (spill)
    bytes a thread, and dynamic shared memory a block, for a launch of
    ``n_slots`` x ``qn`` tokens of ``h`` query heads over ``kh`` KV heads
    and ``pools`` ("float32", "bfloat16", "gather" or "onehot") of widths
    ``d`` (key) and ``dv`` (value), on the current card."""
    code = {"float32": 0, "bfloat16": 1, **_DEQUANT}[pools]
    rows = _gqa_rows(n_slots, qn, h, kh)
    lib = _build.load("paged_attention")
    fn = lib.paged_attention_info
    fn.argtypes = [ctypes.c_int] * 4 + [ctypes.c_void_p] * 3
    fn.restype = ctypes.c_int
    vals = [ctypes.c_int(0) for _ in range(3)]
    _build.check(lib, "paged_attention",
                 fn(code, rows, d, dv, *(ctypes.byref(v) for v in vals)))
    return dict(rows=rows, **dict(zip(
        ("registers", "local_bytes", "smem_bytes"), (v.value for v in vals))))


# kernel launches (not plain calls): all of them, and those with the MLA
# second score operand
paged_mixed_attention.launches = 0
paged_mixed_attention.mla_launches = 0

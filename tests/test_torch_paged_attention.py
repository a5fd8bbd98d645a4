"""Ragged paged attention: the port's plain version against the JAX
oracles ``attention.decode_attention`` / ``chunk_attention`` over the
gathered pages (f32, atol 1e-5, rtol 1e-4 — both compute in f32 and
differ only in summation order).  The CUDA kernel is held to this plain
version on the card by ``tests/test_torch_cuda.py``.

Covers ragged ``q_lens`` including 0, windows, softcaps, a logical
``page_size`` smaller than the physical page rows (padding rows hold
garbage), and the page-0 dummy sink poisoned with huge values.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models.attention import chunk_attention, decode_attention
from repro_torch.kernels import kv_codec
from repro_torch.kernels.paged_attention import (paged_mixed_attention,
                                                 paged_mixed_attention_plain)

ATOL, RTOL = 1e-5, 1e-4


def paged_case(seed, *, qn, q_lens, lengths, h=4, kh=2, d=16, rows=4,
               logical=4, pps=6):
    """Random pools with page 0 as the sink: each slot owns the pages its
    ``lengths`` reach (shuffled ids); later table entries point at 0."""
    rng = np.random.default_rng(seed)
    s_n = len(q_lens)
    n_pages = s_n * pps + 1
    k = rng.standard_normal((n_pages, rows, kh, d)).astype(np.float32)
    v = rng.standard_normal((n_pages, rows, kh, d)).astype(np.float32)
    ids = iter(rng.permutation(np.arange(1, n_pages)))
    table = np.zeros((s_n, pps), np.int32)
    for s, ln in enumerate(lengths):
        for j in range(-(-ln // logical)):
            table[s, j] = next(ids)
    q = rng.standard_normal((s_n, qn, h, d)).astype(np.float32)
    return dict(q=q, k=k, v=v, table=table,
                lengths=np.asarray(lengths, np.int32),
                q_lens=np.asarray(q_lens, np.int32), logical=logical)


def port(c, **kw):
    d = c["q"].shape[-1]
    return paged_mixed_attention(
        torch.from_numpy(c["q"]) * d ** -0.5, torch.from_numpy(c["k"]),
        torch.from_numpy(c["v"]), torch.from_numpy(c["table"]),
        torch.from_numpy(c["lengths"]), torch.from_numpy(c["q_lens"]),
        page_size=c["logical"], **kw).numpy()


def gathered(c, s):
    """Slot s's logical rows as one contiguous (L, KH, D) view."""
    lg = c["logical"]
    kk = c["k"][c["table"][s], :lg].reshape(-1, *c["k"].shape[2:])
    vv = c["v"][c["table"][s], :lg].reshape(-1, *c["v"].shape[2:])
    return kk, vv


def chunk_oracle(c, s, window, cap):
    """The reference's chunk attention for slot s: the chunk's own keys
    follow the resident ones, exactly as ``attn_apply`` calls it."""
    kk, vv = gathered(c, s)
    qn = c["q"].shape[1]
    ql, ln = int(c["q_lens"][s]), int(c["lengths"][s])
    first = ln - ql
    pos = np.arange(kk.shape[0])
    chunk_idx = np.minimum(first + np.arange(qn), kk.shape[0] - 1)
    out = chunk_attention(
        jnp.asarray(c["q"][s:s + 1]), jnp.asarray(kk[chunk_idx][None]),
        jnp.asarray(vv[chunk_idx][None]), jnp.asarray(kk[None]),
        jnp.asarray(vv[None]), jnp.asarray(first + np.arange(qn)),
        jnp.asarray(np.where(pos < first, pos, -1)), window=window,
        attn_softcap=cap, q_lens=jnp.asarray([ql]))
    return np.asarray(out[0])


@pytest.mark.parametrize("window,cap", [(0, 0.0), (5, 0.0), (0, 2.0),
                                        (6, 3.0)])
@pytest.mark.parametrize("rows,logical", [(4, 4), (8, 5)])
def test_chunk_rows_vs_chunk_attention(window, cap, rows, logical):
    """Chunk rows, a decode row and an empty slot in one ragged block."""
    c = paged_case(1, qn=5, q_lens=[5, 1, 0, 3], lengths=[19, 9, 0, 3],
                   rows=rows, logical=logical)
    out = port(c, window=window, softcap_val=cap)
    for s, ql in enumerate(c["q_lens"]):
        if ql:
            np.testing.assert_allclose(
                out[s, :ql], chunk_oracle(c, s, window, cap)[:ql],
                atol=ATOL, rtol=RTOL)
        assert (out[s, ql:] == 0).all()            # padded rows: zeros


@pytest.mark.parametrize("window,cap", [(0, 0.0), (4, 0.0), (0, 5.0)])
def test_decode_rows_vs_decode_attention(window, cap):
    c = paged_case(2, qn=1, q_lens=[1, 1, 1], lengths=[23, 1, 11])
    out = port(c, window=window, softcap_val=cap)
    views = [gathered(c, s) for s in range(3)]
    want = decode_attention(
        jnp.asarray(c["q"]), jnp.asarray(np.stack([k for k, _ in views])),
        jnp.asarray(np.stack([v for _, v in views])),
        jnp.asarray(c["lengths"] - 1), window=window, attn_softcap=cap)
    np.testing.assert_allclose(out, np.asarray(want), atol=ATOL, rtol=RTOL)


def test_poisoned_dummy_sink_and_padding_rows_are_inert():
    c = paged_case(3, qn=4, q_lens=[4, 1, 0], lengths=[9, 14, 0], rows=8,
                   logical=6)
    clean = port(c)
    c["k"][0], c["v"][0] = 1e6, -1e6               # the dummy sink
    c["k"][:, 6:], c["v"][:, 6:] = 1e6, -1e6       # layout padding rows
    poisoned = port(c)
    assert np.isfinite(poisoned).all()
    np.testing.assert_array_equal(clean, poisoned)


def test_unported_options_raise():
    c = paged_case(4, qn=1, q_lens=[1], lengths=[3])
    # the int8 codec runs (tests/test_torch_kv_codec.py holds it to the
    # reference)
    zero_codes = np.zeros(c["k"].shape, np.int8)
    scales = torch.zeros(c["k"].shape[:2])
    out = port({**c, "k": zero_codes, "v": zero_codes}, k_scales=scales,
               v_scales=scales, codebook=kv_codec.codebook())
    assert out.shape == c["q"].shape and not out.any()
    # the MLA second operand runs (tests/test_torch_mla.py holds it to the
    # reference): a zero one adds exactly 0.0 to every score
    q2 = torch.zeros((*c["q"].shape[:3], 8))
    k2 = torch.zeros((*c["k"].shape[:3], 8))
    assert port(c, q2=q2, k2_pages=k2).tobytes() == port(c).tobytes()
    # a half-given one is refused
    with pytest.raises(ValueError, match="k2_scales without"):
        port(c, k2_scales=scales)
    with pytest.raises(ValueError, match="q2 and k2_pages"):
        port(c, q2=q2)
    with pytest.raises(ValueError, match="q2 and k2_pages"):
        port(c, k2_pages=k2)
    with pytest.raises(ValueError, match="k2_scales comes with codec"):
        port(c, q2=q2, k2_pages=k2, k2_scales=scales)
    with pytest.raises(ValueError, match="dtype"):
        port(c, q2=q2, k2_pages=k2.to(torch.bfloat16))
    # pages_per_step > 1 is a TPU launch knob the port does not take
    with pytest.raises(NotImplementedError, match="pages_per_step"):
        port(c, pages_per_step=2)

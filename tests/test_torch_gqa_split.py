"""The split-TF32 arithmetic of the GQA paged-attention kernel, on the CPU.

``csrc/paged_attention.cu`` runs both products of GQA attention (the score
``q . k^T`` and ``p . v``) on tensor cores in TF32 (10 mantissa bits) with
f32 accumulation.  The rows of one of its blocks are query tokens x the G
query heads of one KV head; they walk the slot's keys in tiles of 16
positions, from the window start of the block's first token to the
position of its last, with an online softmax in f32 and a causal / window
mask per (row, key).  A single TF32 rounding of q or of p is outside the
card's tolerance at minitron-8b's widths, so the kernel splits q and p
into TF32 hi + lo (``cvt.rna``) and sums lo.b + hi.b for a bf16 pool value
b (exact in TF32), or lo.hi + hi.lo + hi.hi (3xTF32) for f32 pools and
decoded codec values.  This file emulates that arithmetic, in that tile
order, in plain torch and holds it to ``paged_mixed_attention_plain``
within the card tests' tolerances; the single roundings it replaces are
shown to miss.  No card is needed.
"""

import numpy as np
import pytest
import torch

from repro_torch.kernels import kv_codec
from repro_torch.kernels.paged_attention import (decode_pool,
                                                 paged_mixed_attention_plain)

KEYS = 16                           # key positions a tile
FP_TOL = dict(atol=2e-5, rtol=1e-4)     # tests/test_torch_cuda.py, fp pools
CODEC_TOL = dict(atol=1e-4, rtol=1e-4)  # the same file, codec pools
ATTN_TOL = 1e-4                     # chip_smoke.py's tolerance


def tf32(x: torch.Tensor) -> torch.Tensor:
    """``cvt.rna.tf32.f32``: f32 rounded to 10 mantissa bits, to nearest,
    ties away from zero (the low 13 bits cleared)."""
    bits = x.float().contiguous().view(torch.int32)
    return ((bits + 0x1000) & -0x2000).view(torch.float32)


def split(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    hi = tf32(x)
    return hi, tf32(x - hi)


def split_matmul(a: torch.Tensor, b: torch.Tensor,
                 split_b: bool) -> torch.Tensor:
    """a @ b as the kernel's MMAs compute it: a split hi + lo, b split too
    (3xTF32, small terms first) or taken as it is (exact in TF32)."""
    ah, al = split(a)
    if not split_b:
        return al @ b + ah @ b
    bh, bl = split(b)
    return al @ bh + ah @ bl + ah @ bh


# (H, KH, D, logical page, physical rows, lengths, q_lens): minitron-8b's
# widths (64 causal queries over 272 keys, a decode, an empty slot, a short
# chunk), then G = 1, 2 and 6 at D = 40 and 256 over pages whose logical
# size is below their physical rows
MINITRON = (32, 8, 128, 16, 16, [272, 130, 0, 200], [64, 37, 0, 1])
SHAPES = {
    "minitron": MINITRON,
    "g1_d40": (4, 4, 40, 6, 8, [45, 13, 0, 2], [20, 1, 0, 2]),
    "g2_d256": (4, 2, 256, 6, 8, [45, 13, 0, 2], [20, 1, 0, 2]),
    "g6_d40": (12, 2, 40, 6, 8, [45, 13, 0, 2], [20, 1, 0, 2]),
    "g6_d256": (6, 1, 256, 16, 16, [70, 33], [17, 5]),
}


def _inputs(shape: str, pools: str, seed: int = 17):
    """A ragged block over paged pools -> (q, pools for the plain version,
    f32 pools the kernel's products see, table, lengths, q_lens, logical).
    Table entries past a slot's pages hit the page-0 sink."""
    h, kh, d, logical, rows, lengths, q_lens = SHAPES[shape]
    rng = np.random.default_rng(seed)
    s_n = len(lengths)
    pps = -(-max(lengths) // logical)
    n_pages = s_n * pps + 1
    ids = iter(rng.permutation(np.arange(1, n_pages)))
    table = np.zeros((s_n, pps), np.int32)
    for s, ln in enumerate(lengths):
        for j in range(-(-ln // logical)):
            table[s, j] = next(ids)
    t = lambda a: torch.from_numpy(a)
    q = t(rng.standard_normal((s_n, max(q_lens), h, d)).astype(np.float32)
          * d ** -0.5)
    k = t(rng.standard_normal((n_pages, rows, kh, d)).astype(np.float32))
    v = t(rng.standard_normal((n_pages, rows, kh, d)).astype(np.float32))
    if pools == "bfloat16":
        k, v = k.to(torch.bfloat16), v.to(torch.bfloat16)
    plain = dict(k_pages=k, v_pages=v)
    if pools == "codec":
        (kc, ks), (vc, vs) = (kv_codec.encode(x.to(torch.bfloat16), (-2, -1))
                              for x in (k, v))
        cb = kv_codec.codebook("cpu")
        plain = dict(k_pages=kc, v_pages=vc, k_scales=ks, v_scales=vs,
                     codebook=cb)
        k, v = decode_pool(kc, ks, cb), decode_pool(vc, vs, cb)
    i32 = lambda x: torch.tensor(x, dtype=torch.int32)
    return (q, plain, (k.float(), v.float()), t(table), i32(lengths),
            i32(q_lens), logical)


def _emulate(q, pools, table, lengths, q_lens, logical, split_key: bool, *,
             window=0, cap=0.0, round_q=None, round_p=None):
    """The kernel's arithmetic: for each (slot, KV head), its rows (tokens
    x G heads) walk 16-key tiles from the window start of the first token
    to the position of the last; split-TF32 score, scale, softcap and a
    per-(row, key) mask in f32, online softmax, split-TF32 ``p . v``.
    ``round_q`` / ``round_p`` replace the split of q / p by one rounding
    (the alternatives the split stands against)."""
    k, v = pools
    s_n, qn, h, d = q.shape
    kh, dv = k.shape[2], v.shape[-1]
    g = h // kh
    out = torch.zeros((s_n, qn, h, dv))
    for s, (ln, ql) in enumerate(zip(lengths.tolist(), q_lens.tolist())):
        if not ql:
            continue
        tab = table[s].long()
        span = tab.shape[0] * logical
        kg = k[:, :logical][tab].reshape(span, kh, d)
        vg = v[:, :logical][tab].reshape(span, kh, dv)
        qpos = (ln - ql + torch.arange(ql)).repeat_interleave(g)  # (rows,)
        lo = (qpos - window + 1).clamp(min=0) if window else \
            torch.zeros_like(qpos)
        t0, t1 = int(lo.min()) // KEYS, int(qpos.max()) // KEYS
        for kvh in range(kh):
            rows = q[s, :ql, kvh * g:(kvh + 1) * g].reshape(-1, d)
            m = torch.full((rows.shape[0],), -torch.inf)
            l = torch.zeros(rows.shape[0])
            o = torch.zeros((rows.shape[0], dv))
            for t in range(t0, t1 + 1):
                pos = torch.arange(t * KEYS, (t + 1) * KEYS)
                inside = pos < span
                kt = torch.zeros((KEYS, d))
                vt = torch.zeros((KEYS, dv))
                kt[inside] = kg[pos[inside], kvh]
                vt[inside] = vg[pos[inside], kvh]
                if round_q is None:
                    sc = split_matmul(rows, kt.T, split_key)
                else:
                    sc = round_q(rows) @ kt.T
                if cap:
                    sc = torch.tanh(sc / cap) * cap
                ok = (pos[None] >= lo[:, None]) & (pos[None] <= qpos[:, None])
                sc = torch.where(ok, sc, -torch.inf)
                m_new = torch.maximum(m, sc.max(-1).values)
                alpha = torch.where(m == -torch.inf, 0.0,
                                    torch.exp(m - m_new))
                p = torch.where(ok, torch.exp(sc - m_new[:, None]), 0.0)
                l = l * alpha + p.sum(-1)
                pv = split_matmul(p, vt, split_key) if round_p is None \
                    else round_p(p) @ vt
                o = o * alpha[:, None] + pv
                m = m_new
            out[s, :ql, kvh * g:(kvh + 1) * g] = \
                (o / l.clamp(min=1e-20)[:, None]).reshape(ql, g, dv)
    return out


def _reference(q, plain, table, lengths, q_lens, logical, **kw):
    kw = dict(plain, **kw)
    k, v = kw.pop("k_pages"), kw.pop("v_pages")
    return paged_mixed_attention_plain(q, k, v, table, lengths, q_lens,
                                       page_size=logical, **kw)


def _rows(q_lens, qn):
    return torch.arange(qn)[None] < q_lens[:, None]


@pytest.mark.parametrize("window,cap", [(0, 0.0), (9, 3.0)])
@pytest.mark.parametrize("shape", list(SHAPES))
@pytest.mark.parametrize("pools", ["bfloat16", "float32", "codec"])
def test_split_tf32_is_within_tolerance_of_plain(pools, shape, window, cap):
    """bf16 pools: q and p split, the pool value exact (two MMAs a
    product); f32 and decoded codec pools: 3xTF32.  A window of 9 starts
    inside a 16-key tile and ends several tiles before a long chunk's last
    token, so a block's rows see different key ranges."""
    q, plain, f32_pools, table, lengths, q_lens, logical = _inputs(shape,
                                                                   pools)
    want = _reference(q, plain, table, lengths, q_lens, logical,
                      window=window, softcap_val=cap)
    got = _emulate(q, f32_pools, table, lengths, q_lens, logical,
                   split_key=pools != "bfloat16", window=window, cap=cap)
    rows = _rows(q_lens, q.shape[1])
    tol = CODEC_TOL if pools == "codec" else FP_TOL
    torch.testing.assert_close(got[rows], want[rows], **tol)
    assert torch.equal(got[~rows], torch.zeros_like(got[~rows]))


@pytest.mark.parametrize("rounding", ["q_tf32", "p_tf32"])
def test_a_single_rounding_misses_the_tolerance(rounding):
    """At minitron-8b's widths, one TF32 rounding of q or of p in place of
    the split puts the output outside ATTN_TOL (the split is within
    1e-5 of the plain version): why the kernel splits both."""
    q, plain, f32_pools, table, lengths, q_lens, logical = _inputs(
        "minitron", "bfloat16")
    want = _reference(q, plain, table, lengths, q_lens, logical)
    rows = _rows(q_lens, q.shape[1])
    split_err = float((_emulate(q, f32_pools, table, lengths, q_lens, logical,
                                split_key=False) - want)[rows].abs().max())
    kw = {"q_tf32": dict(round_q=tf32), "p_tf32": dict(round_p=tf32)}
    got = _emulate(q, f32_pools, table, lengths, q_lens, logical,
                   split_key=False, **kw[rounding])
    err = float((got - want)[rows].abs().max())
    assert split_err < 1e-5 < ATTN_TOL < err


def test_tile_walk_with_narrow_windows():
    """Windows of 1 (a row sees its own key only) and 9 make the rows of
    one block see different key ranges, some starting tiles after the
    block's first tile: the walk from the first token's window start to
    the last token's position still gives every row its keys (finite,
    within tolerance of the plain version)."""
    q, plain, f32_pools, table, lengths, q_lens, logical = _inputs(
        "g6_d40", "float32")
    for window in (0, 1, 9):
        want = _reference(q, plain, table, lengths, q_lens, logical,
                          window=window)
        got = _emulate(q, f32_pools, table, lengths, q_lens, logical,
                       split_key=True, window=window)
        rows = _rows(q_lens, q.shape[1])
        assert torch.isfinite(got).all()
        torch.testing.assert_close(got[rows], want[rows], **FP_TOL)

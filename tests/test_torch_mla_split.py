"""The split-TF32 arithmetic of the MLA paged-attention kernel, on the CPU.

``csrc/paged_mla_attention.cu`` runs both products of MLA's absorbed
attention (the score ``[q || q2] . [c || pe]^T`` and ``p . c``) on tensor
cores in TF32 (10 mantissa bits) with f32 accumulation.  A single TF32
rounding of q is far outside the card's tolerance (``chip_smoke.py``'s
ATTN_TOL, 1e-4) at deepseek-v2's widths, so the kernel splits every f32
operand into TF32 hi + lo (``cvt.rna``: round to nearest, ties away) and
sums hi.hi + hi.lo + lo.hi (3xTF32), or hi.b + lo.b where b is a bf16 pool
value (exact in TF32).  This file emulates that arithmetic in plain torch
at the MLA phase's widths (128 heads, D 512, D2 64, a few hundred keys)
and holds it to ``paged_mixed_attention_plain``; the single roundings it
replaces are shown to miss, which is why the split is there.  No card is
needed.
"""

import numpy as np
import pytest
import torch

from repro_torch.kernels import kv_codec
from repro_torch.kernels.paged_attention import (decode_pool,
                                                 paged_mixed_attention_plain)

HEADS, LATENT, ROPE, PAGE = 128, 512, 64, 16
SCALE = (128 + 64) ** -0.5          # deepseek-v2: (nope + rope) ** -0.5
TOL = 1e-4                          # chip_smoke.py's ATTN_TOL
LENGTHS, Q_LENS = [272, 100], [3, 2]    # ragged: a few hundred keys


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


def _inputs(pools: str):
    """Two slots of deepseek-v2's MLA call (q scaled as in
    ``chip_smoke.py::_mla_inputs``) over paged latent and rope pools ->
    (q, q2, pools for the plain version, f32 pools the kernel sees,
    table, lengths, q_lens)."""
    rng = np.random.default_rng(16)
    pps = -(-max(LENGTHS) // PAGE)
    n_pages = len(LENGTHS) * pps + 1
    table = torch.from_numpy(rng.permutation(np.arange(1, n_pages)).reshape(
        len(LENGTHS), pps).astype(np.int32))
    qn = max(Q_LENS)
    q = torch.from_numpy(rng.standard_normal(
        (len(LENGTHS), qn, HEADS, LATENT)).astype(np.float32))
    q2 = torch.from_numpy(rng.standard_normal(
        (len(LENGTHS), qn, HEADS, ROPE)).astype(np.float32))
    c = torch.from_numpy(rng.standard_normal(
        (n_pages, PAGE, 1, LATENT)).astype(np.float32))
    pe = torch.from_numpy(rng.standard_normal(
        (n_pages, PAGE, 1, ROPE)).astype(np.float32))
    if pools != "float32":
        c, pe = c.to(torch.bfloat16), pe.to(torch.bfloat16)
    plain = dict(k_pages=c, v_pages=c, k2_pages=pe)
    if pools == "codec":
        (cc, cs), (pc, ps) = (kv_codec.encode(x, (-2, -1)) for x in (c, pe))
        cb = kv_codec.codebook("cpu")
        plain = dict(k_pages=cc, v_pages=cc, k2_pages=pc, k_scales=cs,
                     v_scales=cs, k2_scales=ps, codebook=cb)
        c, pe = decode_pool(cc, cs, cb), decode_pool(pc, ps, cb)
    i32 = lambda x: torch.tensor(x, dtype=torch.int32)
    return q, q2, plain, (c.float(), pe.float()), table, i32(LENGTHS), \
        i32(Q_LENS)


def _reference(q, q2, plain, table, lengths, q_lens):
    kw = dict(plain)
    k, v = kw.pop("k_pages"), kw.pop("v_pages")
    return paged_mixed_attention_plain(q, k, v, table, lengths, q_lens, q2=q2,
                                       scale=SCALE, page_size=PAGE, **kw)


def _emulate(q, q2, pools, table, lengths, q_lens, split_key: bool,
             round_q=None, round_p=None):
    """The kernel's arithmetic on each slot's gathered keys: split-TF32
    score, f32 softmax, split-TF32 ``p . c``.  ``round_q`` / ``round_p``
    replace the split of q / p by one rounding (the alternatives the split
    stands against)."""
    c, pe = pools
    out = torch.zeros((*q.shape[:3], LATENT))
    for s, (ln, ql) in enumerate(zip(lengths.tolist(), q_lens.tolist())):
        cg = c[table[s].long()].reshape(-1, LATENT)[:ln]
        kg = torch.cat([cg, pe[table[s].long()].reshape(-1, ROPE)[:ln]], -1)
        for i in range(ql):
            pos = ln - ql + i
            qk = torch.cat([q[s, i], q2[s, i]], -1)           # (H, D + D2)
            if round_q is None:
                sc = split_matmul(qk, kg.T, split_key)
            else:
                sc = round_q(qk) @ (kg.T if not split_key
                                    else sum(split(kg.T)))
            sc = sc * SCALE
            sc[:, pos + 1:] = -torch.inf
            p = torch.exp(sc - sc.max(-1, keepdim=True).values)
            if round_p is None:
                o = split_matmul(p, cg, split_key)
            else:
                o = round_p(p) @ cg
            out[s, i] = o / p.sum(-1, keepdim=True)
    return out


def _err(got, want, q_lens):
    rows = torch.arange(got.shape[1])[None] < q_lens[:, None]
    return float((got - want).abs()[rows].max())


@pytest.mark.parametrize("pools", ["bfloat16", "float32", "codec"])
def test_split_tf32_is_within_tolerance_of_plain(pools):
    """bf16 pools: q and p split, the pool exact (two MMAs a product);
    f32 and decoded codec pools: 3xTF32."""
    q, q2, plain, f32_pools, table, lengths, q_lens = _inputs(pools)
    want = _reference(q, q2, plain, table, lengths, q_lens)
    got = _emulate(q, q2, f32_pools, table, lengths, q_lens,
                   split_key=pools != "bfloat16")
    assert _err(got, want, q_lens) <= TOL


@pytest.mark.parametrize("rounding", ["q_tf32", "q_bf16", "p_tf32"])
def test_a_single_rounding_misses_the_tolerance(rounding):
    """One rounding of q (to TF32 or bf16) or of p (to TF32) in place of
    the split puts the output outside ATTN_TOL: why the kernel splits."""
    q, q2, plain, f32_pools, table, lengths, q_lens = _inputs("bfloat16")
    want = _reference(q, q2, plain, table, lengths, q_lens)
    kw = {"q_tf32": dict(round_q=tf32),
          "q_bf16": dict(round_q=lambda x: x.to(torch.bfloat16).float()),
          "p_tf32": dict(round_p=tf32)}[rounding]
    got = _emulate(q, q2, f32_pools, table, lengths, q_lens, split_key=False,
                   **kw)
    assert _err(got, want, q_lens) > TOL


def test_tf32_rounding_is_cvt_rna():
    """Nearest with ties away from zero, at 10 mantissa bits; bf16 values
    (7 mantissa bits) are exact, so bf16 pools need no lo part."""
    ulp = 2.0 ** -10
    x = torch.tensor([1 + ulp / 2, -(1 + ulp / 2), 1 + ulp / 4,
                      1 + 3 * ulp / 4, 1 + ulp / 2 + 2 ** -23])
    want = torch.tensor([1 + ulp, -(1 + ulp), 1.0, 1 + ulp, 1 + ulp])
    assert torch.equal(tf32(x), want)
    b = torch.randn(4096, generator=torch.Generator().manual_seed(0)).to(
        torch.bfloat16).float()
    assert torch.equal(tf32(b), b)
    hi, lo = split(torch.randn(4096))
    assert torch.equal(tf32(hi), hi) and torch.equal(tf32(lo), lo)

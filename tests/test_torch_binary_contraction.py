"""The binary-contraction kernel's arithmetic and walk, on the CPU.

``csrc/binary_contraction.cu`` runs only on the card.  Its walk is
emulated here under the plan its library picks (``tests/
contraction_walk.py``: the weight slab staged once a block or once a
chunk of each M tile, the binary MMA's word -> k map, AND-popcounts, pa
and pb, the epilogue) and held to the port's and the JAX reference's
``popcount_dot``, bit for bit, on words drawn from a numpy seed, padded
bits included.  The card tests hold the library's plan to
``contraction_walk.plan`` and the kernel to the plain version.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ref as jref
from repro_torch.kernels import ref
from repro_torch.kernels.binary_contraction import binary_contraction
from repro_torch.models.reactnet import CONFIG as RN
import contraction_walk as walk


def _reactnet_pairs():
    """(KW, N, k_true) of every ReActNet-A contraction: each block's 3x3
    conv (packed patches, K = 9 Cin) and 1x1 conv (K = Cin)."""
    pairs, c = [], RN.width
    for mult, _ in RN.blocks:
        pairs.append((9 * -(-c // 32), c, 9 * c))
        pairs.append((9 * -(-c // 288), c * mult, c))
        c *= mult
    return sorted(set(pairs))


def _words(rng, rows, kw):
    """Random packed words: every bit, the padded ones included, random."""
    return rng.integers(0, 1 << 32, (rows, kw), dtype=np.uint64).astype(
        np.uint32)


def _check(m, n, kw, k_true, sms, seed):
    rng = np.random.default_rng(seed)
    xw, ww = _words(rng, m, kw), _words(rng, n, kw)
    p = walk.plan(m, n, kw, sms)
    got, staged = walk.emulate(xw, ww, k_true, p)
    xt, wt = torch.from_numpy(xw.view(np.int32)), \
        torch.from_numpy(ww.view(np.int32))
    want = ref.popcount_dot(xt, wt, k_true).numpy()
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(
        got, np.asarray(jref.popcount_dot(jnp.asarray(xw), jnp.asarray(ww),
                                          k_true)))
    n_mtiles = -(-m // p.bm)
    if p.chunked:                   # every chunk of every M tile
        assert staged == p.n_slabs * n_mtiles * p.steps
    else:                           # once a block that has an M tile
        assert staged == p.n_slabs * min(p.m_splits, n_mtiles) * p.steps
    return p


@pytest.mark.parametrize("sms", [walk.H100_SMS, 1])
@pytest.mark.parametrize("kw,n,k_true", _reactnet_pairs())
def test_walk_equals_popcount_at_reactnet_shapes(kw, n, k_true, sms):
    """Every ReActNet-A (KW, N) pair at M = 130; on one SM the blocks walk
    several M tiles.  No ReActNet shape chunks its slab."""
    p = _check(130, n, kw, k_true, sms, seed=kw * n + sms)
    assert not p.chunked


@pytest.mark.parametrize("sms", [walk.H100_SMS, 1])
@pytest.mark.parametrize("m", [1, 2, 513])
@pytest.mark.parametrize("n", [1, 33, 129])
def test_walk_ragged_m_and_n(m, n, sms):
    """KW 13 (not a multiple of 9 or 8): the second k step has 5 real
    words, and the bits past k_true = 400 are random."""
    _check(m, n, 13, 400, sms, seed=m * n + sms)


@pytest.mark.parametrize("k_true", [0, 1, 32 * 13])
def test_walk_k_true_edges(k_true):
    _check(37, 33, 13, k_true, walk.H100_SMS, seed=k_true)


@pytest.mark.parametrize("m,n,kw,k_true", [(2, 129, 5, 150), (513, 1, 1, 17),
                                           (65, 70, 63, 2000),
                                           (9, 31, 4, 100)])
def test_walk_short_k(m, n, kw, k_true):
    """One k step (KW <= 8) or a ragged last one; 16-byte copies at KW 4."""
    p = _check(m, n, kw, k_true, walk.H100_SMS, seed=m + kw)
    assert p.vec == (kw % 4 == 0)


@pytest.mark.parametrize("sms", [walk.H100_SMS, 1])
@pytest.mark.parametrize("m,n,kw,k_true", [(513, 129, 513, 16400),
                                           (300, 40, 800, 25000)])
def test_walk_k_chunked(m, n, kw, k_true, sms):
    """K 16,400 at 128 columns and K 25,000 at 64: the slab does not fit
    beside the ring, so each M tile stages it chunk by chunk."""
    p = _check(m, n, kw, k_true, sms, seed=kw + sms)
    assert p.chunked and p.slab_steps < p.steps
    assert p.smem_bytes <= walk.SMEM_MAX


def test_plan_at_reactnet_shapes():
    """ReActNet-A's 26 contractions at batch 32: the whole slab in shared
    memory, a block per SM where the M tiles allow, each slab read
    m_splits times."""
    side, c = -(-RN.image_size // 2), RN.width
    for mult, stride in RN.blocks:
        side = (side - 1) // stride + 1
        m = 32 * side * side
        for kw, n in ((9 * -(-c // 32), c), (9 * -(-c // 288), c * mult)):
            p = walk.plan(m, n, kw)
            assert not p.chunked and p.smem_bytes <= walk.SMEM_MAX
            n_mtiles = -(-m // p.bm)
            assert p.m_splits * p.n_slabs >= min(walk.H100_SMS,
                                                 n_mtiles * p.n_slabs)
            assert p.m_splits <= n_mtiles
        c *= mult


def test_wrapper_takes_the_plain_version_on_cpu():
    rng = np.random.default_rng(4)
    xw = torch.from_numpy(_words(rng, 5, 13).view(np.int32))
    ww = torch.from_numpy(_words(rng, 3, 13).view(np.int32))
    before = binary_contraction.launches
    assert torch.equal(binary_contraction(xw, ww, k_true=400),
                       ref.popcount_dot(xw, ww, 400))
    assert torch.equal(binary_contraction(xw[:, :0], ww[:, :0], k_true=0),
                       torch.zeros((5, 3), dtype=torch.int32))
    assert binary_contraction.launches == before
    with pytest.raises(ValueError, match="k_true"):
        binary_contraction(xw, ww, k_true=13 * 32 + 1)

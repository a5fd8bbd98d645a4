"""The binary-contraction kernel's launch plan and walk, in numpy.

``csrc/binary_contraction.cu`` runs only on the card.  :func:`plan`
repeats its library's ``make_plan`` (the card tests hold the two equal),
and :func:`emulate` repeats what the kernel's blocks do under a plan:
the (k step, column, 8) weight slab staged once a block (or once a chunk
of each M tile), pb counted from it, k steps of 8 words with both
operands zero past KW and the activations zero past M, the word -> k map
of the binary MMA, AND-popcounts, pa counted from each staged step, and
the epilogue.  numpy only, so the card's test file (which imports no
jax) can use it too.
"""

from __future__ import annotations

import numpy as np

from repro_torch.kernels.binary_contraction import ContractionPlan

STEP = 8                 # words of K a k256 step
STAGES = 4               # activation buffers in the ring
EPI_WORDS = 8 * 8 * 40   # each warp's 8 staged output rows of 40 words
MAX_BLOCKS_SM = 2        # by registers
SMEM_MAX = 232448        # dynamic shared memory a block may take
SMEM_SM = 233472         # shared memory of an SM, 1 KB a block reserved
H100_SMS = 132
# k block kb of an m16n8k256 step <- word WORD_OF[kb] of the step: lane
# t4 feeds words 2 t4 and 2 t4 + 1 as its k blocks t4 and 4 + t4
WORD_OF = np.array([0, 2, 4, 6, 1, 3, 5, 7])
UNWRITTEN = -(1 << 40)


def block_rows(bn: int) -> int:
    """Rows of an M tile: 8 warps of 64 x 32 output tiles over BN columns."""
    return 64 * (8 // (bn // 32))


def layout_words(bn: int, bm: int, slab_steps: int) -> int:
    """pb (bn,), pa (bm,), the ring (stages, bm, 8), the slab (slab_steps,
    bn, 8), the warps' output rows."""
    return bn + bm + STAGES * bm * STEP + slab_steps * bn * STEP + EPI_WORDS


def plan(m: int, n: int, kw: int, sms: int = H100_SMS) -> ContractionPlan:
    """The launch ``make_plan`` picks for (M, KW) x (N, KW) words."""
    bn = 32 if n <= 32 else 64 if n <= 64 else 128
    bm = block_rows(bn)
    n_slabs = -(-n // bn)
    steps = max(1, -(-kw // STEP))
    chunk = steps
    while chunk > 1 and layout_words(bn, bm, chunk) * 4 > SMEM_MAX:
        chunk -= 1
    smem = layout_words(bn, bm, chunk) * 4
    per_sm = max(1, min(MAX_BLOCKS_SM, SMEM_SM // (smem + 1024)))
    n_mtiles = max(1, -(-m // bm))
    want = min(-(-(per_sm * sms) // n_slabs), n_mtiles)
    per_split = -(-n_mtiles // want)
    return ContractionPlan(steps, bn, bm, n_slabs, -(-n_mtiles // per_split),
                           chunk, smem, kw % 4 == 0)


def _words(src: np.ndarray, r0: int, rows: int, w0: int,
           n_words: int) -> np.ndarray:
    """cp.async of words [w0, w0 + n_words) of rows [r0, r0 + rows): zero
    past the operand's rows and past its KW."""
    out = np.zeros((rows, n_words), np.uint32)
    r1 = min(r0 + rows, src.shape[0])
    w1 = min(w0 + n_words, src.shape[1])
    if r1 > r0 and w1 > w0:
        out[:r1 - r0, :w1 - w0] = src[r0:r1, w0:w1]
    return out


def _and_popc(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """One m16n8k256 .and.popc step over (rows, 8) x (cols, 8) words, each
    operand's words put in k order by the same map."""
    ka, kb = a[:, WORD_OF], b[:, WORD_OF]
    return np.bitwise_count(ka[:, None, :] & kb[None, :, :]).sum(
        -1, dtype=np.int64)


def emulate(x_words: np.ndarray, w_words: np.ndarray, k_true: int,
            p: ContractionPlan) -> tuple[np.ndarray, int]:
    """The kernel's blocks under plan ``p``, (M, KW) x (N, KW) uint32 ->
    ((M, N) int64 outputs, k steps of slab staged in all)."""
    m, kw = x_words.shape
    n = w_words.shape[0]
    n_mtiles = -(-m // p.bm)
    out = np.full((m, n), UNWRITTEN, np.int64)
    staged = 0
    for slab in range(p.n_slabs):
        n0 = slab * p.bn
        for split in range(p.m_splits):
            pb = np.zeros(p.bn, np.int64)
            for k, mt in enumerate(range(split, n_mtiles, p.m_splits)):
                acc = np.zeros((p.bm, p.bn), np.int64)
                pa = np.zeros(p.bm, np.int64)
                for s in range(p.steps):
                    kl = s % p.slab_steps
                    if kl == 0 and (p.chunked or (k == 0 and s == 0)):
                        count = min(p.slab_steps, p.steps - s)
                        ws = _words(w_words, n0, p.bn, s * STEP,
                                    count * STEP).reshape(p.bn, count, STEP)
                        ws = ws.transpose(1, 0, 2)      # (k step, BN, 8)
                        staged += count
                        if k == 0:
                            pb += np.bitwise_count(ws).sum(
                                (0, 2), dtype=np.int64)
                    a = _words(x_words, mt * p.bm, p.bm, s * STEP, STEP)
                    acc += _and_popc(a, ws[kl])
                    pa += np.bitwise_count(a).sum(1, dtype=np.int64)
                rows = mt * p.bm + np.arange(p.bm)
                cols = n0 + np.arange(p.bn)
                ok_r, ok_c = rows < m, cols < n
                blk = np.ix_(rows[ok_r], cols[ok_c])
                assert (out[blk] == UNWRITTEN).all(), "written twice"
                val = k_true - 2 * pa[:, None] - 2 * pb[None, :] + 4 * acc
                out[blk] = val[np.ix_(ok_r, ok_c)]
    assert (out != UNWRITTEN).all(), "an output never written"
    return out, staged

"""Rolling-window lanes beside the page pools under ``cuda_paged``, against
the JAX ``pallas_paged`` backend, on the CPU.

At a window shorter than the slot, a block's K/V leaves do not page: they
stay one rolling lane a slot, in the kernel layout (slot axis where the
batch axis sits, the W rolling rows behind it, raw under the codec).
Reduced gemma2 (window 16: its ``local`` layers are lanes, its ``global``
layers pools), reduced mixtral (window 16, every layer ``swa_moe``: all
lanes) and reduced danube (window 16, all lanes) serve
``tests/harness.py::MIXED`` with unit-scale MLP weights, and must give the
tokens of the JAX run on the same settings, its Pallas kernel interpreted
(jax 0.9 renamed the compiler-params class the kernel names; the alias is
scoped to each test by ``monkeypatch``): chunks of 3 on page 4 (one mixed
step a tick), monolithic prefill installed into page 4, and chunks of 4 on
page 8 under ``kv_codec="cluster"``.  Stated tolerance: tokens identical.

Where the pools page, the paged attention runs once a pageable block a
step and never for a lane block; when no leaf pages (danube, mixtral) it
never runs, and serving still completes.  Lanes stay as they are when the
pools grow, and no page is leaked.
"""

import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from repro_torch.models import attention
from repro_torch.runtime import SlotPool
from repro_torch.tree import tree_leaves
from tests.harness import assert_tokens_identical
from tests.test_torch_serve_gathered import (assert_nothing_leaked,
                                             make_engines, oracle,
                                             port_serve)

ARCHS = ("gemma2-2b", "mixtral-8x22b", "h2o-danube-1.8b")
SETTINGS = {
    "page 4 chunk 3": dict(kv_page_size=4, prefill_chunk=3),
    "page 4 monolithic": dict(kv_page_size=4),
    "page 8 chunk 4 codec": dict(kv_page_size=8, prefill_chunk=4,
                                 kv_codec="cluster"),
}

_ENGINES = {}


def engines(arch):
    if arch not in _ENGINES:
        _ENGINES[arch] = make_engines(arch)
    return _ENGINES[arch]


@pytest.fixture
def kernel_calls(monkeypatch):
    """Count the model's calls of the paged attention (its plain version
    on the CPU), and let the JAX kernel run interpreted."""
    monkeypatch.setattr(pltpu, "TPUCompilerParams", pltpu.CompilerParams,
                        raising=False)
    calls = []
    inner = attention.paged_mixed_attention

    def counted(*args, **kw):
        calls.append(args[0].shape)
        return inner(*args, **kw)

    monkeypatch.setattr(attention, "paged_mixed_attention", counted)
    return calls


def _pageable_blocks(engine) -> int:
    cfg = engine.cfg
    return sum(k in ("global", "attn") for k in cfg.scan_pattern) \
        * cfg.scan_repeats


@pytest.mark.parametrize("setting", SETTINGS)
@pytest.mark.parametrize("arch", ARCHS)
def test_lanes_beside_pools_tokens_identical_to_the_reference(
        arch, setting, kernel_calls):
    engine, jengine, reqs = engines(arch)
    kw = SETTINGS[setting]
    want = oracle(jengine, reqs, attn_backend="pallas_paged", **kw)
    got, sched = port_serve(engine, reqs, attn_backend="cuda_paged", **kw)
    assert_tokens_identical(got, want, f"{arch} {setting}")
    pool = sched._pool
    lanes = [not f for f in pool.paged_flags]
    assert any(lanes) and all(lanes) == (arch != "gemma2-2b")
    m, jm = engine.metrics, jengine.metrics
    assert (m.decode_steps, m.kv_gather_bytes, m.kv_prefill_gather_bytes,
            m.prefill_chunks) == (jm.decode_steps, jm.kv_gather_bytes,
                                  jm.kv_prefill_gather_bytes,
                                  jm.prefill_chunks)
    # the paged attention runs once a pageable block a mixed step: on the
    # monolithic path a Q=1 step a decode step
    blocks = _pageable_blocks(engine)
    assert bool(kernel_calls) == bool(blocks) == (arch == "gemma2-2b")
    if blocks:
        assert len(kernel_calls) % blocks == 0
    if "monolithic" in setting:
        assert len(kernel_calls) == m.decode_steps * blocks
    assert_nothing_leaked(pool)


def test_lane_layout_and_growth():
    """gemma2's ``local`` leaves are lanes (repeats, slots, W, KH, D),
    raw under the codec (None scales), its ``global`` leaves page pools;
    growing the pools past capacity reallocates the pools and leaves the
    lanes alone."""
    engine = engines("gemma2-2b")[0]
    cfg = engine.cfg
    pool = SlotPool(engine, 2, 32, page_size=4, backend="cuda_paged",
                    kv_codec="cluster")
    r, kh, hd = cfg.scan_repeats, cfg.num_kv_heads, cfg.head_dim
    cap = pool.page_capacity
    assert pool.paged_flags == (False, False, True, True)
    shapes = [tuple(c.shape) for c in tree_leaves(pool.kcache)]
    assert shapes == [(r, 2, cfg.window, kh, hd)] * 2 + \
        [(r, cap, 4, kh, hd)] * 2
    assert [c.dtype for c in tree_leaves(pool.kcache)] == \
        [torch.float32] * 2 + [torch.int8] * 2
    assert [s is None for s in tree_leaves(pool.kscales)] == \
        [True, True, False, False]
    assert len(pool.code_pools()) == 2 and pool.codec_error_bound() == 0.0
    lanes = [c.data_ptr() for c in tree_leaves(pool.kcache)[:2]]
    pool.grow_pages(cap + 3)
    assert [c.data_ptr() for c in tree_leaves(pool.kcache)[:2]] == lanes
    assert [tuple(c.shape) for c in tree_leaves(pool.kcache)] == \
        shapes[:2] + [(r, pool.page_capacity, 4, kh, hd)] * 2
    assert pool.page_capacity >= cap + 3
    assert tree_leaves(pool.kscales)[2].shape == (r, pool.page_capacity, 4)


def test_all_lanes_pool_serves_without_the_kernel(kernel_calls):
    """danube at window 16 and slots of 32: no leaf pages, so the pool
    has no page pool at all and the mixed step never reaches the paged
    attention; the page table is still kept, as the reference keeps it."""
    engine, _, reqs = engines("h2o-danube-1.8b")
    got, sched = port_serve(engine, reqs, attn_backend="cuda_paged",
                            kv_page_size=4, prefill_chunk=3)
    pool = sched._pool
    assert pool.paged_flags == (False, False)
    assert pool.gather_bytes_avoided_per_step == 0
    assert all(c.shape[1] == pool.n_slots for c in tree_leaves(pool.kcache))
    assert not kernel_calls and len(got) == len(reqs)
    assert np.all(pool.table == 0)

"""The port's MLA path (deepseek-v2) against the JAX reference, on the CPU.

* The paged-attention plain version with the MLA second score operand
  (``q2``/``k2_pages``, one latent KV head that is also the value pool)
  against the reference's own formula for it
  (``tests/test_paged_attention.py::test_mla_second_operand``: scores
  ``(q1 . c + q2 . pe) * scale``, softmax, ``p @ c``), extended to ragged
  chunk rows; with codec pools encoded by the JAX codec, against the same
  formula on the JAX-decoded pools, and bit-identical to the fp path on
  the pools decoded up front; poisoned page-0 codes, scales and ``k2``
  rows inert.  f32, atol 1e-5, rtol 1e-4: summation order only.  The CUDA
  kernel is held to this plain version by ``tests/test_torch_cuda.py``.
* ``attention.mla_apply`` (paged) against the JAX ``mla_apply``'s absorbed
  branch on gathered lanes (``cache=..., pos=...``), chunk by chunk; under
  the codec against ``kv_quant=True``, with the pools' codes and scales
  byte-identical to ``repro.kernels.kv_codec.encode`` of the latent and
  rope keys.
* ``mixed_step`` logits of the reduced deepseek against JAX monolithic
  prefill + ``decode_step`` (1e-4).
* ``Scheduler(attn_backend="cuda_paged")`` tokens identical to the JAX
  gathered monolithic-prefill ``Scheduler`` on ``tests/harness.py::MIXED``
  with unit-scale MLP weights at pages 4/8 x chunks 3/4; under the codec
  identical to the JAX gathered chunked codec path (ROADMAP "Reference
  caveats"); ``SlotPool`` page bytes over the two MLA leaves equal the
  JAX ``SlotPool``'s; the launcher serves ``--arch deepseek-v2-236b``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import kv_codec as jkv
from repro.models import api as japi
from repro.models import attention as jattn
from repro.models import transformer as jtransformer
from repro.runtime import ServeEngine as JaxServeEngine
from repro.runtime.decode_cache import DecodeTileCache as JaxCache
from repro.runtime.scheduler import SlotPool as JaxSlotPool
from repro.runtime.weight_store import WeightStore as JaxWeightStore
from repro_torch.kernels import kv_codec as kv
from repro_torch.kernels.paged_attention import (decode_pool,
                                                 paged_mixed_attention)
from repro_torch.launch import serve as serve_launch
from repro_torch.models import attention, transformer
from repro_torch.models.api import (cache_layout, get_model,
                                    supports_chunked_prefill,
                                    supports_paged_attention)
from repro_torch.runtime import Scheduler, ServeEngine, SlotPool
from repro_torch.runtime.decode_cache import DecodeTileCache
from repro_torch.runtime.weight_store import WeightStore
from repro_torch.tree import params_from_numpy, tree_leaves, tree_map
from tests.harness import MIXED, assert_tokens_identical, mixed_requests
from tests.harness import run_trace as jax_serve
from tests.test_torch_harness import (jax_params, jitted, reduced_jax,
                                      reduced_torch, torch_params,
                                      unit_scale_mlp)
from tests.test_torch_paged_attention import paged_case

ATOL, RTOL = 1e-5, 1e-4
ARCH = "deepseek-v2-236b"

# ---------------------------------------------------------------------------
# the kernel's plain version with the second score operand
# ---------------------------------------------------------------------------


def mla_case(seed, *, qn, q_lens, lengths, d2=8, **kw):
    """``paged_case`` with one latent KV head (``k`` is the latent pool,
    used as key and value) plus a rope pool ``pe`` and rope queries."""
    c = paged_case(seed, qn=qn, q_lens=q_lens, lengths=lengths, kh=1, **kw)
    rng = np.random.default_rng(seed + 100)
    c["pe"] = rng.standard_normal((*c["k"].shape[:3], d2)).astype(np.float32)
    c["q2"] = rng.standard_normal((*c["q"].shape[:3], d2)).astype(np.float32)
    c["scale"] = (c["q"].shape[-1] + d2) ** -0.5
    return c


def mla_oracle(c, s):
    """The reference's formula for slot s, per real query row: gather the
    latent and rope rows, score ``(q1 . c + q2 . pe) * scale`` under the
    causal mask, softmax, weight the latent rows."""
    lg = c["logical"]
    lat = c["k"][c["table"][s], :lg, 0].reshape(-1, c["k"].shape[-1])
    pe = c["pe"][c["table"][s], :lg, 0].reshape(-1, c["pe"].shape[-1])
    ql, ln = int(c["q_lens"][s]), int(c["lengths"][s])
    rows = []
    for i in range(ql):
        sc = (c["q"][s, i] @ lat.T + c["q2"][s, i] @ pe.T) * c["scale"]
        sc = np.where(np.arange(lat.shape[0])[None] <= ln - ql + i, sc,
                      -1e30)
        p = np.asarray(jax.nn.softmax(jnp.asarray(sc), axis=-1))
        rows.append(p @ lat)
    return np.stack(rows) if rows else np.zeros((0,))


def port_mla(c, codes=None, **kw):
    t = torch.from_numpy
    common = (t(c["table"]), t(c["lengths"]), t(c["q_lens"]))
    kw = dict(scale=c["scale"], page_size=c["logical"], **kw)
    if codes is None:
        lat = t(c["k"])
        return paged_mixed_attention(t(c["q"]), lat, lat, *common,
                                     t(c["q2"]), t(c["pe"]), **kw).numpy()
    (cc, cs), (pc, ps) = codes
    return paged_mixed_attention(t(c["q"]), cc, cc, *common, t(c["q2"]), pc,
                                 cs, cs, ps, kv.codebook(), **kw).numpy()


def encode_pools(c):
    """Encode the latent and rope pools with the JAX codec: the port's
    int8 codes + scales, and ``c`` rewritten to the JAX-decoded pools."""
    codes = []
    for name in ("k", "pe"):
        jc, js = jkv.encode(c[name], (-2, -1))
        c[name] = np.array(jkv.decode(jc, np.asarray(js)[..., None, None]))
        codes.append((torch.from_numpy(np.array(jc)),
                      torch.from_numpy(np.array(js))))
    return codes


BLOCKS = {   # ragged blocks: chunk rows, a decode row, an empty slot
    "chunk": dict(qn=5, q_lens=[5, 1, 0, 3], lengths=[19, 9, 0, 3], rows=8,
                  logical=5),
    "decode": dict(qn=1, q_lens=[1, 1, 1], lengths=[23, 1, 11]),
}


@pytest.mark.parametrize("codec", [False, True])
@pytest.mark.parametrize("block", sorted(BLOCKS))
def test_mla_plain_vs_reference_formula(block, codec):
    c = mla_case(21, **BLOCKS[block])
    codes = encode_pools(c) if codec else None
    out = port_mla(c, codes)
    for s, ql in enumerate(c["q_lens"]):
        if ql:
            np.testing.assert_allclose(out[s, :ql], mla_oracle(c, s),
                                       atol=ATOL, rtol=RTOL)
        assert (out[s, ql:] == 0).all()


@pytest.mark.parametrize("dequant", ["gather", "onehot"])
def test_mla_codec_bit_identical_to_fp_on_decoded_pools(dequant):
    c = mla_case(22, **BLOCKS["chunk"])
    codes = encode_pools(c)
    (cc, cs), (pc, ps) = codes
    cb = kv.codebook()
    assert decode_pool(cc, cs, cb).numpy().tobytes() == c["k"].tobytes()
    assert decode_pool(pc, ps, cb).numpy().tobytes() == c["pe"].tobytes()
    got = port_mla(c, codes, dequant=dequant)
    assert got.tobytes() == port_mla(c).tobytes()


def test_mla_poisoned_sink_codes_scales_and_k2_rows_are_inert():
    c = mla_case(23, **BLOCKS["chunk"])
    clean_fp = port_mla(c)
    for name, val in (("k", 1e6), ("pe", -1e6)):
        c[name][0], c[name][:, 5:] = val, val
    assert np.array_equal(clean_fp, port_mla(c))
    c = mla_case(23, **BLOCKS["chunk"])
    codes = encode_pools(c)
    clean = port_mla(c, codes)
    for codes_, scales in codes:
        codes_[0], codes_[:, 5:] = 127, 127
        scales[0], scales[:, 5:] = 1e6, 1e6
    poisoned = port_mla(c, codes)
    assert np.isfinite(poisoned).all()
    np.testing.assert_array_equal(clean, poisoned)


# ---------------------------------------------------------------------------
# mla_apply (paged) vs the JAX absorbed branch on gathered lanes
# ---------------------------------------------------------------------------

# (start position, tokens) of each block: two chunks, then two decodes
STEPS = [(0, 5), (5, 3), (8, 1), (9, 1)]


def run_mla_steps(codec: bool, seed=31, batch=2, page=4, pps=3):
    jcfg, cfg = reduced_jax(ARCH), reduced_torch(ARCH)
    tree = jax.tree_util.tree_map(np.asarray, jattn.mla_init(
        jax.random.PRNGKey(seed), jcfg, jnp.float32))
    p = params_from_numpy(tree, "cpu")
    r, dr = cfg.kv_lora_rank, cfg.rope_head_dim
    smax, n_pages = page * pps, batch * pps + 1
    jcache = {"c_kv": jnp.zeros((batch, smax, r)),
              "k_pe": jnp.zeros((batch, smax, dr))}
    dt = torch.int8 if codec else torch.float32
    pools = {"c_kv": torch.zeros((n_pages, page, r), dtype=dt),
             "k_pe": torch.zeros((n_pages, page, dr), dtype=dt)}
    scales = {k: torch.zeros((n_pages, page)) for k in pools} if codec \
        else None
    ctx = attention.PagedContext(table=torch.arange(
        1, n_pages, dtype=torch.int32).reshape(batch, pps), page_size=page)
    rng = np.random.default_rng(seed)
    outs = []
    for pos, s in STEPS:
        x = rng.standard_normal((batch, s, cfg.d_model)).astype(np.float32)
        want, jcache = jattn.mla_apply(tree, jnp.asarray(x), jcfg,
                                       cache=jcache, pos=pos,
                                       kv_quant=codec)
        got, pools, *rest = attention.mla_apply(
            p, torch.from_numpy(x), cfg, cache=pools,
            pos=torch.full((batch,), pos, dtype=torch.int32), paged=ctx,
            scales=scales)
        if codec:
            scales = rest[0]
        outs.append((got.numpy(), np.asarray(want)))
    return outs, pools, scales


@pytest.mark.parametrize("codec", [False, True])
def test_mla_apply_matches_the_absorbed_reference(codec):
    outs, _, _ = run_mla_steps(codec)
    for got, want in outs:
        np.testing.assert_allclose(got, want, atol=ATOL, rtol=RTOL)


def test_mla_codec_pools_byte_identical_to_the_reference_encode():
    """The latent and rope keys each block writes do not depend on the
    attention, so the fp run's pools hold exactly the values the codec
    run encoded: ``repro.kernels.kv_codec.encode`` of them gives the codec
    pools' codes and scales byte for byte (unwritten rows: 0 and 0)."""
    _, fp, _ = run_mla_steps(False)
    _, codes, scales = run_mla_steps(True)
    for name in ("c_kv", "k_pe"):
        jc, js = jkv.encode(fp[name].numpy(), (-1,))
        assert codes[name].dtype == torch.int8
        np.testing.assert_array_equal(codes[name].numpy(), np.asarray(jc))
        assert scales[name].numpy().tobytes() == np.asarray(js).tobytes()


# ---------------------------------------------------------------------------
# the model: mixed_step vs monolithic prefill + decode_step
# ---------------------------------------------------------------------------


def page_pools(cfg, n_pages, page, slot_len):
    """Zero page pools for every cache leaf (the SlotPool layout)."""
    api = get_model(cfg)
    specs = api.init_cache_specs(cfg, 1, slot_len)
    axes = iter(cache_layout(api, cfg, slot_len)[1])

    def make(spec):
        ax = next(axes)
        return torch.zeros((*spec.shape[:ax - 1], n_pages, page,
                            *spec.shape[ax + 1:]), dtype=spec.dtype)
    return tree_map(make, specs)


def test_probes_and_cache_layout_match_the_reference():
    """The MLA leaves (B, L, r_kv) and (B, L, dr) have no head axis; the
    probe finds their batch and length axes where the reference does."""
    jcfg, cfg = reduced_jax(ARCH), reduced_torch(ARCH)
    assert supports_paged_attention(cfg) and supports_chunked_prefill(cfg)
    assert (japi.supports_paged_attention(jcfg),
            japi.supports_chunked_prefill(jcfg)) == (True, True)
    for slot_len in (16, 32):
        assert cache_layout(get_model(cfg), cfg, slot_len) == \
            japi.cache_layout(japi.get_model(jcfg), jcfg, slot_len) == \
            ((0, 0, 1, 1), (1, 1, 2, 2))


def test_weight_store_names_and_counters_match_on_the_deepseek_tree():
    """Only layer 0's dense MLP (a ``prefix`` list leaf) is compressed, in
    both packages: the same report, the same tile keys
    (``prefix/0/mlp/...``), the same counters and rebuilt weights; the
    expert and shared-expert leaves are served as given."""
    tree = jax_params(reduced_jax(ARCH), seed=2)
    jstore, store = JaxWeightStore(JaxCache()), WeightStore(DecodeTileCache())
    assert jstore.register_model("m", tree) == \
        store.register_model("m", torch_params(tree))
    assert sorted(store.layers("m")) == ["prefix/0/mlp/down",
                                         "prefix/0/mlp/gate",
                                         "prefix/0/mlp/up"]
    for _ in range(2):
        jw, w = jstore.materialize("m"), store.materialize("m")
        assert store.cache.keys() == jstore.cache.keys()
        assert store.cache.stats() == jstore.cache.stats()
    for name in ("gate", "up", "down"):
        np.testing.assert_array_equal(
            w["prefix"][0]["mlp"][name].numpy(),
            np.asarray(jw["prefix"][0]["mlp"][name]))
    moe = w["scan"]["b0"]["moe"]
    np.testing.assert_array_equal(moe["w_gate"].numpy(),
                                  tree["scan"]["b0"]["moe"]["w_gate"])
    np.testing.assert_array_equal(moe["shared"]["up"].numpy(),
                                  tree["scan"]["b0"]["moe"]["shared"]["up"])


def test_mixed_step_logits_match_prefill_and_decode():
    jcfg, cfg = reduced_jax(ARCH), reduced_torch(ARCH)
    tree = jax_params(jcfg, seed=1)
    params = torch_params(tree)
    rng = np.random.default_rng(4)
    prompts = [rng.integers(0, 128, n) for n in (7, 3)]
    n_dec, page, pps = 3, 4, 4
    want_prefill, want_dec, dec_toks = [], [], []
    jprefill = jitted(jtransformer.prefill, jcfg)
    jdecode = jitted(jtransformer.decode_step, jcfg)
    for p in prompts:
        cache = jtransformer.init_cache(jcfg, 1, page * pps)
        logits, cache = jprefill(tree, jnp.asarray(p[None]), cache)
        want_prefill.append(np.asarray(logits[0, -1]))
        toks, rows = [int(np.argmax(logits[0, -1]))], []
        for i in range(n_dec):
            logits, cache = jdecode(
                tree, cache, jnp.asarray([[toks[-1]]]), len(p) + i)
            rows.append(np.asarray(logits[0, -1]))
            toks.append(int(np.argmax(logits[0, -1])))
        want_dec.append(rows)
        dec_toks.append(toks)
    cache = page_pools(cfg, 2 * pps + 1, page, page * pps)
    assert [tuple(c.shape) for c in tree_leaves(cache)] == [
        (9, 4, 16), (9, 4, 8), (2, 9, 4, 16), (2, 9, 4, 8)]
    table = torch.arange(1, 2 * pps + 1, dtype=torch.int32).reshape(2, pps)
    toks = torch.zeros((2, 7), dtype=torch.int32)
    for s, p in enumerate(prompts):
        toks[s, :len(p)] = torch.from_numpy(p.astype(np.int32))
    kw = dict(paged_flags=(True,) * 4, page_size=page)
    q_lens = torch.tensor([7, 3], dtype=torch.int32)
    with torch.no_grad():
        logits, cache = transformer.mixed_step(
            cfg, params, cache, table, toks,
            torch.zeros(2, dtype=torch.int32), q_lens, **kw)
        for s in range(2):
            np.testing.assert_allclose(logits[s, q_lens[s] - 1].numpy(),
                                       want_prefill[s], atol=1e-4, rtol=1e-4)
        for i in range(n_dec):
            step_toks = torch.tensor([[t[i]] for t in dec_toks],
                                     dtype=torch.int32)
            poss = torch.tensor([len(p) + i for p in prompts],
                                dtype=torch.int32)
            logits, cache = transformer.mixed_step(
                cfg, params, cache, table, step_toks, poss,
                torch.ones(2, dtype=torch.int32), **kw)
            for s in range(2):
                np.testing.assert_allclose(logits[s, 0].numpy(),
                                           want_dec[s][i], atol=1e-4,
                                           rtol=1e-4)


# ---------------------------------------------------------------------------
# serving: Scheduler tokens vs the JAX oracles
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def engines():
    """The same compressed reduced deepseek in both packages (unit-scale
    dense MLP; the experts stay float in both) and the JAX oracle's
    tokens on MIXED (monolithic prefill, gathered lanes)."""
    tree = unit_scale_mlp(jax_params(reduced_jax(ARCH), seed=0))
    jengine = JaxServeEngine(reduced_jax(ARCH), tree)
    engine = ServeEngine(reduced_torch(ARCH), torch_params(tree),
                         device="cpu")
    reqs = mixed_requests(jengine, MIXED)
    return engine, jengine, reqs, jax_serve(jengine, reqs)


def port_serve(engine, reqs, **kw):
    engine.metrics = type(engine.metrics)()
    sched = Scheduler(engine, batch_size=2, attn_backend="cuda_paged", **kw)
    rids = {sched.submit(*r).rid: i for i, r in enumerate(reqs)}
    done = sched.run()
    assert len(done) == len(reqs)
    return {rids[r.rid]: tuple(r.generated) for r in done}, sched


@pytest.mark.parametrize("chunk", [3, 4])
@pytest.mark.parametrize("page", [4, 8])
def test_scheduler_tokens_identical_to_jax_oracle(engines, page, chunk):
    engine, _, reqs, want = engines
    assert engine.compressed and engine.store.n_tiles(engine.model_id) > 0
    got, sched = port_serve(engine, reqs, kv_page_size=page,
                            prefill_chunk=chunk)
    assert_tokens_identical(got, want, f"page {page} chunk {chunk}")
    m, pool = engine.metrics, sched._pool
    assert m.kv_gather_bytes == 0 and m.kv_prefill_gather_bytes == 0
    assert pool.allocator.n_allocated == 0 and (pool.table == 0).all()


@pytest.mark.parametrize("chunk", [3, 4])
@pytest.mark.parametrize("page", [4, 8])
def test_codec_scheduler_tokens_identical_to_jax_oracle(engines, page,
                                                        chunk):
    engine, jengine, reqs, _ = engines
    want = jax_serve(jengine, reqs, attn_backend="gathered",
                     kv_codec="cluster", kv_page_size=page,
                     prefill_chunk=chunk)
    got, sched = port_serve(engine, reqs, kv_page_size=page,
                            prefill_chunk=chunk, kv_codec="cluster")
    assert_tokens_identical(got, want, f"codec page {page} chunk {chunk}")
    pool, m = sched._pool, engine.metrics
    assert {c.dtype for c in tree_leaves(pool.kcache)} == {torch.int8}
    assert [s.shape for s in tree_leaves(pool.kscales)] == \
        [c.shape[:-1] for c in tree_leaves(pool.kcache)]
    assert m.kv_gather_bytes == 0 and m.kv_prefill_gather_bytes == 0
    assert m.kv_capacity_multiplier() == pytest.approx(
        pool.page_bytes_fp / pool.page_bytes_resident)


@pytest.mark.parametrize("page", [4, 8])
@pytest.mark.parametrize("codec", ["none", "cluster"])
def test_slot_pool_page_bytes_match_jax(engines, page, codec):
    """Two leaves of different widths (latent 16, rope 8) in every block:
    the page-byte counters are the reference's formula over both."""
    engine, jengine = engines[:2]
    jpool = JaxSlotPool(jengine, 2, 32, page_size=page, backend="gathered",
                        kv_codec=codec)
    pool = SlotPool(engine, 2, 32, page_size=page, kv_codec=codec)
    assert (pool.page_bytes_fp, pool.page_bytes_resident) == \
        (jpool.page_bytes_fp, jpool.page_bytes_resident)
    # 3 blocks x page x (16 + 8) f32; codec: int8 + one f32 scale a row
    assert pool.page_bytes_fp == 3 * page * 24 * 4
    if codec == "cluster":
        assert pool.page_bytes_resident == 3 * page * (24 + 2 * 4)
    n = 2 * 32 // page + 1                  # two full slots + the sink
    assert [tuple(c.shape) for c in tree_leaves(pool.kcache)] == [
        (n, page, 16), (n, page, 8), (2, n, page, 16), (2, n, page, 8)]


@pytest.mark.parametrize("codec", ["none", "cluster"])
def test_serve_launcher_deepseek_tiny_cpu(capsys, codec):
    done = serve_launch.main(["--arch", ARCH, "--scale", "tiny", "--device",
                              "cpu", "--batch", "2", "--requests", "3",
                              "--prompt-len", "20", "--gen", "5",
                              "--prefill-chunk", "8", "--kv-page-size", "4",
                              "--kv-codec", codec, "--attn-backend",
                              "cuda_paged"])
    assert len(done) == 3 and all(len(r.generated) == 5 for r in done)
    out = capsys.readouterr().out
    for line in ("weight store: 3 compressed MLP tensors", "served 3 "
                 "requests", "kv gather (cuda_paged backend): 0 bytes"):
        assert line in out
    # tiny MLA: 2 blocks x 4 rows x (32 latent + 16 rope) f32 per page
    assert ("kv codec (cluster): page 1536 fp bytes -> 448 resident bytes "
            "(3.43x effective capacity") in out or codec == "none"


def test_launcher_full_depth_deepseek_needs_a_layer_cut():
    with pytest.raises(ValueError, match="does not fit one card"):
        serve_launch.full_config(ARCH)
    cfg = serve_launch.full_config(ARCH, 2)
    assert (cfg.num_layers, cfg.prefix_kinds, cfg.scan_repeats) == \
        (2, ("mla_dense",), 1)
    assert (cfg.d_model, cfg.num_heads, cfg.kv_lora_rank, cfg.num_experts,
            cfg.top_k, cfg.moe_d_ff, cfg.capacity_factor) == \
        (5120, 128, 512, 160, 6, 1536, 1.25)
    tiny = serve_launch.tiny_config(ARCH)
    assert (tiny.num_experts, tiny.top_k, tiny.moe_d_ff,
            tiny.num_shared_experts, tiny.kv_lora_rank, tiny.scan_repeats,
            tiny.prefix_kinds) == (4, 2, 128, 1, 32, 1, ("mla_dense",))

"""The port's ReActNet forward (inference, and train mode's batch
statistics) and ``WeightStore.fused_operands`` against the JAX reference.

The reference's ``packed`` and ``compressed`` conv modes run Pallas
kernels that do not run on the installed jax (ROADMAP "Reference
caveats"), so the port's three modes are all held to the reference's
``conv_mode="ste"`` forward on the same params and images.  That is
sound because the binary convs compute the same integers in every mode
(+-1 operands: every product and partial sum is exact in float32), so
the port's ``packed`` and ``compressed`` (``cluster=False``) logits equal
its own ``ste`` logits exactly.

Against the reference, the float parts (stem conv, BN, alpha means,
pooling) differ in summation order and rounding, and an activation within
rounding of the RSign threshold then binarises to the other sign in one
package: with the reference's random init that flips a whole image's
logits (seen at seed 0).  So the parity params are made exact
(:func:`exact_params`): +-1 binary weights (alpha = 1), stem weights and
images on a 1/16 and 1/8 grid (every stem product and sum exact), and BN
variances with ``var + 1e-5 == 1`` in float32 (BN the identity).  Every
value before the head is then an exact dyadic rational in both packages,
and only the head's dot differs, within the reference's own tolerance for
this workflow, 1e-4 (``tests/test_system.py::
test_compressed_deploy_is_lossless``).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import get_config as get_jax_config
from repro.core import compression as jcomp
from repro.models import reactnet as jrn
from repro.runtime.decode_cache import DecodeTileCache as JaxDecodeTileCache
from repro.runtime.weight_store import WeightStore as JaxWeightStore
from repro_torch.configs.base import get_config
from repro_torch.core import compression
from repro_torch.kernels import ops
from repro_torch.models import reactnet as rn
from repro_torch.runtime.decode_cache import DecodeTileCache
from repro_torch.runtime.weight_store import WeightStore

LOGIT_TOL = 1e-4     # only the head's dot differs, by summation order
EXACT_VAR = np.float32(1.0) - np.float32(1e-5)      # var + 1e-5 == 1.0

# the reduced config of tests/test_system.py::trained_reactnet
JAX_CFG = dataclasses.replace(jrn.CONFIG, width=32, num_classes=10,
                              image_size=32,
                              blocks=((2, 1), (1, 2), (2, 2), (1, 1)))


def _port_cfg(cfg, **kw):
    return dataclasses.replace(rn.ReActNetConfig(**{
        f.name: getattr(cfg, f.name) for f in dataclasses.fields(cfg)}), **kw)


def exact_params(tree):
    """The reference's random params made exact in float32 (module doc)."""
    def visit(path, leaf):
        name = jax.tree_util.keystr(path)
        if "'w3'" in name or "'w1'" in name:
            return np.where(leaf >= 0, 1.0, -1.0).astype(np.float32)
        if "'stem'" in name and "'w'" in name:
            return np.round(leaf * 16) / 16
        if "'var'" in name:
            return np.full_like(leaf, EXACT_VAR)
        return leaf

    return jax.tree_util.tree_map_with_path(visit, tree)


@pytest.fixture(scope="module")
def reactnet():
    """(reference numpy params, port params, images, reference logits)."""
    jp = exact_params(jax.tree_util.tree_map(
        np.asarray, jrn.init_params(JAX_CFG, jax.random.PRNGKey(0))))
    imgs = np.round(np.random.default_rng(0).standard_normal(
        (4, 32, 32, 3)) * 8).astype(np.float32) / 8
    logits = np.asarray(jrn.forward(
        JAX_CFG, jax.tree_util.tree_map(jnp.asarray, jp), jnp.asarray(imgs)))
    return jp, rn.params_from_numpy(jp, "cpu"), imgs, logits


def _forward(params, imgs, mode, **prep):
    comp = rn.prepare_compressed(params, **prep) if mode == "compressed" \
        else None
    return rn.forward(_port_cfg(JAX_CFG, conv_mode=mode), params,
                      torch.from_numpy(imgs), compressed=comp).numpy()


def test_config_matches_reference():
    want, got = get_jax_config("reactnet"), get_config("reactnet")
    assert {f.name: getattr(got, f.name) for f in dataclasses.fields(got)} \
        == {f.name: getattr(want, f.name) for f in dataclasses.fields(want)}


def test_init_params_tree_matches_reference():
    jp = jrn.init_params(JAX_CFG, jax.random.PRNGKey(0))
    tp = rn.init_params(_port_cfg(JAX_CFG), torch.Generator().manual_seed(0),
                        "cpu")
    jpaths = jax.tree_util.tree_flatten_with_path(jp)[0]
    flat = {}
    for path, leaf in jpaths:
        node = tp
        for key in path:
            node = node[getattr(key, "key", getattr(key, "idx", None))]
        flat[jax.tree_util.keystr(path)] = (tuple(node.shape),
                                            tuple(leaf.shape))
    assert all(a == b for a, b in flat.values()), flat
    assert len(flat) == len(jax.tree_util.tree_leaves(jp))
    assert rn.fp_bits(_port_cfg(JAX_CFG), tp) == jrn.fp_bits(JAX_CFG, jp)


@pytest.mark.parametrize("mode", ["ste", "packed", "compressed"])
def test_forward_matches_reference_ste(reactnet, mode):
    jp, tp, imgs, want = reactnet
    got = _forward(tp, imgs, mode, cluster=False)
    assert got.shape == (4, 10) and np.isfinite(got).all()
    np.testing.assert_allclose(got, want, rtol=LOGIT_TOL, atol=LOGIT_TOL)
    np.testing.assert_array_equal(got.argmax(-1), want.argmax(-1))
    # the binary convs compute the same integers in every mode
    np.testing.assert_array_equal(got, _forward(tp, imgs, "ste"))


@pytest.mark.parametrize("gather", ["onehot", "bitplane"])
def test_clustered_compressed_forward_is_ste_on_clustered_weights(reactnet,
                                                                  gather):
    """With clustering, ``compressed`` computes exactly the ``ste``
    forward whose 3x3 weights carry the clustered signs (same magnitudes,
    so the same alpha)."""
    _, tp, imgs, _ = reactnet
    got = _forward(tp, imgs, "compressed", cluster=True, gather=gather)
    clustered = {**tp, "blocks": []}
    for blk in tp["blocks"]:
        w3 = blk["w3"]
        bits = compression.decompress_fused(compression.compress_gemm_fused(
            (w3 >= 0).numpy().astype(np.uint8).reshape(w3.shape[0], -1)))
        signs = torch.from_numpy(bits.astype(np.float32) * 2 - 1)
        clustered["blocks"].append(
            {**blk, "w3": signs.reshape(w3.shape) * w3.abs()})
    np.testing.assert_array_equal(got, _forward(clustered, imgs, "ste"))


def test_weight_bits_and_prepare_match_reference(reactnet):
    jp, tp, _, _ = reactnet
    want = jrn.binary_weight_bits(jp)
    got = rn.binary_weight_bits(tp)
    assert list(got) == list(want)
    for name in want:
        np.testing.assert_array_equal(got[name], want[name])
    for cluster in (False, True):
        for (w, t, meta), (jw, jt, jmeta) in zip(
                rn.prepare_compressed(tp, cluster=cluster),
                jrn.prepare_compressed(jax.tree_util.tree_map(jnp.asarray, jp),
                                       cluster=cluster)):
            np.testing.assert_array_equal(w.numpy().view(np.uint32),
                                          np.asarray(jw))
            np.testing.assert_array_equal(t.numpy(), np.asarray(jt))
            assert meta == jmeta


def test_forward_rejects_what_it_does_not_run(reactnet):
    jp, tp, imgs, _ = reactnet
    x = torch.from_numpy(imgs)
    # train=True (batch-statistics BN) runs, as the reference's does
    want = np.asarray(jax.jit(lambda p, i: jrn.forward(
        JAX_CFG, p, i, train=True))(jax.tree_util.tree_map(jnp.asarray, jp),
                                    jnp.asarray(imgs)))
    got = rn.forward(_port_cfg(JAX_CFG), tp, x, train=True).numpy()
    np.testing.assert_allclose(got, want, rtol=LOGIT_TOL, atol=LOGIT_TOL)
    with pytest.raises(ValueError, match="conv_mode"):
        rn.forward(_port_cfg(JAX_CFG, conv_mode="dense"), tp, x)
    with pytest.raises(ValueError, match="prepare_compressed"):
        rn.forward(_port_cfg(JAX_CFG, conv_mode="compressed"), tp, x)


def test_same_pads_are_xla_same():
    # 3x3 stride 2: even sizes pad (0, 1), odd sizes (1, 1)
    assert [rn._same_pads(s, 3, 2) for s in (224, 32, 7, 1)] == \
        [(0, 1), (0, 1), (1, 1), (1, 1)]
    assert rn._same_pads(14, 3, 1) == (1, 1)


# --- WeightStore.fused_operands --------------------------------------------

def _stores(rng, d=72, f=256, cache=None):
    w = rng.standard_normal((d, f)).astype(np.float32)
    jstore = JaxWeightStore(JaxDecodeTileCache())
    jstore.register_model("m", {"l0": {"mlp": {"up": w}}})
    store = WeightStore(cache if cache is not None else DecodeTileCache())
    store.register_model("m", {"l0": {"mlp": {"up": torch.from_numpy(w)}}})
    return jstore, store


@pytest.mark.parametrize("gather,codes", [("onehot", None), ("bitplane", 16),
                                          ("onehot", 32)])
def test_fused_operands_match_reference(rng, gather, codes):
    jstore, store = _stores(rng)
    words, tables, meta = store.fused_operands("m", "l0/mlp/up",
                                               gather=gather, codes=codes)
    jw, jt, jmeta = jstore.fused_operands("m", "l0/mlp/up", gather=gather,
                                          codes=codes)
    np.testing.assert_array_equal(words.numpy().view(np.uint32),
                                  np.asarray(jw))
    np.testing.assert_array_equal(tables.numpy().view(np.uint32),
                                  np.asarray(jt).view(np.uint32))
    np.testing.assert_array_equal(meta.pop("scale").numpy(),
                                  np.asarray(jmeta.pop("scale")))
    assert meta == jmeta
    assert (store.cache.hits, store.cache.misses) == \
        (jstore.cache.hits, jstore.cache.misses)


def test_fused_operands_round_trip(rng):
    """Round trip (after tests/test_runtime.py::
    test_cached_tiles_match_direct_fused_kernel): the fused decode+GEMM of
    the cache-served operands equals sign(x) @ the materialised signs."""
    _, store = _stores(rng)
    words, tables, meta = store.fused_operands("m", "l0/mlp/up")
    x = rng.standard_normal((5, 72)).astype(np.float32)
    y_fused = ops.compressed_binary_matmul(
        torch.from_numpy(x), words, tables, k_true=meta["k_true"],
        n_true=meta["n_true"], codes=meta["codes"])
    w_rec = store.materialize("m")["l0"]["mlp"]["up"]
    signs = w_rec / meta["scale"][None, :]                # +-1 matrix
    y_cached = torch.where(torch.from_numpy(x) >= 0, 1.0, -1.0) @ signs
    np.testing.assert_array_equal(y_fused.numpy(), y_cached.numpy())


def test_fused_operands_memo_follows_the_cache(rng):
    """The operands are memoised while every tile hits, and rebuilt after
    a tile was evicted, as in the reference."""
    _, store = _stores(rng, cache=DecodeTileCache())
    first = store.fused_operands("m", "l0/mlp/up")
    assert store.fused_operands("m", "l0/mlp/up") is first
    store.cache.clear()
    rebuilt = store.fused_operands("m", "l0/mlp/up")
    assert rebuilt is not first
    assert torch.equal(rebuilt[0], first[0])
    assert jcomp.DEFAULT_CODES_PER_SUB == rebuilt[2]["codes"]

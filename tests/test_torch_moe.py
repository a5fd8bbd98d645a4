"""The port's MoE (``repro_torch.models.moe``) against the JAX reference
``repro.models.moe``, on the CPU.

The same numpy-seeded inputs and the reference's own ``moe_init`` params
(carried across with ``params_from_numpy``) go through both
``moe_apply``s on the reduced deepseek-v2 config: with no drops
(``capacity_factor`` 8) and with drops (1.25, and the test asserts that
some tokens are dropped), for decode blocks (Q == 1, S in {4, 6, 16}, the
reference's cross-batch regroup) and ragged mixed blocks (Q > 1, padded
rows routed like any other).  Outputs agree within atol 1e-5, rtol 1e-4
(f32; the routing is identical and only the summation order of the
products differs); the aux loss within rtol 1e-6.  Exact ties route to
the lower expert index, as ``jax.lax.top_k`` does.
"""

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from repro.models import moe as jmoe
from repro.models.api import get_model
from repro_torch.models import moe
from repro_torch.tree import params_from_numpy, tree_leaves, \
    tree_map_with_path
from tests.test_torch_harness import reduced_jax, reduced_torch

ATOL, RTOL = 1e-5, 1e-4


def configs(capacity_factor):
    over = dict(capacity_factor=capacity_factor)
    return (reduced_jax("deepseek-v2-236b").scaled(**over),
            reduced_torch("deepseek-v2-236b").scaled(**over))


def params(jcfg, seed=0):
    tree = jax.tree_util.tree_map(
        np.asarray, jmoe.moe_init(jax.random.PRNGKey(seed), jcfg,
                                  jnp.float32))
    return tree, params_from_numpy(tree, "cpu")


def drops(jcfg, x, router) -> int:
    """Routing choices the reference drops for ``x``: its grouping,
    router, top-k and capacity, with the positions counted in numpy."""
    b0, s0, d = x.shape
    if s0 == 1 and b0 > 1:
        g = next((c for c in (16, 16, 8, 4, 2) if b0 % c == 0), 1)
        x = x.reshape(g, b0 // g, d)
    cap = jmoe._capacity(x.shape[1], jcfg)
    eid = np.asarray(jax.lax.top_k(jax.nn.softmax(
        jnp.asarray(x) @ router, -1), jcfg.top_k)[1])
    n = 0
    for row in eid.reshape(x.shape[0], -1):
        taken = np.zeros(jcfg.num_experts, np.int64)
        for e in row:
            n += int(taken[e] >= cap)
            taken[e] += 1
    return n


# (S, Q) blocks: decode (Q == 1: the regroup into 4, 2 and 16 groups) and
# ragged mixed blocks whose padded rows are routed like any other
SHAPES = [(4, 1), (6, 1), (16, 1), (3, 5), (2, 16), (1, 32)]


def case(shape, capacity_factor):
    """Rows that share a common direction, so that tokens agree on their
    experts and crowd them (random rows alone rarely fill a capacity)."""
    jcfg, cfg = configs(capacity_factor)
    tree, p = params(jcfg, seed=sum(shape))
    rng = np.random.default_rng(sum(shape))
    x = rng.standard_normal((*shape, jcfg.d_model)) \
        + 2.0 * rng.standard_normal(jcfg.d_model)
    return jcfg, cfg, tree, p, x.astype(np.float32)


@pytest.mark.parametrize("capacity_factor", [8.0, 1.25])
@pytest.mark.parametrize("shape", SHAPES)
def test_moe_apply_matches_reference(shape, capacity_factor):
    jcfg, cfg, tree, p, x = case(shape, capacity_factor)
    want, want_aux = jmoe.moe_apply(tree, jnp.asarray(x), jcfg)
    got, aux = moe.moe_apply(p, torch.from_numpy(x), cfg)
    assert got.shape == x.shape and aux.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL,
                               rtol=RTOL)
    np.testing.assert_allclose(float(aux), float(want_aux), rtol=1e-6)


@pytest.mark.parametrize("capacity_factor", [8.0, 1.25])
def test_drops_happen_only_below_capacity(capacity_factor):
    """At capacity factor 8 no choice is dropped; at 1.25 the grid above
    drops some (so the comparison covers the drop path)."""
    n = sum(drops(jcfg, x, tree["router"]) for jcfg, _, tree, _, x in
            (case(shape, capacity_factor) for shape in SHAPES))
    assert (n > 0) == (capacity_factor == 1.25), n


def test_ties_route_to_the_lower_expert():
    """A zero router gives every expert the same probability: both pick
    experts 0..k-1 (``jax.lax.top_k``'s order, a stable sort in the port)
    with equal gates."""
    jcfg, cfg = configs(8.0)
    tree, _ = params(jcfg, seed=3)
    tree["router"] = np.zeros_like(tree["router"])
    p = params_from_numpy(tree, "cpu")
    x = np.random.default_rng(4).standard_normal(
        (2, 3, jcfg.d_model)).astype(np.float32)
    want, _ = jmoe.moe_apply(tree, jnp.asarray(x), jcfg)
    got, _ = moe.moe_apply(p, torch.from_numpy(x), cfg)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL,
                               rtol=RTOL)
    vals, idx = moe._top_k(torch.full((2, 4), 0.25), 2)
    assert idx.tolist() == [[0, 1], [0, 1]] and (vals == 0.25).all()


def test_bf16_tree_carries_across_with_an_f32_router():
    """The reference's deepseek tree in bf16: prefix list, (E, d, f)
    expert stacks and the f32 router carry across leaf for leaf, with
    their paths, shapes, dtypes and values."""
    jcfg = reduced_jax("deepseek-v2-236b").scaled(dtype="bfloat16")
    tree = jax.tree_util.tree_map(
        np.asarray, get_model(jcfg).init_params(jcfg, jax.random.PRNGKey(0)))
    port = params_from_numpy(tree, "cpu")
    jleaves = jax.tree_util.tree_flatten_with_path(tree)[0]
    paths = []
    tree_map_with_path(lambda path, _: paths.append(path), port)
    assert len(paths) == len(jleaves)
    for (jpath, jleaf), path, leaf in zip(jleaves, paths, tree_leaves(port)):
        assert path == "/".join(str(getattr(k, "key", getattr(k, "idx", k)))
                                for k in jpath)
        assert tuple(leaf.shape) == jleaf.shape
        want = torch.float32 if jleaf.dtype == np.float32 \
            else torch.bfloat16
        assert leaf.dtype == want, path
        np.testing.assert_array_equal(
            leaf.float().numpy(), jleaf.astype(np.float32))
    scan = port["scan"]["b0"]["moe"]
    assert scan["router"].dtype == torch.float32
    assert scan["w_gate"].shape == (2, 4, jcfg.d_model, 32)
    assert isinstance(port["prefix"], list) and "mlp" in port["prefix"][0]
    assert tree["embed"].dtype == ml_dtypes.bfloat16


def test_moe_init_tree_and_dtypes():
    _, cfg = configs(1.25)
    cfg = cfg.scaled(dtype="bfloat16")
    p = moe.moe_init(torch.Generator().manual_seed(0), cfg, torch.bfloat16,
                     "cpu")
    jtree = jmoe.moe_init(jax.random.PRNGKey(0), reduced_jax(
        "deepseek-v2-236b"), jnp.bfloat16)
    shapes = lambda t: {k: (tuple(v.shape) if not isinstance(v, dict)
                            else shapes(v)) for k, v in t.items()}
    assert shapes(p) == shapes(jtree)
    assert p["router"].dtype == torch.float32
    assert {p[k].dtype for k in ("w_gate", "w_up", "w_down")} == \
        {torch.bfloat16}

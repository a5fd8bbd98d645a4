"""The port's training half against the JAX reference, on the CPU.

* ``repro_torch.data.pipeline`` is a numpy copy: its batches are byte-
  identical to ``repro.data.pipeline``'s (Philox streams per seed, host
  and step), and the prefetcher yields them in step order.
* ``repro_torch.train.optimizer`` against ``repro.train.optimizer``: the
  learning rate and five AdamW steps on a seeded tree, within
  ``OPT_RTOL`` (the same f32 arithmetic in the same order; XLA and torch
  round ``cos``/``pow``/``sqrt`` and sum a leaf in their own ways).
* ``ste_sign``'s gradient is ``jax.grad`` of the reference's, bit for bit,
  the |x| == 1 boundary included.
* ReActNet in train mode (batch-statistics BN), its loss and the gradient
  of every leaf against ``jax.value_and_grad(repro.models.reactnet.
  loss_fn)`` on exact params (``tests/test_torch_reactnet.py::
  exact_params``: +-1 binary weights, dyadic stem weights and images), so
  every activation binarises alike in both packages and only float
  summation order differs: logits and loss within ``TRAIN_TOL``, each
  gradient leaf within ``GRAD_TOL`` of its largest element.
* One full train step (gradients + AdamW) against the reference's.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.binarize import ste_sign as jax_ste_sign
from repro.data import pipeline as jpipe
from repro.models import reactnet as jrn
from repro.train import optimizer as jopt
from repro_torch.core.binarize import ste_sign
from repro_torch.data import pipeline
from repro_torch.models import reactnet as rn
from repro_torch.train import optimizer as opt
from repro_torch.tree import tree_leaves, tree_map
from tests.test_torch_reactnet import _port_cfg, exact_params

OPT_RTOL, OPT_ATOL = 1e-5, 1e-7
TRAIN_TOL = 1e-5        # logits and loss: float summation order only
GRAD_TOL = 1e-4         # |g - g_ref| <= GRAD_TOL * max|g_ref| per leaf

# a tiny ReActNet: both strides, channel duplication (mult 2), 3 blocks
JAX_CFG = dataclasses.replace(jrn.CONFIG, width=16, num_classes=10,
                              image_size=16,
                              blocks=((2, 1), (1, 2), (2, 2)))
BATCH = 8


def _jax_oc(oc):
    return jopt.OptConfig(**dataclasses.asdict(oc))


# --- data pipeline -------------------------------------------------------

@pytest.mark.parametrize("seed,host,hosts", [(0, 0, 1), (3, 1, 2),
                                             (1234, 3, 4)])
def test_synthetic_images_byte_identical(seed, host, hosts):
    got = pipeline.SyntheticImages(10, 16, 8, seed=seed, host_id=host,
                                   num_hosts=hosts)
    want = jpipe.SyntheticImages(10, 16, 8, seed=seed, host_id=host,
                                 num_hosts=hosts)
    np.testing.assert_array_equal(got.means, want.means)
    for step in (0, 1, 7, 10_001):
        g, w = got.batch(step), want.batch(step)
        assert g.keys() == w.keys()
        for k in w:
            assert g[k].dtype == w[k].dtype and g[k].shape == w[k].shape
            assert g[k].tobytes() == w[k].tobytes()


@pytest.mark.parametrize("seed,host,hosts", [(0, 0, 1), (5, 1, 2)])
def test_synthetic_lm_byte_identical(seed, host, hosts):
    got = pipeline.SyntheticLM(97, 8, 12, seed=seed, host_id=host,
                               num_hosts=hosts)
    want = jpipe.SyntheticLM(97, 8, 12, seed=seed, host_id=host,
                             num_hosts=hosts)
    for step in (0, 2, 99):
        g, w = got.batch(step), want.batch(step)
        for k in w:
            assert g[k].dtype == w[k].dtype
            assert g[k].tobytes() == w[k].tobytes()
    it = iter(got)
    for step in range(3):
        assert next(it)["tokens"].tobytes() == \
            want.batch(step)["tokens"].tobytes()


def test_prefetcher_yields_batches_in_step_order():
    src = pipeline.SyntheticImages(10, 8, 4, seed=2)
    want = jpipe.SyntheticImages(10, 8, 4, seed=2)
    pf = pipeline.Prefetcher(src, start_step=3, depth=2)
    try:
        for step in range(3, 8):
            b = next(pf)
            assert b["images"].tobytes() == want.batch(step)["images"].tobytes()
    finally:
        pf.close()
    pf.thread.join(timeout=5)
    assert not pf.thread.is_alive()


# --- optimizer -----------------------------------------------------------

@pytest.mark.parametrize("oc", [
    opt.OptConfig(lr=2e-2, warmup_steps=10, total_steps=150),
    opt.OptConfig(lr=1.0, warmup_steps=0, total_steps=7, min_lr_ratio=0.0),
    opt.OptConfig(lr=3e-4, warmup_steps=5, total_steps=5)])
def test_lr_schedule_matches_reference(oc):
    steps = np.arange(0, oc.total_steps + 4, dtype=np.int32)
    got = opt.lr_schedule(oc)(torch.from_numpy(steps))
    want = jopt.lr_schedule(_jax_oc(oc))(jnp.asarray(steps))
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=OPT_RTOL,
                               atol=0)


def _opt_tree(rng):
    """A nested tree with a list, a scalar and a leaf whose gradient is
    always zero (as ReActNet's BN running stats in train mode)."""
    return {"blocks": [{"w": rng.standard_normal((4, 3)).astype(np.float32),
                        "b": rng.standard_normal((3,)).astype(np.float32)}
                       for _ in range(2)],
            "head": rng.standard_normal((5,)).astype(np.float32) * 2,
            "stat": np.ones((3,), np.float32)}


@pytest.mark.parametrize("grad_clip", [1.0, 0.0])
@pytest.mark.parametrize("clip_latent", [0.0, 1.5])
def test_apply_updates_matches_reference(rng, grad_clip, clip_latent):
    oc = opt.OptConfig(lr=0.5, grad_clip=grad_clip, warmup_steps=2,
                       total_steps=6, weight_decay=0.1,
                       clip_latent=clip_latent)
    tree = _opt_tree(rng)
    jparams = jax.tree_util.tree_map(jnp.asarray, tree)
    params = tree_map(torch.from_numpy, tree)
    jstate, state = jopt.init_state(jparams), opt.init_state(params)
    for _ in range(5):
        g = jax.tree_util.tree_map(
            lambda x: rng.standard_normal(x.shape).astype(np.float32) * 3,
            tree)
        g["stat"] = np.zeros((3,), np.float32)
        jparams, jstate, jm = jopt.apply_updates(
            jparams, jax.tree_util.tree_map(jnp.asarray, g), jstate,
            _jax_oc(oc))
        params, state, m = opt.apply_updates(
            params, tree_map(torch.from_numpy, g), state, oc)
        assert int(state["step"]) == int(jstate["step"])
        assert state["step"].dtype == torch.int32
        for k in ("lr", "grad_norm"):
            np.testing.assert_allclose(float(m[k]), float(jm[k]),
                                       rtol=OPT_RTOL)
        for got, want in ((params, jparams), (state["mu"], jstate["mu"]),
                          (state["nu"], jstate["nu"])):
            for a, b in zip(tree_leaves(got), jax.tree_util.tree_leaves(want)):
                assert a.dtype == torch.float32
                np.testing.assert_allclose(a.numpy(), np.asarray(b),
                                           rtol=OPT_RTOL, atol=OPT_ATOL)
    if clip_latent:
        assert all(float(p.abs().max()) <= clip_latent
                   for p in tree_leaves(params))
    # the zero-gradient leaf only decays: its moments stay zero
    assert not state["mu"]["stat"].any() and not state["nu"]["stat"].any()


def test_adamw_reduces_quadratic():
    oc = opt.OptConfig(lr=0.1, weight_decay=0.0, warmup_steps=0,
                       total_steps=100)
    params = {"w": torch.tensor([5.0, -3.0])}
    state = opt.init_state(params)
    for _ in range(100):
        grads = {"w": 2 * params["w"]}
        params, state, _ = opt.apply_updates(params, grads, state, oc)
    assert float(params["w"].abs().max()) < 0.5


def test_grad_clip_and_schedule():
    oc = opt.OptConfig(lr=1.0, grad_clip=1.0, warmup_steps=10,
                       total_steps=100)
    sched = opt.lr_schedule(oc)
    lr = [float(sched(torch.tensor(s, dtype=torch.int32)))
          for s in (0, 10, 100)]
    assert lr[0] < lr[1] and lr[2] < lr[1]
    params = {"w": torch.zeros(3)}
    state = opt.init_state(params)
    _, _, metrics = opt.apply_updates(params, {"w": torch.full((3,), 1e6)},
                                      state, oc)
    assert float(metrics["grad_norm"]) > 1e5   # measured pre-clip


def test_latent_clip():
    oc = opt.OptConfig(lr=10.0, clip_latent=1.5, warmup_steps=0,
                       weight_decay=0.0)
    params = {"w": torch.tensor([1.4])}
    state = opt.init_state(params)
    params, _, _ = opt.apply_updates(params, {"w": torch.tensor([-9.9])},
                                     state, oc)
    assert float(params["w"][0]) <= 1.5


def test_apply_updates_refuses_mismatched_trees():
    params = {"a": torch.zeros(2), "b": torch.zeros(2)}
    with pytest.raises(ValueError, match="tree"):
        opt.apply_updates(params, {"a": torch.zeros(2)},
                          opt.init_state(params), opt.OptConfig())


# --- the STE -------------------------------------------------------------

def test_ste_sign_gradient_is_bit_exact(rng):
    x = (rng.standard_normal(64) * 1.5).astype(np.float32)
    x[:8] = [1.0, -1.0, 0.0, -0.0, np.nextafter(np.float32(1), 2),
             -np.nextafter(np.float32(1), 2), np.nextafter(np.float32(1), 0),
             -np.nextafter(np.float32(1), 0)]
    cot = rng.standard_normal(64).astype(np.float32)
    xt = torch.from_numpy(x).requires_grad_(True)
    y = ste_sign(xt)
    (gt,) = torch.autograd.grad(y, xt, torch.from_numpy(cot))
    jy, vjp = jax.vjp(jax_ste_sign, jnp.asarray(x))
    (jg,) = vjp(jnp.asarray(cot))
    assert y.detach().numpy().tobytes() == np.asarray(jy).tobytes()
    assert gt.numpy().tobytes() == np.asarray(jg).tobytes()
    # |x| == 1 passes the gradient, the next float above does not
    assert (gt.numpy()[:2] == cot[:2]).all() and not gt.numpy()[4:6].any()


# --- ReActNet in train mode ----------------------------------------------

@pytest.fixture(scope="module")
def train_case():
    """Exact params, a batch, and the reference's (loss, logits, grads)
    from one jit of ``value_and_grad``."""
    jp = exact_params(jax.tree_util.tree_map(
        np.asarray, jrn.init_params(JAX_CFG, jax.random.PRNGKey(1))))
    rng = np.random.default_rng(1)
    batch = {"images": np.round(rng.standard_normal(
                 (BATCH, 16, 16, 3)) * 8).astype(np.float32) / 8,
             "labels": rng.integers(0, 10, BATCH).astype(np.int32)}

    def loss(p, b):
        return jrn.loss_fn(JAX_CFG, p, b), jrn.forward(
            JAX_CFG, p, b["images"], train=True)

    (jloss, jlogits), jgrads = jax.jit(jax.value_and_grad(
        loss, has_aux=True))(jax.tree_util.tree_map(jnp.asarray, jp),
                             jax.tree_util.tree_map(jnp.asarray, batch))
    return jp, batch, float(jloss), np.asarray(jlogits), jgrads


def _port_batch(batch):
    return {k: torch.from_numpy(v) for k, v in batch.items()}


def test_train_forward_and_loss_match_reference(train_case):
    jp, batch, jloss, jlogits, _ = train_case
    params = rn.params_from_numpy(jp, "cpu")
    cfg = _port_cfg(JAX_CFG)
    logits = rn.forward(cfg, params, torch.from_numpy(batch["images"]),
                        train=True)
    np.testing.assert_allclose(logits.detach().numpy(), jlogits,
                               rtol=TRAIN_TOL, atol=TRAIN_TOL)
    loss = rn.loss_fn(cfg, params, _port_batch(batch))
    np.testing.assert_allclose(float(loss), jloss, rtol=TRAIN_TOL)
    # train mode reads the batch's statistics, not the running ones
    assert not torch.allclose(logits, rn.forward(
        cfg, params, torch.from_numpy(batch["images"])))


def test_every_gradient_matches_reference(train_case):
    jp, batch, jloss, _, jgrads = train_case
    params = rn.params_from_numpy(jp, "cpu")
    loss, grads = rn.loss_and_grads(_port_cfg(JAX_CFG), params,
                                    _port_batch(batch))
    np.testing.assert_allclose(float(loss), jloss, rtol=TRAIN_TOL)
    jflat = jax.tree_util.tree_flatten_with_path(jgrads)[0]
    flat = tree_leaves(grads)
    assert len(flat) == len(jflat)
    for (path, want), got in zip(jflat, flat):
        name, want = jax.tree_util.keystr(path), np.asarray(want)
        assert tuple(got.shape) == want.shape and got.dtype == torch.float32
        if "'mean'" in name or "'var'" in name:   # unread in train mode
            assert not got.any() and not want.any(), name
            continue
        scale = float(np.abs(want).max())
        assert scale > 0, name
        np.testing.assert_allclose(got.numpy(), want, rtol=0,
                                   atol=GRAD_TOL * scale, err_msg=name)


def test_one_train_step_matches_reference(train_case):
    """Gradients + AdamW on exact params.  Adam's first update is
    lr * g / (|g| + eps), so an element whose gradient is float noise
    around zero (|g| near eps) moves by up to lr in either package: those
    elements are held within lr, every other within OPT_RTOL."""
    jp, batch, _, _, jgrads = train_case
    oc = opt.OptConfig(lr=2e-2, warmup_steps=5, total_steps=60,
                       weight_decay=1e-4, clip_latent=1.5)
    jparams = jax.tree_util.tree_map(jnp.asarray, jp)
    jnew, _, jm = jax.jit(lambda p, g, s: jopt.apply_updates(
        p, g, s, _jax_oc(oc)))(jparams, jgrads, jopt.init_state(jparams))
    params = rn.params_from_numpy(jp, "cpu")
    _, grads = rn.loss_and_grads(_port_cfg(JAX_CFG), params,
                                 _port_batch(batch))
    new, state, m = opt.apply_updates(params, grads, opt.init_state(params),
                                      oc)
    lr = float(jm["lr"])
    np.testing.assert_allclose(float(m["lr"]), lr, rtol=OPT_RTOL)
    for (path, want), got, g in zip(
            jax.tree_util.tree_flatten_with_path(jnew)[0], tree_leaves(new),
            jax.tree_util.tree_leaves(jgrads)):
        want, g = np.asarray(want), np.abs(np.asarray(g))
        real = g > 1e-4 * max(float(g.max()), 1e-30)
        diff = np.abs(got.numpy() - want)
        name = jax.tree_util.keystr(path)
        assert (diff <= lr).all(), name
        np.testing.assert_allclose(got.numpy()[real], want[real],
                                   rtol=OPT_RTOL, atol=OPT_ATOL,
                                   err_msg=name)
    assert int(state["step"]) == 1


def test_loss_and_grads_needs_the_ste_mode(train_case):
    jp, batch, _, _, _ = train_case
    with pytest.raises(ValueError, match="ste"):
        rn.loss_and_grads(_port_cfg(JAX_CFG, conv_mode="packed"),
                          rn.params_from_numpy(jp, "cpu"), _port_batch(batch))

"""The port's LM trainer against the JAX reference, on the CPU.

* ``loss_fn`` of every one of the ten LM archs at ``tiny_config``: the
  loss within ``LOSS_TOL`` and every gradient leaf within ``GRAD_TOL`` of
  its largest element, against ``jax.value_and_grad(api.loss_fn)`` off
  the mesh (the reference's ``build_train_step`` fails under the
  installed jax, ``ROADMAP.md`` caveats), from the same params carried
  across with ``params_from_numpy``; then one AdamW step of both
  packages from that state.  MoE archs route with capacity factor 8, so
  no token is dropped at a capacity edge (``ROADMAP.md`` caveats).
* (``binarize_mlp``, the chunked CE and remat: ``tests/test_torch_losses.py``.)
* The port's own ``test_tiny_lm_loss_decreases`` through
  ``build_train_step``, its donating update, its refusals and
  ``build_serve_steps``.  (The launcher:
  ``tests/test_torch_train_launch.py``.)
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.launch.train as jax_train
from repro.models.api import get_model as jax_get_model
from repro.train import optimizer as jopt
from repro_torch.data.pipeline import SyntheticLM
from repro_torch.launch import steps as steps_mod
from repro_torch.launch import train as train_launch
from repro_torch.models.api import get_model
from repro_torch.train import optimizer as opt
from repro_torch.tree import params_from_numpy, tree_leaves
from tests.test_torch_harness import reduced_torch

LOSS_TOL = 1e-5         # loss: float summation order only
GRAD_TOL = 1e-4         # |g - g_ref| <= GRAD_TOL * max|g_ref| per leaf
OPT_RTOL, OPT_ATOL = 1e-5, 1e-7
HOST = {"data": 1, "model": 1}       # a world of one, no process group
ARCHS = train_launch.ARCH_NAMES
OC = opt.OptConfig(lr=2e-2, warmup_steps=5, total_steps=60)


@pytest.fixture(autouse=True)
def one_thread():
    """One intra-op thread a test: the tiny models gain nothing from
    more, and the tier-1 run's workers share the machine's cores, where
    training loops of several workers spinning their thread pools
    against each other run many times slower."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _configs(arch, **over):
    jc, tc = jax_train.tiny_config(arch), train_launch.tiny_config(arch)
    if jc.family == "moe":
        over = {"capacity_factor": 8.0, **over}
    return jc.scaled(**over), tc.scaled(**over)


def _batch(cfg, b=2, s=32, seed=0):
    rng = np.random.default_rng(seed)
    out = {"tokens": rng.integers(0, cfg.vocab_size, (b, s)).astype(np.int32),
           "labels": rng.integers(0, cfg.vocab_size, (b, s)).astype(np.int32)}
    if cfg.family == "vlm":
        out["vision_embeds"] = (rng.standard_normal(
            (b, cfg.num_vision_tokens, cfg.d_model)) * 0.02).astype(np.float32)
    if cfg.family == "audio":
        out["frame_embeds"] = (rng.standard_normal(
            (b, cfg.encoder_seq, cfg.d_model)) * 0.02).astype(np.float32)
    return out


def _jax_step(jc, oc):
    api = jax_get_model(jc)

    def step(p, batch):
        loss, grads = jax.value_and_grad(
            lambda q: api.loss_fn(jc, q, batch))(p)
        new, _, m = jopt.apply_updates(p, grads, jopt.init_state(p),
                                       jopt.OptConfig(**dataclasses.asdict(oc)))
        return loss, grads, new, m["lr"]
    return jax.jit(step)


def _jax_params(jc):
    return jax.tree_util.tree_map(np.asarray, jax_get_model(jc).init_params(
        jc, jax.random.PRNGKey(0)))


def _reference(jc, oc=OC, jp=None):
    """(numpy params, numpy batch, loss, grads, params after one AdamW
    step, lr) of the reference."""
    jp = _jax_params(jc) if jp is None else jp
    batch = _batch(jc)
    loss, grads, new, lr = _jax_step(jc, oc)(
        jp, {k: jnp.asarray(v) for k, v in batch.items()})
    leaves = lambda t: [np.asarray(x) for x in jax.tree_util.tree_leaves(t)]  # noqa: E731
    return jp, batch, float(loss), leaves(grads), leaves(new), float(lr)


def _port_loss_grads(tc, jp, batch):
    params = params_from_numpy(jp, "cpu")
    tb = {k: torch.from_numpy(v) for k, v in batch.items()}
    loss, grads = steps_mod.value_and_grad(
        lambda p: get_model(tc).loss_fn(tc, p, tb), params)
    return params, float(loss), grads


def _assert_grads(got, want, what=""):
    assert len(got) == len(want), what
    for i, (g, w) in enumerate(zip(got, want)):
        assert g.shape == w.shape, (what, i)
        scale = max(float(np.abs(w).max()), 1e-30)
        np.testing.assert_allclose(g, w, rtol=0, atol=GRAD_TOL * scale,
                                   err_msg=f"{what} leaf {i}")


def _assert_adam_step(got, want, grads, lr):
    """Adam's first update is lr * s g / (s |g| + eps), s the global-norm
    clip's scale: a gradient error d moves it by at most lr * eps * s d /
    (s |g| + eps)^2, and by 2 lr at most (a sign flip of a gradient that
    is float noise around zero).  Each element is held within that
    bound, d = GRAD_TOL x its leaf's largest |g| (what the gradient check
    allows), plus OPT_RTOL of the value for the update's own rounding."""
    norm = np.sqrt(sum(float(np.sum(np.square(g, dtype=np.float64)))
                       for g in grads))
    s = min(1.0, OC.grad_clip / max(norm, 1e-9))
    for i, (p, w, g) in enumerate(zip(got, want, grads)):
        d = GRAD_TOL * float(np.abs(g).max())
        moved = lr * OC.eps * s * d / (s * np.abs(g) + OC.eps) ** 2
        bound = np.minimum(moved, 2 * lr) + OPT_RTOL * np.abs(w) + OPT_ATOL
        assert (np.abs(p - w) <= bound).all(), \
            (i, float(np.max(np.abs(p - w) - bound)))


@pytest.mark.parametrize("arch", ARCHS)
def test_loss_grads_and_one_adamw_step_match_reference(arch):
    jc, tc = _configs(arch)
    jp, batch, jloss, jgrads, jnew, lr = _reference(jc)
    params, loss, grads = _port_loss_grads(tc, jp, batch)
    np.testing.assert_allclose(loss, jloss, rtol=LOSS_TOL)
    _assert_grads([g.numpy() for g in tree_leaves(grads)], jgrads, arch)
    new, state, m = opt.apply_updates(params, grads, opt.init_state(params),
                                      OC)
    np.testing.assert_allclose(float(m["lr"]), lr, rtol=OPT_RTOL)
    _assert_adam_step([p.numpy() for p in tree_leaves(new)], jnew, jgrads,
                      lr)
    assert int(state["step"]) == 1


def test_tiny_lm_loss_decreases():
    """The reference's ``TestTrainLoop::test_tiny_lm_loss_decreases`` on
    the port: overfit one batch through ``build_train_step`` (chunked CE,
    AdamW, state updated in place), the loss falling by more than 2.0 in
    25 steps."""
    cfg = reduced_torch("h2o-danube-1.8b")
    oc = opt.OptConfig(lr=3e-3, warmup_steps=0, total_steps=200,
                       weight_decay=0.0)
    step_fn, _ = steps_mod.build_train_step(cfg, HOST, oc)
    state = steps_mod.init_train_state(
        cfg, HOST, torch.Generator().manual_seed(0), device="cpu")
    data = SyntheticLM(cfg.vocab_size, 8, 64)
    batch = train_launch.to_batch(cfg, data.batch(0), "cpu")
    losses = []
    for _ in range(25):
        state, loss = step_fn(state, batch)
        losses.append(float(loss))
    assert losses[-1] < losses[0] - 2.0, losses
    assert int(state["opt"]["step"]) == 25


def test_donating_step_equals_the_functional_one():
    """``donate`` writes the same numbers into the state's tensors; a
    non-finite loss leaves them as they were."""
    _, cfg = _configs("h2o-danube-1.8b")
    batch = train_launch.to_batch(cfg, _batch(cfg), "cpu")
    outs = []
    for donate in (True, False):
        step_fn, _ = steps_mod.build_train_step(cfg, HOST, OC, donate=donate)
        state = steps_mod.init_train_state(
            cfg, HOST, torch.Generator().manual_seed(3), device="cpu")
        before = tree_leaves(state)
        for _ in range(2):
            state, loss = step_fn(state, batch)
        outs.append((float(loss), [t.clone() for t in tree_leaves(state)]))
        assert all(a is b for a, b in zip(before, tree_leaves(state))) \
            == donate
    assert outs[0][0] == outs[1][0]
    for a, b in zip(outs[0][1], outs[1][1]):
        torch.testing.assert_close(a, b, rtol=0, atol=0)
    step_fn, _ = steps_mod.build_train_step(cfg, HOST, OC)
    state = steps_mod.init_train_state(
        cfg, HOST, torch.Generator().manual_seed(3), device="cpu")
    state["params"]["final_norm"][0] = float("nan")
    snap = [t.clone() for t in tree_leaves(state)]
    new, loss = step_fn(state, batch)
    assert not np.isfinite(float(loss)) and new is state
    for a, b in zip(tree_leaves(state), snap):
        torch.testing.assert_close(a, b, rtol=0, atol=0, equal_nan=True)


def test_build_train_step_refusals():
    cfg = train_launch.tiny_config("gemma2-2b")
    with pytest.raises(ValueError, match="build_compressed_dp_train_step"):
        steps_mod.build_train_step(cfg, HOST, grad_compression="onebit")
    with pytest.raises(NotImplementedError, match="Queue 1 item 5a"):
        steps_mod.build_train_step(cfg, {"data": 2, "model": 1})


def test_serve_steps_run_the_model_api():
    cfg = train_launch.tiny_config("minitron-8b")
    prefill, decode, (pspec, _), (cspec, cshard) = \
        steps_mod.build_serve_steps(cfg, HOST, 2, 16)
    api = get_model(cfg)
    params = api.init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    assert [p.shape for p in tree_leaves(pspec)] == \
        [p.shape for p in tree_leaves(params)]
    cache = api.init_cache(cfg, 2, 16, "cpu")
    tokens = torch.randint(0, cfg.vocab_size, (2, 5),
                           generator=torch.Generator().manual_seed(1))
    logits, cache = prefill(params, tokens, cache)
    nxt = logits.argmax(-1)
    step_logits, _ = decode(params, cache, nxt, 5)
    ref_cache = api.init_cache(cfg, 2, 16, "cpu")
    ref, ref_cache = api.prefill(cfg, params, tokens, ref_cache)
    want, _ = api.decode_step(cfg, params, ref_cache, nxt, 5)
    torch.testing.assert_close(step_logits, want, rtol=0, atol=0)
    assert {s.spec[0] for s in tree_leaves(cshard)} == {"data"}

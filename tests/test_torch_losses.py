"""The port's losses against the JAX reference, on the CPU.

* ``binarize_mlp=True`` on a dense arch: the loss and every gradient
  leaf against ``jax.value_and_grad(api.loss_fn)``, through the STE of
  ``binary_linear``.
* ``chunked_cross_entropy`` against the full CE and the reference's
  (loss and the gradients of the hidden and the head), and
  ``cross_entropy`` against the reference's.
* ``cfg.remat`` on against off: the same loss and gradients, bit for bit.

Tolerances are ``tests/test_torch_lm_train.py``'s.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import layers as jlayers
from repro_torch.models import layers
from repro_torch.tree import tree_leaves
from tests.test_torch_harness import unit_scale_mlp
from tests.test_torch_lm_train import (  # noqa: F401
    LOSS_TOL, _assert_grads, _batch, _configs, _jax_params, _port_loss_grads,
    _reference, one_thread)


def test_binarized_mlp_trains_through_the_ste():
    """A dense arch with ``binarize_mlp``: the MLP weights' gradients
    come through ``_SteSign`` (zero where |w| > 1) and the activations'
    sign passes none, as in the reference, so ``down`` trains and ``up``
    gets zeros.  Unit-scale (+-1) MLP weights, so
    every binarised product is an exact integer in both packages
    (``test_torch_harness.unit_scale_mlp``)."""
    jc, tc = _configs("minitron-8b", binarize_mlp=True)
    jp, batch, jloss, jgrads, _, _ = _reference(
        jc, jp=unit_scale_mlp(_jax_params(jc)))
    _, loss, grads = _port_loss_grads(tc, jp, batch)
    np.testing.assert_allclose(loss, jloss, rtol=LOSS_TOL)
    _assert_grads([g.numpy() for g in tree_leaves(grads)], jgrads)
    mlp = grads["scan"]["b0"]["mlp"]
    assert float(mlp["down"].abs().max()) > 0
    assert float(mlp["up"].abs().max()) == 0.0


@pytest.mark.parametrize("chunk", [4, 12, 256])
@pytest.mark.parametrize("cap", [0.0, 3.0])
def test_chunked_ce_equals_full_ce_and_reference(chunk, cap):
    """gcd(S, chunk) chunks: 4 -> 6 chunks of 4, 12 -> 2 of 12, 256 -> 1
    of 24; the softcap before logsumexp; the head's gradient summed over
    the chunks."""
    rng = np.random.default_rng(1)
    x = rng.standard_normal((2, 24, 16)).astype(np.float32)
    head = rng.standard_normal((16, 40)).astype(np.float32)
    labels = rng.integers(0, 40, (2, 24)).astype(np.int32)
    tx = torch.from_numpy(x).requires_grad_(True)
    th = torch.from_numpy(head).requires_grad_(True)
    tl = torch.from_numpy(labels)
    got = layers.chunked_cross_entropy(tx, th, tl, softcap_val=cap,
                                       chunk=chunk)
    gx, gh = torch.autograd.grad(got, (tx, th))
    full = layers.cross_entropy(layers.softcap(tx @ th, cap), tl)
    fx, fh = torch.autograd.grad(full, (tx, th))
    want, (jx, jh) = jax.value_and_grad(
        lambda a, b: jlayers.chunked_cross_entropy(
            a, b, jnp.asarray(labels), softcap_val=cap, chunk=chunk),
        argnums=(0, 1))(jnp.asarray(x), jnp.asarray(head))
    got, full = float(got.detach()), float(full.detach())
    np.testing.assert_allclose(got, full, rtol=LOSS_TOL)
    np.testing.assert_allclose(got, float(want), rtol=LOSS_TOL)
    for a, b, c in ((gx, fx, jx), (gh, fh, jh)):
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=1e-5,
                                   atol=1e-7)
        np.testing.assert_allclose(a.numpy(), np.asarray(c), rtol=1e-5,
                                   atol=1e-7)


def test_cross_entropy_matches_reference():
    rng = np.random.default_rng(2)
    logits = rng.standard_normal((3, 5, 17)).astype(np.float32)
    labels = rng.integers(0, 17, (3, 5)).astype(np.int32)
    got = layers.cross_entropy(torch.from_numpy(logits),
                               torch.from_numpy(labels))
    want = jlayers.cross_entropy(jnp.asarray(logits), jnp.asarray(labels))
    np.testing.assert_allclose(float(got), float(want), rtol=LOSS_TOL)


@pytest.mark.parametrize("arch", ["gemma2-2b", "whisper-large-v3"])
def test_remat_on_and_off_are_bit_identical(arch):
    """Recomputing each scan repeat (and each encoder/decoder layer) in
    the backward gives the same loss and gradients to the bit."""
    jc, tc = _configs(arch)
    jp = _jax_params(jc)
    batch = _batch(tc)
    outs = []
    for remat in (True, False):
        cfg = tc.scaled(remat=remat)
        _, loss, grads = _port_loss_grads(cfg, jp, batch)
        outs.append((loss, [g.numpy() for g in tree_leaves(grads)]))
    assert outs[0][0] == outs[1][0]
    for a, b in zip(outs[0][1], outs[1][1]):
        np.testing.assert_array_equal(a, b)

"""The JAX reference's Pallas kernels under the installed jax.

The reference pins ``jax<0.5`` (``requirements.txt``), whose Pallas TPU
module names its compiler-params class ``TPUCompilerParams``; later jax
calls it ``CompilerParams`` and has dropped the old name, so the
reference's ``paged_mixed_attention``, ``binary_contraction`` and
``fused_decode_matmul`` raise while they trace.  Importing this module
gives the old name back for the rest of the test process.  Pytest imports
every test module while it collects, in every xdist worker, so the
reference's Pallas paths run interpreted in every test process whichever
files share it.  Scoped to single tests, the alias decided JAX tests by
the schedule instead: a JAX test of those paths passed only where a port
test on the same worker had traced the same shapes under the alias and
left them in jax's jit cache.  No file of the reference changes.

The tests hold the reference's kernel, run interpreted through the alias,
to the port's plain version on the same ragged pages (f32, atol 1e-5,
rtol 1e-4: both compute in f32 and differ only in summation order).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from repro.kernels import paged_attention as jax_paged
from repro_torch.kernels.paged_attention import paged_mixed_attention
from tests.test_torch_paged_attention import paged_case

if not hasattr(pltpu, "TPUCompilerParams"):
    pltpu.TPUCompilerParams = pltpu.CompilerParams

ATOL, RTOL = 1e-5, 1e-4


def test_old_compiler_params_name_is_the_installed_class():
    assert pltpu.TPUCompilerParams is pltpu.CompilerParams


@pytest.mark.parametrize("window,q_block", [(0, 0), (3, 0), (0, 2)])
def test_reference_kernel_interpreted_matches_the_port(window, q_block):
    """A chunk row, a decode row and a free row in one ragged block."""
    c = paged_case(5, qn=4, q_lens=[4, 1, 0], lengths=[9, 6, 0])
    d = c["q"].shape[-1]
    want = np.asarray(jax_paged.paged_mixed_attention(
        jnp.asarray(c["q"]) * d ** -0.5, jnp.asarray(c["k"]),
        jnp.asarray(c["v"]), jnp.asarray(c["table"]),
        jnp.asarray(c["lengths"]), jnp.asarray(c["q_lens"]),
        window=window, q_block=q_block, page_size=c["logical"],
        interpret=True))
    got = paged_mixed_attention(
        torch.from_numpy(c["q"]) * d ** -0.5, torch.from_numpy(c["k"]),
        torch.from_numpy(c["v"]), torch.from_numpy(c["table"]),
        torch.from_numpy(c["lengths"]), torch.from_numpy(c["q_lens"]),
        window=window, page_size=c["logical"]).numpy()
    for s, n in enumerate(c["q_lens"]):
        np.testing.assert_allclose(got[s, :n], want[s, :n],
                                   atol=ATOL, rtol=RTOL)

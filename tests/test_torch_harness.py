"""Shared helpers of the ``repro_torch`` parity tests, and the import-
isolation check of the port.

The same numpy-seeded inputs go through the JAX reference and the port:
``jax_params`` draws the reference's ``init_params`` tree as numpy, and
``torch_params`` carries it across leaf for leaf with the port's
``params_from_numpy``.  ``reduced_torch`` is the port's twin of
``tests/test_models.py::reduced``.
"""

import functools
import os
import subprocess
import sys

import jax
import numpy as np

from repro.configs.base import get_config as get_jax_config
from repro.models.api import get_model
from repro_torch.configs.base import get_config as get_torch_config
from repro_torch.models.transformer import params_from_numpy
from tests.test_models import REDUCED

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def reduced_jax(name):
    return get_jax_config(name).scaled(dtype="float32", vocab_size=128,
                                       **REDUCED[name])


def reduced_torch(name):
    return get_torch_config(name).scaled(dtype="float32", vocab_size=128,
                                         **REDUCED[name])


def jax_params(cfg, seed=0):
    """The reference's init_params tree, leaves as numpy arrays."""
    return jax.tree_util.tree_map(
        np.asarray, get_model(cfg).init_params(cfg, jax.random.PRNGKey(seed)))


def torch_params(tree):
    """The same tree as port params on the CPU."""
    return params_from_numpy(tree, "cpu")


def jitted(fn, cfg, **static):
    """The reference's step function ``fn(cfg, *args, **static)`` under
    one ``jax.jit``.  Called eagerly it compiles every primitive shape by
    shape, seconds a call at the reduced widths; the values are the same
    function's (the tests hold the port to them within their tolerance)."""
    return jax.jit(functools.partial(fn, cfg, **static))


def unit_scale_mlp(tree):
    """``tree`` with every MLP matrix replaced by its signs (+-1).

    A binarised MLP unit sums K terms +-alpha; when they cancel exactly,
    the float result is rounding noise whose sign depends on the dot's
    summation order — XLA's and the port's BLAS differ, and so would the
    next layer's binarised input.  With unit scale (alpha = 1) every
    partial sum is an exact integer in any order, so both packages compute
    the compressed model exactly and their tokens are comparable."""
    def visit(path, leaf):
        name = jax.tree_util.keystr(path)
        if "'mlp'" in name:
            return np.where(leaf >= 0, 1.0, -1.0).astype(leaf.dtype)
        return leaf

    return jax.tree_util.tree_map_with_path(visit, tree)


_ISOLATION_PROBE = r"""
import importlib, pkgutil, sys
sys.path.insert(0, "src")
import repro_torch
names = [m.name for m in pkgutil.walk_packages(repro_torch.__path__,
                                               "repro_torch.")]
for name in names:
    importlib.import_module(name)
spec = importlib.util.spec_from_file_location("chip_smoke", "chip_smoke.py")
spec.loader.exec_module(importlib.util.module_from_spec(spec))
bad = sorted(m for m in sys.modules
             if m == "jax" or m.startswith("jax.") or m == "repro"
             or m.startswith("repro."))
print(" ".join(names), "|", bad)
assert not bad, bad
"""

# modules of each slice of the port that the probe must reach
_PORT_MODULES = {
    "repro_torch.kernels.huffman_decode", "repro_torch.kernels.paged_attention",
    "repro_torch.runtime.weight_store", "repro_torch.models.transformer",
    "repro_torch.kernels.binarize_pack", "repro_torch.kernels.binary_contraction",
    "repro_torch.kernels.fused_decode_contraction", "repro_torch.kernels.ops",
    "repro_torch.models.reactnet", "repro_torch.configs.reactnet",
    "repro_torch.kernels.kv_codec", "repro_torch.models.moe",
    "repro_torch.configs.deepseek_v2_236b", "repro_torch.models.attention",
    "repro_torch.models.api", "repro_torch.runtime.scheduler",
    "repro_torch.runtime.metrics", "repro_torch.launch.serve",
    "repro_torch.configs.phi3_medium_14b", "repro_torch.configs.h2o_danube_1_8b",
    "repro_torch.configs.gemma2_2b", "repro_torch.configs.mixtral_8x22b",
    "repro_torch.runtime.prefix_index", "repro_torch.runtime.drafter",
    "repro_torch.runtime.autotune", "repro_torch.runtime.telemetry",
    "repro_torch.data.pipeline", "repro_torch.train.optimizer",
    "repro_torch.ckpt.checkpoint", "repro_torch.models.ssm",
    "repro_torch.models.rglru", "repro_torch.models.encdec",
    "repro_torch.configs.mamba2_780m", "repro_torch.configs.recurrentgemma_2b",
    "repro_torch.configs.paligemma_3b", "repro_torch.configs.whisper_large_v3",
    "repro_torch.dist", "repro_torch.dist.sharding",
    "repro_torch.dist.compression_comm", "repro_torch.dist.fault",
    "repro_torch.launch.mesh", "repro_torch.launch.steps",
    "repro_torch.launch.train",
}


def test_port_imports_neither_jax_nor_repro():
    """A fresh interpreter imports every repro_torch module and
    chip_smoke.py (without running it); neither jax nor any repro module
    may be loaded."""
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run([sys.executable, "-c", _ISOLATION_PROBE], cwd=ROOT,
                         env=env, capture_output=True, text=True,
                         timeout=120)
    assert out.returncode == 0, out.stdout + out.stderr
    names, bad = out.stdout.split("|")
    assert _PORT_MODULES <= set(names.split()) and len(names.split()) >= 55
    assert bad.strip() == "[]", out.stdout

"""The port's distribution layer (``repro_torch.dist``,
``launch.mesh``, sharded ``ckpt.restore``) against ``repro.dist``, on the
CPU.

* The sharding rules: every parameter of every arch at its published
  size (meta tensors), on the production meshes and a small one, with
  and without FSDP, against ``repro.dist.sharding.param_spec`` through
  the ``FakeMesh`` of ``tests/test_dist.py``; ``safe_spec`` and the
  batch and cache specs the same way; the DTensor placements a spec
  gives; ``train_state_specs`` (meta tensors) against the reference's.
* ``compress_grads`` at one rank (a ``gloo`` world of one, as
  ``make_host_mesh`` starts it) against the reference's ``shard_map`` on
  one device, both modes, within ``COMM_TOL``; the reference's
  error-feedback convergence test; ``build_compressed_dp_train_step``
  at one rank against the reference's on a linear model.
* ``Supervisor``'s three fault tests, a checkpoint resume, and ``remesh``
  / ``restore(shardings=)`` at one rank.
* One spawned two-rank ``gloo`` run (``FileStore`` rendezvous, loopback
  transport, a hard timeout): ``compress_grads`` against the numpy
  formula, the compressed DP step keeping the replicas equal, and
  sharded restores whose local shards are slices of the saved arrays.
"""

import os
import subprocess
import sys
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as P

from repro.dist import compression_comm as jcomm
from repro.dist import fault as jfault
from repro.dist import sharding as jshd
from repro.launch import steps as jsteps
from repro.launch.mesh import make_host_mesh as jax_host_mesh
from repro.train import optimizer as jopt
from repro_torch.ckpt import checkpoint as ckpt
from repro_torch.configs.base import get_config
from repro_torch.dist import compression_comm as comm
from repro_torch.dist import sharding as shd
from repro_torch.dist.fault import FaultConfig, Supervisor, remesh
from repro_torch.launch import mesh as mesh_mod
from repro_torch.launch import steps as steps_mod
from repro_torch.launch.train import ARCH_NAMES
from repro_torch.models.api import get_model
from repro_torch.train import optimizer as opt
from repro_torch.tree import tree_leaves, tree_map_with_path
from tests.test_dist import FakeMesh
from tests.test_torch_harness import ROOT
from tests.test_torch_lm_train import one_thread  # noqa: F401

COMM_TOL = 1e-6         # the same f32 formulas; means summed in their order
TWO_RANK_TIMEOUT = 120  # s: a hung collective fails the test

MESHES = {"16x16": {"data": 16, "model": 16},
          "pod": {"pod": 2, "data": 16, "model": 16},
          "4x2": {"data": 4, "model": 2}}


@pytest.fixture(scope="module")
def world1():
    """A ``gloo`` world of one rank, as ``make_host_mesh`` starts it."""
    mesh = mesh_mod.make_host_mesh(device="cpu")
    yield mesh
    torch.distributed.destroy_process_group()


# --- sharding rules ------------------------------------------------------

@pytest.mark.parametrize("arch", ARCH_NAMES)
def test_param_specs_match_reference(arch):
    cfg = get_config(arch)
    params = get_model(cfg).init_params(cfg, None, "meta")
    names = []
    tree_map_with_path(lambda path, leaf: names.append(
        (path, tuple(leaf.shape))), params)
    for sizes in MESHES.values():
        fake = FakeMesh(sizes)
        for fsdp in (False, True):
            for path, shape in names:
                want = tuple(jshd.param_spec(path, shape, fake, fsdp=fsdp))
                assert shd.param_spec(path, shape, sizes, fsdp=fsdp) == want
                assert shd.param_spec(path, shape, fake, fsdp=fsdp) == want
    got = shd.params_shardings(params, MESHES["16x16"], fsdp=True)
    assert [s.spec for s in tree_leaves(got)] == [
        tuple(jshd.param_spec(p, s, FakeMesh(MESHES["16x16"]), fsdp=True))
        for p, s in names]


@pytest.mark.parametrize("arch", ["gemma2-2b", "deepseek-v2-236b"])
def test_train_state_specs_match_reference_without_allocating(arch):
    """Full-size configs: meta tensors of the reference's shapes and
    dtypes, and its specs leaf for leaf on the host mesh."""
    from repro.configs.base import get_config as jax_config
    jc, tc = jax_config(arch), get_config(arch)
    mesh = jax_host_mesh()
    with jshd.use_mesh(mesh):
        (jp, jps), (jo, jos) = jsteps.train_state_specs(jc, mesh)
    (tp, tps), (to, tos) = steps_mod.train_state_specs(
        tc, {"data": 1, "model": 1})
    for want, got in ((jp, tp), (jo, to)):
        wl = jax.tree_util.tree_leaves(want)
        gl = tree_leaves(got)
        assert [tuple(w.shape) for w in wl] == [tuple(g.shape) for g in gl]
        assert [str(w.dtype) for w in wl] == \
            [str(g.dtype).replace("torch.", "") for g in gl]
        assert all(g.device.type == "meta" for g in gl)
    for want, got in ((jps, tps), (jos, tos)):
        assert [tuple(s.spec) for s in jax.tree_util.tree_leaves(want)] == \
            [s.spec for s in tree_leaves(got)]


@pytest.mark.parametrize("shape,axes", [
    ((1, 1, 51866), ("batch", None, "model")),
    ((32, 7, 256000), ("batch", None, "model")),
    ((64, 16), (("batch", "model"),)),
    ((3,), ("batch",)), ((), ()),
    ((512, 8, 4, 128), ("batch", "nope", "model", None))])
@pytest.mark.parametrize("mesh", sorted(MESHES))
def test_safe_spec_matches_reference(shape, axes, mesh):
    sizes = MESHES[mesh]
    want = tuple(jshd.safe_spec(FakeMesh(sizes), shape, *axes))
    assert shd.safe_spec(sizes, shape, *axes) == want
    assert shd.dp_axes(sizes) == jshd.dp_axes(FakeMesh(sizes))
    assert shd.batch_axes(sizes) == jshd.batch_axes(FakeMesh(sizes))


@pytest.mark.parametrize("mesh", sorted(MESHES))
def test_batch_and_cache_specs_match_reference(mesh):
    sizes = MESHES[mesh]
    cfg = get_config("gemma2-2b")
    cache = get_model(cfg).init_cache_specs(cfg, 32, 64)
    batch = {"tokens": torch.empty((32, 64), device="meta"),
             "pos": torch.empty((), device="meta")}
    for tree, fn in ((batch, shd.batch_shardings),
                     (cache, shd.cache_shardings)):
        for leaf, got in zip(tree_leaves(tree), tree_leaves(fn(tree, sizes))):
            shape = tuple(leaf.shape)
            want = tuple(jshd.safe_spec(FakeMesh(sizes), shape, "batch")) \
                if shape else ()
            assert got.spec == want


def test_placements_follow_the_spec():
    from torch.distributed.tensor import Replicate, Shard
    sizes = MESHES["pod"]
    ns = shd.NamedSharding(sizes, shd.param_spec(
        "prefix/0/attn/wq", (2304, 2048), sizes, fsdp=True))
    assert ns.spec == (("pod", "data"), "model")
    assert ns.placements == (Shard(0), Shard(0), Shard(1))
    assert shd.NamedSharding(sizes, ()).placements == (Replicate(),) * 3
    assert shd.path_name(("scan", "b0", 3, "wq")) == "scan/b0/3/wq"
    x = torch.ones(2)
    assert shd.constrain(x, "batch") is x


def test_meshes(world1):
    assert world1.mesh_dim_names == ("data", "model")
    assert tuple(world1.shape) == (1, 1)
    assert mesh_mod.make_host_mesh(device="cpu").shape == world1.shape
    with pytest.raises(RuntimeError, match="needs 256 ranks"):
        mesh_mod.make_production_mesh(device="cpu")
    with pytest.raises(RuntimeError, match="needs 512 ranks"):
        mesh_mod.make_production_mesh(multi_pod=True, device="cpu")


# --- compressed gradient exchange ---------------------------------------

def _grads(seed=0):
    rng = np.random.default_rng(seed)
    return {"w": rng.standard_normal((64, 32)).astype(np.float32),
            "b": rng.standard_normal((7,)).astype(np.float32) * 1e-3}


@pytest.mark.parametrize("mode", ["onebit", "int8"])
def test_compress_grads_matches_reference_shard_map(mode, world1):
    from jax.experimental.shard_map import shard_map
    g, ef = _grads(0), {k: v * 0.1 for k, v in _grads(1).items()}
    specs = jax.tree_util.tree_map(lambda _: P(), g)
    want, want_ef = shard_map(
        lambda a, b: jcomm.compress_grads(a, b, ("data",), mode=mode),
        mesh=jax_host_mesh(), in_specs=(specs, specs),
        out_specs=(specs, specs), check_rep=False)(
        jax.tree_util.tree_map(jnp.asarray, g),
        jax.tree_util.tree_map(jnp.asarray, ef))
    to_t = lambda t: {k: torch.from_numpy(v) for k, v in t.items()}  # noqa: E731
    for group in (None, world1.get_group("data")):
        got, got_ef = comm.compress_grads(to_t(g), to_t(ef), group,
                                          mode=mode)
        for k in g:
            np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]),
                                       rtol=COMM_TOL, atol=0)
            np.testing.assert_allclose(got_ef[k].numpy(),
                                       np.asarray(want_ef[k]),
                                       rtol=COMM_TOL, atol=COMM_TOL)
            np.testing.assert_allclose((got[k] + got_ef[k]).numpy(),
                                       g[k] + ef[k], rtol=1e-5, atol=1e-6)


def test_error_feedback_converges(world1):
    """The reference's test: repeated 1-bit compression of a constant
    gradient recovers it on average wherever its magnitude fits under
    the emitted scale."""
    g = torch.from_numpy(np.random.default_rng(1)
                         .standard_normal(4096).astype(np.float32))
    ef = comm.init_error_feedback({"g": g})["g"]
    acc = torch.zeros_like(g)
    for _ in range(60):
        out, ef = comm.onebit_allreduce(g, ef)
        acc = acc + out
    got, want = (acc / 60).numpy(), g.numpy()
    mask = np.abs(want) <= 1.0
    assert mask.mean() > 0.5
    np.testing.assert_allclose(got[mask], want[mask], atol=0.15)


def _linear_case():
    rng = np.random.default_rng(5)
    params = {"w": rng.standard_normal((8, 4)).astype(np.float32),
              "b": rng.standard_normal((4,)).astype(np.float32)}
    batch = {"x": rng.standard_normal((6, 8)).astype(np.float32),
             "y": rng.standard_normal((6, 4)).astype(np.float32)}
    return params, batch


def _linear_loss(p, b):
    return ((b["x"] @ p["w"] + p["b"] - b["y"]) ** 2).mean()


@pytest.mark.parametrize("mode", ["onebit", "int8"])
def test_compressed_dp_step_matches_reference(mode, world1):
    params, batch = _linear_case()
    oc = opt.OptConfig(lr=1e-2, warmup_steps=0, total_steps=10)
    jmesh = jax_host_mesh()
    jstep, _ = jsteps.build_compressed_dp_train_step(
        _linear_loss, jmesh, jopt.OptConfig(lr=1e-2, warmup_steps=0,
                                            total_steps=10), mode=mode)
    step, sharding = steps_mod.build_compressed_dp_train_step(
        _linear_loss, world1, oc, mode=mode)
    assert sharding.spec == () and all(
        p.is_replicate() for p in sharding.placements)
    jp = jax.tree_util.tree_map(jnp.asarray, params)
    jstate = {"params": jp, "opt": jopt.init_state(jp),
              "ef": jcomm.init_error_feedback(jp)}
    tp = {k: torch.from_numpy(v) for k, v in params.items()}
    state = {"params": tp, "opt": opt.init_state(tp),
             "ef": comm.init_error_feedback(tp)}
    tb = {k: torch.from_numpy(v) for k, v in batch.items()}
    for _ in range(3):
        jstate, jloss = jstep(jstate, jax.tree_util.tree_map(jnp.asarray,
                                                             batch))
        state, loss = step(state, tb)
        np.testing.assert_allclose(float(loss), float(jloss), rtol=1e-5)
    for key in ("params", "ef"):
        for got, want in zip(tree_leaves(state[key]),
                             jax.tree_util.tree_leaves(jstate[key])):
            np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                       rtol=1e-5, atol=1e-6)


# --- fault tolerance and checkpoints ------------------------------------

def test_bad_step_containment():
    sup = Supervisor(FaultConfig(max_consecutive_bad=3))
    state = {"w": torch.zeros(2)}

    def step_fn(s, b):
        return {"w": s["w"] + 1}, torch.tensor(np.nan if b["bad"] else 1.0)

    state, rep = sup.run_step(step_fn, state, {"bad": True}, 0)
    assert rep.skipped and float(state["w"][0]) == 0.0   # update dropped
    state, rep = sup.run_step(step_fn, state, {"bad": False}, 1)
    assert not rep.skipped and float(state["w"][0]) == 1.0


def test_consecutive_bad_aborts():
    sup = Supervisor(FaultConfig(max_consecutive_bad=2))
    step_fn = lambda s, b: (s, torch.tensor(np.nan))  # noqa: E731
    state, _ = sup.run_step(step_fn, {}, {}, 0)
    with pytest.raises(RuntimeError, match="consecutive bad"):
        sup.run_step(step_fn, state, {}, 1)


def test_straggler_detection():
    sup = Supervisor(FaultConfig(straggler_factor=3.0))
    fast = lambda s, b: (s, torch.tensor(1.0))  # noqa: E731

    def slow(s, b):
        time.sleep(0.25)
        return s, torch.tensor(1.0)

    state = {}
    for i in range(6):
        state, rep = sup.run_step(fast, state, {}, i)
    state, rep = sup.run_step(slow, state, {}, 6)
    assert rep.straggler and any("straggler" in e for e in sup.events)


def _tree(seed=0):
    rng = np.random.default_rng(seed)
    return {"params": {"embed": torch.from_numpy(
        rng.standard_normal((8, 6)).astype(np.float32)),
        "scan": {"b0": {"attn": {"wq": torch.from_numpy(
            rng.standard_normal((2, 6, 4)).astype(np.float32))}}},
        "final_norm": torch.zeros(6)},
        "opt": {"step": torch.tensor(7, dtype=torch.int32)}}


def test_checkpoint_resume_through_the_supervisor(tmp_path):
    """Saves every 2 steps (async), then a new Supervisor resumes after
    the newest, on the state's device, and ``finalize`` writes the last;
    the JAX package restores what the port wrote."""
    from repro.ckpt import checkpoint as jckpt
    cfg = FaultConfig(ckpt_dir=str(tmp_path), ckpt_every=2)
    sup = Supervisor(cfg)
    state = _tree()
    fresh, start = sup.maybe_restore(state)
    assert fresh is state and start == 0
    for step in range(5):
        state = {"params": {k: v for k, v in state["params"].items()},
                 "opt": {"step": torch.tensor(step, dtype=torch.int32)}}
        sup.maybe_save(state, step)
    sup._join()
    again = Supervisor(cfg)
    restored, start = again.maybe_restore(_tree(1))
    assert start == 5 and int(restored["opt"]["step"]) == 4
    assert again.events == ["restored checkpoint at step 4"]
    for a, b in zip(tree_leaves(restored), tree_leaves(state)):
        torch.testing.assert_close(a, b, rtol=0, atol=0)
    sup.finalize(state, 9)
    assert ckpt.latest_step(str(tmp_path)) == 9
    like = jax.tree_util.tree_map(lambda t: np.asarray(t), _tree())
    jrest, jstep = jckpt.restore(str(tmp_path), like)
    assert jstep == 9
    np.testing.assert_array_equal(np.asarray(jrest["params"]["embed"]),
                                  state["params"]["embed"].numpy())


def test_bf16_state_resumes_through_the_supervisor(tmp_path):
    """A tiny gemma2 in bf16 trains two supervised steps of
    ``build_train_step`` with a checkpoint each step; a new Supervisor
    restores the state bit for bit in its dtypes (bf16 params), and the
    next step from it equals the next step from the live state, loss and
    updated state bit for bit."""
    from repro_torch.launch.train import tiny_config, to_batch
    from repro_torch.data.pipeline import SyntheticLM
    cfg = tiny_config("gemma2-2b").scaled(dtype="bfloat16")
    oc = opt.OptConfig(lr=1e-2, warmup_steps=0, total_steps=4)
    step_fn, _ = steps_mod.build_train_step(cfg, {"data": 1, "model": 1}, oc)
    state = steps_mod.init_train_state(cfg, None,
                                       torch.Generator().manual_seed(0),
                                       device="cpu")
    assert tree_leaves(state["params"])[0].dtype == torch.bfloat16
    data = SyntheticLM(cfg.vocab_size, 2, 16, seed=0)
    sup = Supervisor(FaultConfig(ckpt_dir=str(tmp_path), ckpt_every=1))
    for step in range(3):
        state, rep = sup.run_step(step_fn, state,
                                  to_batch(cfg, data.batch(step), "cpu"), step)
        assert not rep.skipped
        sup.maybe_save(state, step)
    sup._join()
    like = steps_mod.init_train_state(cfg, None,
                                      torch.Generator().manual_seed(1),
                                      device="cpu")
    restored, start = Supervisor(sup.cfg).maybe_restore(like)
    assert start == 3
    for a, b in zip(tree_leaves(restored), tree_leaves(state)):
        assert a.dtype == b.dtype and torch.equal(a, b)
    batch = to_batch(cfg, data.batch(3), "cpu")
    state, want = step_fn(state, batch)
    restored, got = step_fn(restored, batch)
    assert float(got) == float(want)
    for a, b in zip(tree_leaves(restored), tree_leaves(state)):
        assert torch.equal(a, b)


def test_restore_with_shardings_and_remesh(tmp_path, world1):
    """At one rank every shard is the whole array; ``remesh`` rebuilds
    the shardings for the mesh it is given; the reference's remesh reads
    the same files."""
    t = _tree()
    ckpt.save(t, str(tmp_path), step=3)
    like = {"params": {k: torch.empty_like(v, device="meta")
                       for k, v in t["params"].items() if k != "scan"},
            "opt": t["opt"]}
    like["params"]["scan"] = {"b0": {"attn": {"wq": torch.empty(
        (2, 6, 4), device="meta")}}}
    restored, step = ckpt.restore(
        str(tmp_path), like,
        shardings=shd.params_shardings(like, world1, fsdp=True))
    assert step == 3
    from torch.distributed.tensor import DTensor
    for got, want in zip(tree_leaves(restored), tree_leaves(t)):
        assert isinstance(got, DTensor) and got.dtype == want.dtype
        torch.testing.assert_close(got.to_local(), want, rtol=0, atol=0)
    seen = []

    def shardings_fn(tree, mesh):
        seen.append(mesh)
        return shd.params_shardings(tree, mesh)

    again, step = remesh(str(tmp_path), like, world1, shardings_fn)
    assert step == 3 and seen == [world1]
    torch.testing.assert_close(again["params"]["embed"].full_tensor(),
                               t["params"]["embed"], rtol=0, atol=0)
    jrest, _ = jfault.remesh(
        str(tmp_path), jax.tree_util.tree_map(np.asarray, t),
        jax_host_mesh(), lambda tree, m: jax.tree_util.tree_map(
            lambda _: jax.sharding.NamedSharding(m, P()), tree))
    np.testing.assert_array_equal(
        np.asarray(jrest["params"]["scan"]["b0"]["attn"]["wq"]),
        t["params"]["scan"]["b0"]["attn"]["wq"].numpy())


# --- two ranks -----------------------------------------------------------

_TWO_RANKS = r"""
import sys
import numpy as np
import torch
import torch.distributed as dist

sys.path.insert(0, "src")
rank, world, store, ckdir = (int(sys.argv[1]), int(sys.argv[2]),
                             sys.argv[3], sys.argv[4])
dist.init_process_group("gloo", store=dist.FileStore(store, world),
                        rank=rank, world_size=world)
from repro_torch.ckpt import checkpoint as ckpt
from repro_torch.dist import sharding as shd
from repro_torch.dist.compression_comm import compress_grads
from repro_torch.dist.fault import remesh
from repro_torch.launch import steps
from repro_torch.launch.mesh import make_host_mesh
from repro_torch.train import optimizer as opt
from repro_torch.tree import tree_map_with_path


def grads(r):
    rng = np.random.default_rng(10 + r)
    return {"w": rng.standard_normal((64, 32)).astype(np.float32),
            "b": rng.standard_normal((5,)).astype(np.float32)}


def feedback(r):
    return {k: v * 0.25 for k, v in grads(100 + r).items()}


to_t = lambda t: {k: torch.from_numpy(v) for k, v in t.items()}
for mode in ("onebit", "int8"):
    out, ef = compress_grads(to_t(grads(rank)), to_t(feedback(rank)),
                             mode=mode)
    for k in ("w", "b"):
        v = [grads(r)[k] + feedback(r)[k] for r in range(world)]
        if mode == "onebit":
            scale = max(np.mean([np.abs(x).mean() for x in v]), 1e-12)
            levels = [np.sign(x) for x in v]
        else:
            scale = max(max(np.abs(x).max() for x in v) / 127.0, 1e-12)
            levels = [np.clip(np.round(x / scale), -127, 127) for x in v]
        want = np.mean(levels, axis=0) * scale
        np.testing.assert_allclose(out[k].numpy(), want, rtol=1e-6,
                                   atol=1e-7)
        np.testing.assert_allclose(ef[k].numpy(),
                                   v[rank] - levels[rank] * scale,
                                   rtol=1e-6, atol=1e-7)

# the compressed DP step: each rank takes its rows; replicas stay equal
rng = np.random.default_rng(5)
params = to_t({"w": rng.standard_normal((8, 4)).astype(np.float32)})
batch = to_t({"x": rng.standard_normal((6, 8)).astype(np.float32),
              "y": rng.standard_normal((6, 4)).astype(np.float32)})
loss_fn = lambda p, b: ((b["x"] @ p["w"] - b["y"]) ** 2).mean()
dp = make_host_mesh(device="cpu")
step, _ = steps.build_compressed_dp_train_step(
    loss_fn, dp, opt.OptConfig(lr=1e-2, warmup_steps=0), mode="onebit")
state = {"params": params, "opt": opt.init_state(params),
         "ef": {"w": torch.zeros(8, 4)}}
local = [float(loss_fn(params, {k: v[3 * r:3 * (r + 1)]
                                for k, v in batch.items()}))
         for r in range(world)]
for i in range(3):
    state, loss = step(state, batch)
    if i == 0:
        np.testing.assert_allclose(float(loss), np.mean(local), rtol=1e-6)
try:                                    # the reference's shard_map refuses
    step(state, {k: v[:5] for k, v in batch.items()})
    raise AssertionError("5 rows were split over 2 ranks")
except ValueError as e:
    assert "do not split over 2" in str(e), e
w = state["params"]["w"].clone()
gathered = [torch.empty_like(w) for _ in range(world)]
dist.all_gather(gathered, w)
assert all(torch.equal(gathered[0], g) for g in gathered), "replicas drift"

# sharded restores: (1, 2) over "model", then remesh onto (2, 1) with FSDP
with np.load(ckdir + "/step_3/host0.npz") as f:
    saved = {k: f[k] for k in f.files}
like = {"params": {"embed": torch.empty((8, 6), device="meta"),
                   "scan": {"b0": {"attn": {"wq": torch.empty(
                       (2, 6, 4), device="meta")}}},
                   "final_norm": torch.empty((6,), device="meta")},
        "opt": {"step": torch.empty((), dtype=torch.int32, device="meta")}}
tp = make_host_mesh(model=2, device="cpu")
assert steps._dp_group(tp).size() == 1
shards = {}
for label, mesh in (("tp", tp), ("fsdp", dp)):
    if label == "tp":
        tree, _ = ckpt.restore(ckdir, like,
                               shardings=shd.params_shardings(like, mesh))
    else:
        tree, _ = remesh(ckdir, like, mesh, lambda l, m:
                         shd.params_shardings(l, m, fsdp=True))

    def check(path, got):
        arr = saved[path]
        coord = mesh.get_coordinate()
        want = arr
        for mdim, pl in enumerate(got.placements):
            if pl.is_shard():
                n = mesh.size(mdim)
                size = want.shape[pl.dim] // n
                want = np.take(want, range(coord[mdim] * size,
                                           (coord[mdim] + 1) * size),
                               axis=pl.dim)
        np.testing.assert_array_equal(got.to_local().numpy(), want)
        np.testing.assert_array_equal(got.full_tensor().numpy(), arr)
        shards[f"{label}:{path}"] = (tuple(got.to_local().shape),
                                     [str(p) for p in got.placements])
        return got

    tree_map_with_path(check, tree)
print("RANK_OK", rank, sorted(shards.items()), flush=True)
dist.destroy_process_group()
"""


def test_two_rank_gloo_run(tmp_path):
    """Two processes: the collectives against numpy, the DP replicas
    equal, and each rank's restored shards slices of the saved arrays
    (embed cut over "model" on (1, 2), over "data" on (2, 1) with FSDP)."""
    ckpt.save(_tree(), str(tmp_path / "ck"), step=3)
    env = dict(os.environ, GLOO_SOCKET_IFNAME="lo", PYTHONPATH="src")
    procs = [subprocess.Popen(
        [sys.executable, "-c", _TWO_RANKS, str(r), "2",
         str(tmp_path / "store"), str(tmp_path / "ck")], cwd=ROOT, env=env,
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        for r in range(2)]
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=TWO_RANK_TIMEOUT))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
    for r, (p, (out, err)) in enumerate(zip(procs, outs)):
        assert p.returncode == 0 and f"RANK_OK {r}" in out, out + err[-3000:]
    tp0 = outs[0][0]
    assert "('tp:params/embed', ((4, 6)" in tp0
    assert "('fsdp:params/embed', ((8, 3)" in tp0
    # a scan-stacked 3-d projection matches no 2-d rule (the reference's)
    assert "('tp:params/scan/b0/attn/wq', ((2, 6, 4), ['R', 'R'])" in tp0
    assert "('tp:opt/step', ((), ['R', 'R'])" in tp0

"""The port's checkpoints: the cases of ``tests/test_ckpt.py::
TestCheckpoint`` on tensor trees (the sharded restore on a ``gloo``
world of one), and the on-disk layout shared with
``repro.ckpt.checkpoint``: a checkpoint one package saves, the other
restores leaf for leaf, Huffman-compressed ``w3`` leaves included (exact:
both decode the same stream to sign x the same stored scale)."""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.ckpt import checkpoint as jckpt
from repro_torch.ckpt import checkpoint as ckpt
from repro_torch.dist import sharding as shd
from repro_torch.launch.mesh import make_host_mesh
from repro_torch.tree import tree_leaves, tree_map


def tree(rng):
    return {
        "params": {"scan": {"w": torch.from_numpy(
            rng.standard_normal((4, 8, 16)).astype(np.float32))},
            "embed": torch.from_numpy(
                rng.standard_normal((32, 16)).astype(np.float32))},
        "opt": {"step": torch.tensor(7, dtype=torch.int32),
                "mu": {"x": torch.zeros(3)}},
    }


def _bnn_tree(rng):
    """A ReActNet-shaped tree: two 3x3 latent weights (compressed when
    asked), a 1x1 weight, BN stats and an int32 step."""
    return {"params": {"blocks": [
        {"w3": rng.standard_normal((8, 32, 3, 3)).astype(np.float32),
         "w1": rng.standard_normal((16, 8, 1, 1)).astype(np.float32),
         "bn1": {"var": rng.random(8).astype(np.float32)}},
        {"w3": rng.standard_normal((16, 16, 3, 3)).astype(np.float32),
         "w1": rng.standard_normal((16, 16, 1, 1)).astype(np.float32),
         "bn1": {"var": rng.random(16).astype(np.float32)}}]},
        "step": np.asarray(11, np.int32)}


def _assert_trees_equal(got, want):
    a, b = tree_leaves(got), tree_leaves(want)
    assert len(a) == len(b)
    for x, y in zip(a, b):
        assert x.dtype == y.dtype and x.shape == y.shape
        assert torch.equal(x, y)


def _signed_scale(w):
    scale = np.abs(w).mean(axis=(1, 2, 3), keepdims=True)
    return np.where(w >= 0, 1.0, -1.0).astype(np.float32) * scale


class TestCheckpoint:
    def test_roundtrip(self, tmp_path, rng):
        t = tree(rng)
        ckpt.save(t, str(tmp_path), step=10)
        restored, step = ckpt.restore(str(tmp_path), t, device="cpu")
        assert step == 10
        _assert_trees_equal(restored, t)

    def test_latest_marker_and_multiple_steps(self, tmp_path, rng):
        t = tree(rng)
        ckpt.save(t, str(tmp_path), step=10)
        ckpt.save(t, str(tmp_path), step=20)
        assert ckpt.latest_step(str(tmp_path)) == 20
        _, step = ckpt.restore(str(tmp_path), t, device="cpu")
        assert step == 20
        _, step = ckpt.restore(str(tmp_path), t, step=10, device="cpu")
        assert step == 10

    def test_async_save(self, tmp_path, rng):
        t = tree(rng)
        before = t["params"]["embed"].clone()
        th = ckpt.save(t, str(tmp_path), step=5, async_=True)
        # the leaves were copied before save returned: updating them while
        # the writer runs does not reach the checkpoint
        t["params"]["embed"].add_(1.0)
        th.join(timeout=30)
        assert not th.is_alive()
        assert ckpt.latest_step(str(tmp_path)) == 5
        restored, _ = ckpt.restore(str(tmp_path), t, device="cpu")
        assert torch.equal(restored["params"]["embed"], before)

    def test_torn_write_invisible(self, tmp_path, rng):
        """A .tmp dir (simulated crash mid-write) is never picked up."""
        t = tree(rng)
        ckpt.save(t, str(tmp_path), step=1)
        os.makedirs(str(tmp_path / "step_2.tmp"))
        assert ckpt.latest_step(str(tmp_path)) == 1

    def test_compressed_binary_checkpoint(self, tmp_path, rng):
        """conv w3 leaves stored Huffman-compressed; restore reproduces
        sign * per-channel scale (inference snapshot semantics)."""
        w3 = rng.standard_normal((8, 32, 3, 3)).astype(np.float32)
        t = {"blocks": [{"w3": torch.from_numpy(w3)}]}
        ckpt.save(t, str(tmp_path), step=1, compress_binary=True)
        restored, _ = ckpt.restore(str(tmp_path), t, device="cpu")
        np.testing.assert_allclose(restored["blocks"][0]["w3"].numpy(),
                                   _signed_scale(w3), rtol=1e-6)
        blob = os.path.getsize(
            os.path.join(str(tmp_path), "step_1", "host0.npz"))
        assert blob < w3.nbytes

    def test_restore_missing_and_sharded(self, tmp_path, rng):
        t = tree(rng)
        with pytest.raises(FileNotFoundError):
            ckpt.restore(str(tmp_path), t, device="cpu")
        ckpt.save(t, str(tmp_path), step=3)
        mesh = make_host_mesh(device="cpu")     # a gloo world of one
        try:
            sharded, _ = ckpt.restore(str(tmp_path), t, shardings=shd
                                      .params_shardings(t, mesh, fsdp=True))
        finally:
            torch.distributed.destroy_process_group()
        for got, want in zip(tree_leaves(sharded), tree_leaves(t)):
            torch.testing.assert_close(got.to_local(), want, rtol=0, atol=0)
        bad = {**t, "opt": {**t["opt"], "mu": {"x": torch.zeros(4)}}}
        with pytest.raises(ValueError, match="shape"):
            ckpt.restore(str(tmp_path), bad, device="cpu")


@pytest.mark.parametrize("compress", [False, True])
def test_port_checkpoint_restores_in_reference(tmp_path, rng, compress):
    t = _bnn_tree(rng)
    ckpt.save(tree_map(torch.from_numpy, t), str(tmp_path), step=4,
              compress_binary=compress)
    like = jax.tree_util.tree_map(jnp.asarray, t)
    restored, step = jckpt.restore(str(tmp_path), like)
    assert step == 4
    for i, blk in enumerate(t["params"]["blocks"]):
        got = np.asarray(restored["params"]["blocks"][i]["w3"])
        want = _signed_scale(blk["w3"]) if compress else blk["w3"]
        np.testing.assert_array_equal(got, want)
        np.testing.assert_array_equal(
            np.asarray(restored["params"]["blocks"][i]["w1"]), blk["w1"])
    assert np.asarray(restored["step"]).dtype == np.int32
    assert int(restored["step"]) == 11


@pytest.mark.parametrize("compress", [False, True])
def test_reference_checkpoint_restores_in_port(tmp_path, rng, compress):
    t = _bnn_tree(rng)
    jckpt.save(jax.tree_util.tree_map(jnp.asarray, t), str(tmp_path),
               step=9, compress_binary=compress)
    ckpt.save(tree_map(torch.from_numpy, t), str(tmp_path / "port"), step=9,
              compress_binary=compress)
    like = tree_map(torch.from_numpy, t)
    restored, step = ckpt.restore(str(tmp_path), like, device="cpu")
    mine, _ = ckpt.restore(str(tmp_path / "port"), like, device="cpu")
    assert step == 9
    _assert_trees_equal(restored, mine)
    for i, blk in enumerate(t["params"]["blocks"]):
        want = _signed_scale(blk["w3"]) if compress else blk["w3"]
        np.testing.assert_array_equal(
            restored["params"]["blocks"][i]["w3"].numpy(), want)
    assert restored["step"].dtype == torch.int32
    # the same manifest and the same stored arrays
    with open(tmp_path / "step_9" / "manifest.json") as f, \
            open(tmp_path / "port" / "step_9" / "manifest.json") as g:
        assert f.read() == g.read()
    with np.load(tmp_path / "step_9" / "host0.npz") as a, \
            np.load(tmp_path / "port" / "step_9" / "host0.npz") as b:
        assert sorted(a.files) == sorted(b.files)
        for k in a.files:
            assert a[k].dtype == b[k].dtype
            assert a[k].tobytes() == b[k].tobytes()


def _bf16_tree(rng):
    """An LM training state's dtypes: bf16 params, f32 moments, an int32
    step (numpy, the reference's bf16 through ``ml_dtypes``)."""
    import ml_dtypes
    bf16 = lambda *s: rng.standard_normal(s).astype(ml_dtypes.bfloat16)  # noqa: E731
    return {"params": {"embed": bf16(32, 16), "scan": {"w": bf16(4, 8, 16)}},
            "opt": {"mu": {"embed": rng.standard_normal((32, 16)).astype(
                np.float32)}, "step": np.asarray(5, np.int32)}}


def _to_torch(a):
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.astype(np.float32)).to(torch.bfloat16)
    return torch.from_numpy(np.array(a))


def test_bf16_checkpoint_layout_and_restore(tmp_path, rng):
    """bf16 leaves are stored as the reference stores them (its
    ``ml_dtypes.bfloat16`` arrays: raw 2-byte words under the manifest dtype
    "bfloat16"), byte for byte, and restore bit for bit in the port, from
    either package's files and sharded on a gloo world of one."""
    t = _bf16_tree(rng)
    jckpt.save(t, str(tmp_path / "ref"), step=2)
    mine = tree_map(_to_torch, t)
    ckpt.save(mine, str(tmp_path / "port"), step=2)
    with open(tmp_path / "ref" / "step_2" / "manifest.json") as f, \
            open(tmp_path / "port" / "step_2" / "manifest.json") as g:
        assert f.read() == g.read()
    with np.load(tmp_path / "ref" / "step_2" / "host0.npz") as a, \
            np.load(tmp_path / "port" / "step_2" / "host0.npz") as b:
        assert sorted(a.files) == sorted(b.files)
        for k in a.files:
            assert a[k].dtype == b[k].dtype
            assert a[k].tobytes() == b[k].tobytes()
    like = tree_map(lambda x: torch.empty_like(x, device="meta"), mine)
    for where in ("ref", "port"):
        restored, step = ckpt.restore(str(tmp_path / where), like,
                                      device="cpu")
        assert step == 2
        _assert_trees_equal(restored, mine)
    mesh = make_host_mesh(device="cpu")
    try:
        sharded, _ = ckpt.restore(
            str(tmp_path / "ref"), like,
            shardings=shd.params_shardings(like, mesh, fsdp=True))
    finally:
        torch.distributed.destroy_process_group()
    _assert_trees_equal([x.to_local() for x in tree_leaves(sharded)],
                        tree_leaves(mine))

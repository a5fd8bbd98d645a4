"""Atomic, async checkpointing of tensor trees (port of
``repro.ckpt.checkpoint``; single-host files, sharded restore).

Layout of one checkpoint (the reference's, so either package restores
what the other saved):

    <dir>/step_<N>/
        manifest.json      {"step": N, "leaves": {path: {shape, dtype}},
                            "hosts": 1, "compressed": [path, ...]}
        host0.npz          one entry per leaf path
    <dir>/LATEST           text file with the newest complete step dir

Leaf paths are ``repro_torch.tree``'s (``"params/blocks/0/w3"``), the
reference's path names.  Writes go to ``step_<N>.tmp`` and are renamed
only after everything is flushed, so a torn write is never restored.

``compress_binary`` Huffman-compresses the binarised 3x3 weights (``w3``
leaves) in storage: lossless in the binary domain, no clustering; a
restored latent is sign x its output channel's mean magnitude (an
inference snapshot).

``restore(..., shardings=...)`` lays each leaf out on a device mesh: every
rank reads the saved array and keeps its own shard as a ``DTensor``
(``DTensor.from_local`` on the placements given), so a checkpoint written
by any number of ranks restores onto any mesh whose axes divide it.
"""

from __future__ import annotations

import json
import os
import threading

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.core import bitpack, compression, huffman
from repro_torch.tree import tree_map_with_path


# numpy has no bfloat16: a bf16 leaf is stored as its raw 2-byte words,
# as ``np.savez`` writes the reference's ``ml_dtypes.bfloat16`` arrays,
# under the manifest dtype "bfloat16"
_BF16_WORDS = np.dtype("V2")


def _to_host(leaf: torch.Tensor) -> np.ndarray:
    t = leaf.detach().to("cpu", copy=True)
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy().view(_BF16_WORDS)
    return t.numpy()


def _from_host(arr: np.ndarray, dtype_name: str) -> torch.Tensor:
    """A stored leaf -> a CPU tensor of its saved dtype."""
    if dtype_name == "bfloat16":
        return torch.from_numpy(np.array(arr).view(np.int16)).view(
            torch.bfloat16)
    return torch.from_numpy(np.array(arr))


def _flatten(tree) -> dict[str, np.ndarray]:
    """path -> the leaf copied to the host."""
    out = {}
    tree_map_with_path(lambda path, leaf: out.setdefault(
        path, _to_host(leaf)), tree)
    return out


def save(tree, directory: str, step: int, *, async_: bool = False,
         compress_binary: bool = False) -> threading.Thread | None:
    """Save a tree of tensors. Returns the writer thread when ``async_``.

    The leaves are copied to the host before this returns, so the caller
    may go on updating them while an async write runs."""
    flat = _flatten(tree)

    def write():
        tmp = os.path.join(directory, f"step_{step}.tmp")
        final = os.path.join(directory, f"step_{step}")
        os.makedirs(tmp, exist_ok=True)
        manifest = {"step": step, "hosts": 1, "leaves": {}, "compressed": []}
        blobs = {}
        for path, arr in flat.items():
            manifest["leaves"][path] = {
                "shape": list(arr.shape),
                "dtype": "bfloat16" if arr.dtype == _BF16_WORDS
                else str(arr.dtype)}
            if (compress_binary and arr.ndim == 4
                    and arr.dtype in (np.float32, np.float16)
                    and "w3" in path.split("/")[-1]):
                bits = (arr >= 0).astype(np.uint8)
                ct = compression.compress_conv3x3(bits, cluster=False,
                                                  tiled=False)
                blobs[path + "#stream"] = ct.stream_words
                blobs[path + "#scale"] = np.abs(arr).mean(
                    axis=tuple(range(1, arr.ndim)))
                blobs[path + "#tables"] = ct.decode_tables()
                blobs[path + "#bits"] = np.asarray([ct.stream_bits])
                manifest["compressed"].append(path)
            else:
                blobs[path] = arr
        np.savez(os.path.join(tmp, "host0.npz"), **blobs)
        with open(os.path.join(tmp, "manifest.json"), "w") as f:
            json.dump(manifest, f)
        os.replace(tmp, final)                  # atomic publish
        with open(os.path.join(directory, "LATEST.tmp"), "w") as f:
            f.write(f"step_{step}")
        os.replace(os.path.join(directory, "LATEST.tmp"),
                   os.path.join(directory, "LATEST"))

    os.makedirs(directory, exist_ok=True)
    if async_:
        t = threading.Thread(target=write, daemon=True)
        t.start()
        return t
    write()
    return None


def latest_step(directory: str) -> int | None:
    marker = os.path.join(directory, "LATEST")
    if not os.path.exists(marker):
        return None
    with open(marker) as f:
        name = f.read().strip()
    if not os.path.exists(os.path.join(directory, name, "manifest.json")):
        return None
    return int(name.split("_")[1])


def restore(directory: str, like, *, step: int | None = None,
            device="cuda", shardings=None):
    """Restore into the structure of ``like`` (a tree of tensors, meta
    tensors included: each restored leaf takes its counterpart's dtype) on
    ``device``.  ``shardings``, a tree like ``like`` of
    ``repro_torch.dist.sharding.NamedSharding`` on a ``DeviceMesh``, makes
    every leaf a ``DTensor`` holding this rank's shard, on the mesh's
    device type (``device`` is then not used).  Returns (tree, step)."""
    if shardings is None:
        device = resolve_device(device)
    if step is None:
        step = latest_step(directory)
        if step is None:
            raise FileNotFoundError(f"no checkpoint in {directory}")
    d = os.path.join(directory, f"step_{step}")
    with open(os.path.join(d, "manifest.json")) as f:
        manifest = json.load(f)
    leaves_flat: dict[str, np.ndarray] = {}
    dtypes = {path: meta["dtype"] for path, meta in manifest["leaves"].items()}
    with np.load(os.path.join(d, "host0.npz")) as blobs:
        for path, meta in manifest["leaves"].items():
            if path in manifest.get("compressed", []):
                leaves_flat[path] = _decode_w3(blobs, path,
                                               tuple(meta["shape"]))
            else:
                leaves_flat[path] = blobs[path]

    placed = {}                         # path -> NamedSharding
    if shardings is not None:
        tree_map_with_path(lambda path, sh: placed.setdefault(path, sh),
                           shardings)

    def leaf(path, proto):
        arr = leaves_flat[path]
        if tuple(arr.shape) != tuple(proto.shape):
            raise ValueError(f"{path}: checkpoint shape {arr.shape}, "
                             f"expected {tuple(proto.shape)}")
        if shardings is not None:
            return _local_shard(arr, dtypes[path], proto.dtype, placed[path])
        return _from_host(arr, dtypes[path]).to(device=device,
                                                dtype=proto.dtype)

    return tree_map_with_path(leaf, like), step


def _local_shard(arr: np.ndarray, saved: str, dtype, sharding):
    """This rank's block of ``arr`` under ``sharding`` as a DTensor: each
    mesh dim that shards a tensor dim cuts it into equal blocks and keeps
    the one at this rank's coordinate, mesh dims in order (outermost
    first, as a multi-axis spec entry nests them)."""
    from torch.distributed.tensor import DTensor, Shard
    mesh = sharding.mesh
    placements = sharding.placements
    coord = mesh.get_coordinate()
    local = arr
    for mdim, pl in enumerate(placements):
        if isinstance(pl, Shard):
            n = mesh.size(mdim)
            if local.shape[pl.dim] % n:
                raise ValueError(f"dim {pl.dim} of {arr.shape} does not "
                                 f"split over {n} ranks")
            step = local.shape[pl.dim] // n
            idx = [slice(None)] * local.ndim
            idx[pl.dim] = slice(coord[mdim] * step,
                                (coord[mdim] + 1) * step)
            local = local[tuple(idx)]
    dev = (torch.device("cuda", torch.cuda.current_device())
           if mesh.device_type == "cuda" else torch.device("cpu"))
    t = _from_host(local, saved).to(device=dev, dtype=dtype)
    whole = torch.empty(arr.shape, device="meta")
    return DTensor.from_local(t, mesh, placements, run_check=False,
                              shape=whole.shape, stride=whole.stride())


def _decode_w3(blobs, path: str, shape: tuple) -> np.ndarray:
    """A compressed w3 leaf -> float32 sign x per-channel scale."""
    nbits = int(blobs[path + "#bits"][0])
    assign = _assignment_from_tables(blobs[path + "#tables"])
    seqs = huffman.decode_stream(blobs[path + "#stream"], nbits, assign,
                                 count=int(np.prod(shape[:2])))
    bits = bitpack.sequences_to_kernel(seqs.reshape(shape[:2]))
    scale = blobs[path + "#scale"].reshape((-1,) + (1,) * (len(shape) - 1))
    return (bits.astype(np.float32) * 2 - 1) * scale


def _assignment_from_tables(tables_flat: np.ndarray):
    """Reconstruct a NodeAssignment equivalent for decoding from the stored
    160-entry table (escape node needs no table)."""
    node_of = np.full(512, 3, np.int32)
    index_of = np.arange(512, dtype=np.int32)
    t0, t1, t2 = tables_flat[:32], tables_flat[32:96], tables_flat[96:160]
    for n, t in enumerate((t0, t1, t2)):
        node_of[t] = n
        index_of[t] = np.arange(len(t))
    return huffman.NodeAssignment(
        node_of, index_of,
        (t0.astype(np.uint16), t1.astype(np.uint16), t2.astype(np.uint16)))

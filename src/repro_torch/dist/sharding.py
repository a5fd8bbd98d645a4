"""Sharding rules (port of ``repro.dist.sharding``).

The rules are pure functions of a parameter's name and shape and of the
mesh's axis sizes.  A spec is the reference's ``PartitionSpec`` as a
plain tuple with one entry a tensor dimension: ``None`` (replicated), a
mesh axis name, or a tuple of axis names.  Logical axis ``"batch"`` maps
to the data-parallel axes (``("pod", "data")`` when multi-pod, else
``("data",)``), ``"model"`` to the tensor-parallel axis.  Every spec is
*safe*: an axis is assigned only to a dimension it divides.

A one-axis tuple entry is written as the axis name, as a
``PartitionSpec`` normalises it.

A mesh is a ``torch.distributed.device_mesh.DeviceMesh`` (axis names
``mesh_dim_names``), anything with an ``axis_names`` tuple and a
``shape`` mapping of axis sizes (the reference tests' ``FakeMesh``), or a
plain mapping of axis name to size.  :class:`NamedSharding` pairs a mesh
with a spec and gives the DTensor placements (``Shard``/``Replicate``,
one a mesh dimension) that ``ckpt.restore(shardings=...)`` lays a leaf
out with.
"""

from __future__ import annotations

import dataclasses
from typing import Any

from repro_torch.tree import tree_map, tree_map_with_path


def axis_sizes(mesh) -> dict[str, int]:
    """Axis name -> size, in the mesh's axis order."""
    names = getattr(mesh, "mesh_dim_names", None)
    if names is not None:                               # DeviceMesh
        return dict(zip(names, (int(n) for n in mesh.shape)))
    if isinstance(mesh, dict):
        return {k: int(v) for k, v in mesh.items()}
    return {a: int(mesh.shape.get(a, 1)) for a in mesh.axis_names}


def axis_names(mesh) -> tuple[str, ...]:
    return tuple(axis_sizes(mesh))


def _axis_size(mesh, name: str) -> int:
    return axis_sizes(mesh).get(name, 1)


def dp_axes(mesh) -> tuple[str, ...]:
    """Data-parallel mesh axes, outermost first."""
    return tuple(a for a in axis_names(mesh) if a in ("pod", "data"))


def batch_axes(mesh) -> tuple[str, ...]:
    return dp_axes(mesh)


def _dp_size(mesh) -> int:
    n = 1
    for a in dp_axes(mesh):
        n *= _axis_size(mesh, a)
    return n


def _entry_size(mesh, entry) -> int:
    if entry is None:
        return 1
    if isinstance(entry, (tuple, list)):
        n = 1
        for a in entry:
            n *= _axis_size(mesh, a)
        return n
    return _axis_size(mesh, entry)


def _resolve_one(mesh, name: str) -> tuple[str, ...] | None:
    if name == "batch":
        return dp_axes(mesh) or None
    if name in axis_names(mesh):
        return (name,)
    return None


def _resolve(mesh, entry):
    """A logical entry -> concrete mesh axes ("batch" -> the DP axes)."""
    if entry is None:
        return None
    if isinstance(entry, (tuple, list)):
        axes = tuple(a for e in entry for a in (_resolve_one(mesh, e) or ()))
        return axes or None
    one = _resolve_one(mesh, entry)
    if one is None:
        return None
    return one if len(one) > 1 else one[0]


def safe_spec(mesh, shape: tuple[int, ...], *axes) -> tuple:
    """Spec with non-dividing or absent axes dropped to None."""
    entries = list(axes) + [None] * (len(shape) - len(axes))
    out = []
    for dim, entry in zip(shape, entries[: len(shape)]):
        resolved = _resolve(mesh, entry)
        if resolved is not None and dim % _entry_size(mesh, resolved) == 0:
            out.append(resolved)
        else:
            out.append(None)
    return tuple(out)


def constrain(x, *axes):
    """The identity: the port's models run on plain tensors, where the
    reference's constraint is a no-op too."""
    return x


# ---------------------------------------------------------------------------
# parameter specs
# ---------------------------------------------------------------------------

# leaf names whose 2-d weight shards the OUTPUT (last) dim over "model"
_COL_SHARDED = {
    "wq", "wk", "wv", "up", "gate", "w_uq", "w_dq", "w_uk", "w_uv",
    "w_x", "w_gate", "w_i", "w_r", "lm_head",
}
# leaf names whose 2-d weight shards the INPUT (first) dim over "model"
_ROW_SHARDED = {"wo", "down", "w_out"}


def _base_spec(leaf: str, shape: tuple[int, ...], mesh) -> tuple:
    """Spec of the trailing (unstacked) dims of one parameter."""
    model = _axis_size(mesh, "model")
    nd = len(shape)
    if nd <= 1:
        return (None,) * nd
    if nd == 3 and leaf.startswith("w_"):        # MoE expert weights (E, a, b)
        if model > 1 and shape[0] % model == 0:  # expert parallelism
            return ("model", None, None)
        # per-expert TP on the d_ff axis (gate/up: last dim; down: middle)
        if leaf == "w_down":
            return (None, "model", None)
        return (None, None, "model")
    if nd == 2:
        if leaf == "embed":
            return ("model", None) if shape[0] % max(model, 1) == 0 \
                else (None, None)
        if leaf in _COL_SHARDED:
            return (None, "model")
        if leaf in _ROW_SHARDED:
            return ("model", None)
    return (None,) * nd


def param_spec(name: str, shape: tuple[int, ...], mesh,
               *, fsdp: bool = False) -> tuple:
    """Spec of one named parameter (name = "/".join(tree path)).

    Scan-stacked parameters carry extra *leading* dims; the rule is
    matched on the leaf name and applied to the trailing dims.  ``fsdp``
    puts the DP axes on the first free dim they divide."""
    shape = tuple(shape)
    leaf = name.rsplit("/", 1)[-1]
    base = _base_spec(leaf, shape, mesh)
    lead = len(shape) - len(base)
    entries = [None] * lead + list(base)
    for i, (dim, entry) in enumerate(zip(shape, entries)):
        if entry is not None and dim % _entry_size(mesh, entry) != 0:
            entries[i] = None
    if fsdp:
        dp = dp_axes(mesh)
        dsz = _dp_size(mesh)
        if dp and len(shape) >= 2:
            for i in range(lead, len(shape)):
                if entries[i] is None and shape[i] % dsz == 0:
                    entries[i] = dp[0] if len(dp) == 1 else tuple(dp)
                    break
    return tuple(entries)


def path_name(path) -> str:
    """A tree path (keys and indices, or a ``repro_torch.tree`` path
    string) -> "a/b/0/c"."""
    if isinstance(path, str):
        return path
    return "/".join(str(k) for k in path)


@dataclasses.dataclass(frozen=True)
class NamedSharding:
    """A spec on a mesh (the reference's ``jax.sharding.NamedSharding``)."""
    mesh: Any
    spec: tuple

    @property
    def placements(self) -> tuple:
        """One DTensor placement a mesh axis: ``Shard(d)`` if tensor dim
        ``d``'s entry names the axis, else ``Replicate()``."""
        from torch.distributed.tensor import Replicate, Shard
        out = []
        for axis in axis_names(self.mesh):
            dims = [d for d, e in enumerate(self.spec)
                    if e == axis or (isinstance(e, tuple) and axis in e)]
            out.append(Shard(dims[0]) if dims else Replicate())
        return tuple(out)


def params_shardings(params, mesh, *, fsdp: bool = False):
    """Tree of :class:`NamedSharding` for a params tree (of tensors or
    meta tensors)."""
    return tree_map_with_path(
        lambda path, leaf: NamedSharding(
            mesh, param_spec(path, tuple(leaf.shape), mesh, fsdp=fsdp)),
        params)


# ---------------------------------------------------------------------------
# batch / cache specs
# ---------------------------------------------------------------------------

def _leading_batch_spec(mesh, shape: tuple[int, ...]) -> tuple:
    if not shape:
        return ()
    return safe_spec(mesh, tuple(shape), "batch")


def batch_shardings(batch, mesh):
    """DP-shard the leading axis of every batch leaf; scalars replicated."""
    return tree_map(lambda leaf: NamedSharding(
        mesh, _leading_batch_spec(mesh, tuple(leaf.shape))), batch)


def cache_shardings(cache, mesh):
    """KV/state caches: batch-major leaves DP-sharded on the leading axis."""
    return tree_map(lambda leaf: NamedSharding(
        mesh, _leading_batch_spec(mesh, tuple(leaf.shape))), cache)

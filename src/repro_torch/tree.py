"""Parameter-tree helpers for nested dicts and lists of tensors.

Leaves are visited in the order jax flattens the same tree — dict keys
sorted, lists by index — so a leaf's position and its ``"a/b/0/c"`` path
name agree with the reference's (``repro.dist.sharding.path_name``).
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch import resolve_device


def tree_map_with_path(fn, tree, path: str = ""):
    """Rebuild ``tree`` with ``fn(path_name, leaf)`` at every leaf."""
    if isinstance(tree, dict):
        return {k: tree_map_with_path(fn, tree[k], f"{path}/{k}" if path
                                      else str(k)) for k in sorted(tree)}
    if isinstance(tree, (list, tuple)):
        return type(tree)(tree_map_with_path(fn, v, f"{path}/{i}" if path
                                             else str(i))
                          for i, v in enumerate(tree))
    return fn(path, tree)


def tree_map(fn, tree):
    return tree_map_with_path(lambda _, leaf: fn(leaf), tree)


def tree_leaves(tree) -> list:
    out = []
    tree_map(out.append, tree)
    return out


def tree_unflatten(like, leaves) -> dict:
    """``like``'s tree with ``leaves`` (in :func:`tree_leaves` order) at
    its leaves."""
    it = iter(leaves)
    return tree_map(lambda _: next(it), like)


def params_from_numpy(tree, device) -> dict:
    """The reference's ``init_params`` tree (leaves as numpy arrays) ->
    the port's params on ``device``, leaf for leaf.  bfloat16 leaves
    (``ml_dtypes``) cross through float32, which is exact."""
    device = resolve_device(device)

    def leaf(a):
        a = np.asarray(a)
        if a.dtype.name == "bfloat16":
            return torch.from_numpy(a.astype(np.float32)).to(
                device=device, dtype=torch.bfloat16)
        return torch.from_numpy(np.array(a)).to(device)

    return tree_map(leaf, tree)

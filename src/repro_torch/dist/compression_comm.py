"""Compressed gradient exchange: 1-bit and int8 allreduce with error
feedback (port of ``repro.dist.compression_comm``).

Each data-parallel rank holds its *local* gradients; the only traffic is
one scale and the signs (or int8 levels) of each tensor.  The residual
``v - local`` stays on the rank as error feedback (Seide et al., 2014),
so the compressed optimizer tracks the exact one in expectation.

``group`` is the data-parallel ``torch.distributed`` process group
(``None``: the default group).  Averages are an ``all_reduce`` SUM over
the group's size, which the ``gloo`` backend supports as it does not
``AVG``; without a process group the functions are a world of one, as
the reference's ``pmean`` over one device is.
"""

from __future__ import annotations

import torch
import torch.distributed as dist

from repro_torch.tree import tree_leaves, tree_map, tree_unflatten

_EPS = 1e-12


def _world(group) -> int:
    return dist.get_world_size(group) if dist.is_initialized() else 1


def _reduce(t: torch.Tensor, op, group) -> torch.Tensor:
    if dist.is_initialized():
        dist.all_reduce(t, op=op, group=group)
    return t


def pmean(t: torch.Tensor, group=None) -> torch.Tensor:
    """The mean of ``t`` over the group's ranks (a new tensor)."""
    return _reduce(t.clone(), dist.ReduceOp.SUM, group) / _world(group)


def pmax(t: torch.Tensor, group=None) -> torch.Tensor:
    return _reduce(t.clone(), dist.ReduceOp.MAX, group)


def init_error_feedback(grads):
    """Zero residual state, one leaf per gradient leaf."""
    return tree_map(torch.zeros_like, grads)


def onebit_allreduce(g: torch.Tensor, ef: torch.Tensor, group=None):
    """1-bit allreduce of one tensor -> (mean update, new ef).

    Emits sign(v) * scale where v = g + ef and scale = the group's mean of
    mean |v|; the residual v - emitted stays in the error feedback."""
    v = g + ef
    scale = torch.clamp(pmean(v.abs().mean(), group), min=_EPS)
    signs = torch.sign(v)
    local = signs * scale                     # what this rank contributed
    out = pmean(signs, group) * scale
    return out, v - local


def int8_allreduce(g: torch.Tensor, ef: torch.Tensor, group=None):
    """int8 allreduce: symmetric per-tensor levels at the group's max."""
    v = g + ef
    scale = torch.clamp(pmax(v.abs().max(), group) / 127.0, min=_EPS)
    q = torch.clamp(torch.round(v / scale), -127, 127)
    local = q * scale
    out = pmean(q, group) * scale
    return out, v - local


def compress_grads(grads, ef, group=None, *, mode: str = "onebit"):
    """Compress and exchange a gradient tree -> (reduced grads, new ef)."""
    fn = {"onebit": onebit_allreduce, "int8": int8_allreduce}[mode]
    pairs = [fn(g, e, group) for g, e in zip(tree_leaves(grads),
                                              tree_leaves(ef))]
    return (tree_unflatten(grads, [o for o, _ in pairs]),
            tree_unflatten(grads, [e for _, e in pairs]))

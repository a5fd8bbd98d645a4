"""Step builders: the train steps and the serving prefill/decode pair
(port of ``repro.launch.steps``).

All sharding is decided here, from ``repro_torch.dist.sharding``, so the
model code stays mesh-agnostic: the steps hand the models plain tensors.
A step is a plain function; gradients come from ``torch.autograd.grad``
on the loss and the update is ``train.optimizer.apply_updates``.

``build_train_step`` runs on a world of one rank; sharded FSDP/TP
training over more ranks is not ported (``ROADMAP.md``, Queue 1 item
5a) and raises.  ``build_compressed_dp_train_step`` is data parallelism
with replicated params over any number of ranks, its gradients
exchanged 1-bit or int8 (``dist.compression_comm``).
"""

from __future__ import annotations

import math

import torch
import torch.distributed as dist

from repro_torch.dist import sharding as shd
from repro_torch.dist.compression_comm import (compress_grads,
                                               init_error_feedback, pmean)
from repro_torch.models.api import get_model
from repro_torch.train import optimizer as opt
from repro_torch.tree import tree_leaves, tree_map, tree_unflatten

def _world(mesh) -> int:
    return math.prod(shd.axis_sizes(mesh).values())


def train_state_specs(cfg, mesh, *, fsdp: bool = True):
    """Meta tensors + shardings of (params, opt_state), allocating
    nothing: the params come from ``init_params`` on the meta device."""
    api = get_model(cfg)
    params = api.init_params(cfg, None, "meta")
    p_shard = shd.params_shardings(params, mesh, fsdp=fsdp)
    o_shard = {"step": shd.NamedSharding(mesh, ()), "mu": p_shard,
               "nu": p_shard}
    return (params, p_shard), (opt.init_state(params), o_shard)


def value_and_grad(loss_fn, params, *args):
    """(loss, grads) of ``loss_fn(params, *args)``: grads in the params'
    tree, zeros where a leaf does not reach the loss."""
    leaves = tree_leaves(params)
    with torch.enable_grad():
        live = [p.detach().requires_grad_(True) for p in leaves]
        loss = loss_fn(tree_unflatten(params, live), *args)
        grads = torch.autograd.grad(loss, live, allow_unused=True)
    grads = [torch.zeros_like(p) if g is None else g
             for p, g in zip(leaves, grads)]
    return loss.detach(), tree_unflatten(params, grads)


def build_train_step(cfg, mesh, oc: opt.OptConfig | None = None,
                     *, fsdp: bool = True, grad_compression: str = "none",
                     donate: bool = True):
    """-> (step, state shardings); ``step(state, batch) -> (state,
    loss)`` with ``state = {"params", "opt"}``.

    ``donate`` updates ``state``'s tensors in place, leaf by leaf (the
    reference donates the state to its jit step), and leaves them as
    they were when the loss is not finite, so the Supervisor's dropped
    update holds; that check reads the loss back every step."""
    api = get_model(cfg)
    oc = oc or opt.OptConfig()
    if grad_compression != "none":
        raise ValueError(
            "grad compression needs local (unreduced) gradients; use "
            "build_compressed_dp_train_step (pure-DP path)")
    if _world(mesh) > 1:
        raise NotImplementedError(
            "build_train_step runs on one rank; sharded FSDP/TP training "
            "over more than one rank (ROADMAP.md, Queue 1 item 5a) is not "
            "ported; use build_compressed_dp_train_step")
    (_, p_shard), (_, o_shard) = train_state_specs(cfg, mesh, fsdp=fsdp)

    def step(state, batch):
        params = state["params"]
        loss, grads = value_and_grad(
            lambda p: api.loss_fn(cfg, p, batch), params)
        if donate and not torch.isfinite(loss):
            return state, loss
        new_params, new_opt, _ = opt.apply_updates(
            params, grads, state["opt"], oc, donate=donate)
        return {"params": new_params, "opt": new_opt}, loss

    return step, {"params": p_shard, "opt": o_shard}


def _dp_group(mesh):
    """The process group over the mesh's data-parallel axes ("pod" and
    "data", as the reference's ``batch_axes``); None (the default group)
    off a ``DeviceMesh``."""
    if getattr(mesh, "mesh_dim_names", None) is None:
        return None
    axes = shd.dp_axes(mesh)
    if len(axes) == 1:
        return mesh.get_group(axes[0])
    return mesh[axes]._flatten().get_group()


def build_compressed_dp_train_step(loss_fn, mesh, oc: opt.OptConfig,
                                   *, mode: str = "onebit"):
    """Data-parallel train step with compressed gradient exchange.

    Every rank holds the whole params (replicated over DP) and takes the
    rows of ``batch`` (the global batch) at its DP rank, so
    ``value_and_grad`` yields *local* gradients and the only traffic
    across ranks is each tensor's scale and signs or levels.
    ``loss_fn(params, batch) -> scalar local loss``; ``state = {"params",
    "opt", "ef"}``; the loss returned is the mean over the ranks.
    -> (step, sharding of every state leaf: replicated)."""
    group = _dp_group(mesh)

    def step(state, batch):
        n = dist.get_world_size(group) if dist.is_initialized() else 1
        r = dist.get_rank(group) if dist.is_initialized() else 0
        rows = {x.shape[0] for x in tree_leaves(batch)}
        if any(b % n for b in rows):
            raise ValueError(f"batch rows {sorted(rows)} do not split over "
                             f"{n} data-parallel ranks")
        local = tree_map(lambda x: x[r * (x.shape[0] // n):
                                     (r + 1) * (x.shape[0] // n)], batch)
        loss, grads = value_and_grad(loss_fn, state["params"], local)
        grads, new_ef = compress_grads(grads, state["ef"], group, mode=mode)
        new_params, new_opt, _ = opt.apply_updates(
            state["params"], grads, state["opt"], oc)
        return ({"params": new_params, "opt": new_opt, "ef": new_ef},
                pmean(loss, group))

    return step, shd.NamedSharding(mesh, ())


def init_train_state(cfg, mesh, generator: torch.Generator, *,
                     grad_compression: str = "none", device="cuda"):
    """Params drawn from ``generator`` (on ``device``) + optimizer state,
    and the error feedback under ``grad_compression``.  Every rank of
    ``mesh`` holds whole tensors: the one-rank step and the replicated DP
    path are the ones ported."""
    del mesh
    api = get_model(cfg)
    params = api.init_params(cfg, generator, device)
    state = {"params": params, "opt": opt.init_state(params)}
    if grad_compression != "none":
        state["ef"] = init_error_feedback(params)
    return state


# ---------------------------------------------------------------------------
# serving
# ---------------------------------------------------------------------------

def build_serve_steps(cfg, mesh, batch: int, max_len: int,
                      *, fsdp: bool = False):
    """(prefill_fn, decode_fn, (params specs, shardings), (cache specs,
    shardings)); the specs are meta tensors."""
    api = get_model(cfg)
    params = api.init_params(cfg, None, "meta")
    p_shard = shd.params_shardings(params, mesh, fsdp=fsdp)
    cache = api.init_cache_specs(cfg, batch, max_len)
    c_shard = shd.cache_shardings(cache, mesh)

    @torch.no_grad()
    def prefill_fn(params, tokens, cache, *extra):
        if cfg.family == "vlm":
            return api.prefill(cfg, params, tokens, cache,
                               vision_embeds=extra[0])
        return api.prefill(cfg, params, tokens, cache, *extra)

    @torch.no_grad()
    def decode_fn(params, cache, tokens, pos):
        return api.decode_step(cfg, params, cache, tokens, pos)

    return prefill_fn, decode_fn, (params, p_shard), (cache, c_shard)

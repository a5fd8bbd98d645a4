"""AdamW + LR schedule, BNN-aware (port of ``repro.train.optimizer``).

BNN latent weights (paper §II-A): binarised layers train on full-precision
latent weights via the STE; the optimizer is oblivious, but
``clip_latent`` keeps every leaf in [-clip, clip] so signs keep flipping.

Plain functions on the nested dict/list trees of ``repro_torch.tree``,
in the reference's order of arithmetic: the global-norm clip first, f32
moments, bias correction with the step in f32, decoupled weight decay
inside the update, and the latent clip last.  ``torch.optim.AdamW``
clips neither the global norm nor the latents and applies the decay
elsewhere, so it is not used.
"""

from __future__ import annotations

import dataclasses
import math

import torch

from repro_torch.tree import tree_leaves, tree_map, tree_unflatten


@dataclasses.dataclass(frozen=True)
class OptConfig:
    lr: float = 3e-4
    betas: tuple[float, float] = (0.9, 0.95)
    eps: float = 1e-8
    weight_decay: float = 0.1
    grad_clip: float = 1.0
    warmup_steps: int = 100
    total_steps: int = 10_000
    min_lr_ratio: float = 0.1
    clip_latent: float = 0.0          # >0 for BNN latent weights


def lr_schedule(oc: OptConfig):
    """step (int tensor) -> f32 learning rate: linear warmup, then cosine
    decay to ``min_lr_ratio * lr`` at ``total_steps``."""
    def fn(step: torch.Tensor) -> torch.Tensor:
        step = step.to(torch.float32)
        warm = step / max(oc.warmup_steps, 1)
        t = (step - oc.warmup_steps) / max(oc.total_steps - oc.warmup_steps,
                                           1)
        t = torch.clamp(t, 0.0, 1.0)
        cos = oc.min_lr_ratio + (1 - oc.min_lr_ratio) * 0.5 * (
            1 + torch.cos(math.pi * t))
        return oc.lr * torch.where(step < oc.warmup_steps, warm, cos)
    return fn


def init_state(params) -> dict:
    """Step 0 and zero f32 moments, on the params' device."""
    leaves = tree_leaves(params)
    device = leaves[0].device if leaves else None

    def zeros(p):
        return tree_map(lambda x: torch.zeros(x.shape, dtype=torch.float32,
                                              device=x.device), p)

    return {"step": torch.zeros((), dtype=torch.int32, device=device),
            "mu": zeros(params), "nu": zeros(params)}


def _global_norm(tree) -> torch.Tensor:
    return torch.sqrt(sum(torch.sum(torch.square(x.to(torch.float32)))
                          for x in tree_leaves(tree)))


@torch.no_grad()
def apply_updates(params, grads, state, oc: OptConfig, *,
                  donate: bool = False):
    """One AdamW step -> (new_params, new_state, metrics).

    ``grads`` has the params' tree; a leaf the loss does not use carries
    zeros (it still decays, and counts in the norm).  ``donate`` writes
    the new params and moments into ``params`` and ``state``'s tensors a
    leaf at a time (the same arithmetic), so one leaf's temporaries are
    live at once instead of a second copy of the whole state."""
    step = state["step"] + 1
    lr = lr_schedule(oc)(step)
    gnorm = _global_norm(grads)
    scale = torch.clamp(oc.grad_clip / torch.clamp(gnorm, min=1e-9),
                        max=1.0) if oc.grad_clip else 1.0
    b1, b2 = oc.betas
    bc1 = 1 - torch.pow(b1, step.to(torch.float32))
    bc2 = 1 - torch.pow(b2, step.to(torch.float32))

    def upd(p, g, mu, nu):
        g = g.to(torch.float32) * scale
        mu = b1 * mu + (1 - b1) * g
        nu = b2 * nu + (1 - b2) * g * g
        mhat = mu / bc1
        nhat = nu / bc2
        delta = mhat / (torch.sqrt(nhat) + oc.eps) + \
            oc.weight_decay * p.to(torch.float32)
        new_p = p.to(torch.float32) - lr * delta
        if oc.clip_latent:
            new_p = torch.clamp(new_p, -oc.clip_latent, oc.clip_latent)
        return new_p.to(p.dtype), mu, nu

    flat = [tree_leaves(t) for t in (params, grads, state["mu"],
                                     state["nu"])]
    if len({len(f) for f in flat}) != 1:
        raise ValueError("grads and optimizer state must have the params' "
                         "tree")
    if donate:
        for leaves in zip(*flat):
            for old, new in zip((leaves[0], leaves[2], leaves[3]),
                                upd(*leaves)):
                old.copy_(new)
        state["step"].copy_(step)
        return params, state, {"lr": lr, "grad_norm": gnorm}
    new_p, mu, nu = zip(*(upd(*leaves) for leaves in zip(*flat)))
    new_state = {"step": step, "mu": tree_unflatten(params, mu),
                 "nu": tree_unflatten(params, nu)}
    return tree_unflatten(params, new_p), new_state, {"lr": lr,
                                                      "grad_norm": gnorm}

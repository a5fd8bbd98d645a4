"""Decoder-only LM over paged KV pools (port of the serving half of
``repro.models.transformer``).

Params are nested dicts of tensors in the same tree paths as the
reference's ``init_params`` (``embed``, ``final_norm``, ``lm_head``,
``prefix``, ``scan/b{i}`` stacked over repeats, ``suffix``), so a JAX tree
carries across leaf for leaf (:func:`params_from_numpy`).  The scan over
repeats becomes a Python loop over the stacked leaves' first axis.

Ported so far: dense attention blocks (kind ``"attn"``, the minitron
stack), MLA blocks with a dense MLP or shared + routed experts
(``"mla_dense"``, ``"mla_moe"``, the deepseek-v2 stack) and the ragged
:func:`mixed_step` of the in-kernel backend, with fp pools or
``kv_codec="cluster"`` int8 code pools plus a scale-pool tree.  Other
block kinds raise ``NotImplementedError``.
"""

from __future__ import annotations

import torch

from repro_torch import resolve_device
from repro_torch.models import attention as attn
from repro_torch.models import moe as moe_mod
from repro_torch.models.layers import (embed_init, mlp_apply, mlp_init,
                                       rms_norm, rms_norm_init, softcap)
from repro_torch.tree import params_from_numpy, tree_map  # noqa: F401

MOE_KINDS = ("swa_moe", "mla_moe", "moe")
MLA_KINDS = ("mla_dense", "mla_moe")
PORTED_KINDS = ("attn", "mla_dense", "mla_moe")


def check_supported(cfg) -> None:
    """Raise for configs that need modules this port does not have yet."""
    kinds = set(cfg.prefix_kinds) | set(cfg.scan_pattern) \
        | set(cfg.suffix_kinds)
    missing = sorted(kinds - set(PORTED_KINDS))
    if missing or cfg.post_norms:
        raise NotImplementedError(
            f"{cfg.name}: block kinds {missing or kinds} / post_norms="
            f"{cfg.post_norms} are not ported to repro_torch yet")


# ---------------------------------------------------------------------------
# blocks
# ---------------------------------------------------------------------------

def block_init(kind: str, cfg, gen, dtype, device) -> dict:
    d = cfg.d_model
    p = {"ln1": rms_norm_init(d, dtype, device),
         "attn": (attn.mla_init if kind in MLA_KINDS else attn.attn_init)(
             gen, cfg, dtype, device),
         "ln2": rms_norm_init(d, dtype, device)}
    if kind in MOE_KINDS:
        p["moe"] = moe_mod.moe_init(gen, cfg, dtype, device)
    elif cfg.d_ff:
        p["mlp"] = mlp_init(gen, d, cfg.d_ff, cfg.mlp_act, dtype, device)
    return p


def block_apply(kind: str, cfg, p: dict, x: torch.Tensor, *, cache, pos,
                paged, q_lens=None, scales=None):
    """-> (x, cache), or (x, cache, scales) with ``scales``: attention (GQA,
    or MLA for the MLA kinds) over the page pools, then the MLP (binarised
    when ``cfg.binarize_mlp``, the compressed serving mode) or the MoE.
    ``scales`` holds this block's codec scale pools (same keys as the
    cache) and implies int8 code pools.  The MoE's aux loss is a training
    term: serving computes it and drops it, as the reference's
    ``mixed_step`` does."""
    h = rms_norm(p["ln1"], x, cfg.norm_eps)
    kw = dict(cache=cache, pos=pos, paged=paged, q_lens=q_lens,
              scales=scales)
    if kind in MLA_KINDS:
        y, *state = attn.mla_apply(p["attn"], h, cfg, **kw)
    else:
        y, *state = attn.attn_apply(p["attn"], h, cfg, kind=kind, **kw)
    x = x + y
    if "moe" in p or "mlp" in p:
        h2 = rms_norm(p["ln2"], x, cfg.norm_eps)
        if kind in MOE_KINDS:
            y2, _aux = moe_mod.moe_apply(p["moe"], h2, cfg)
        else:
            y2 = mlp_apply(p["mlp"], h2, cfg.mlp_act,
                           binarized=cfg.binarize_mlp)
        x = x + y2
    return (x, *state)


def block_cache_spec(kind: str, cfg, batch: int, max_len: int) -> dict:
    """Shape/dtype stand-ins (meta tensors) of one block's KV cache."""
    if kind in MLA_KINDS:
        return attn.mla_cache_spec(cfg, batch, max_len)
    window = cfg.window if kind in ("swa", "local") else 0
    length = min(window, max_len) if window else max_len
    shp = (batch, length, cfg.num_kv_heads, cfg.head_dim)
    return {"k": torch.empty(shp, dtype=cfg.torch_dtype, device="meta"),
            "v": torch.empty(shp, dtype=cfg.torch_dtype, device="meta")}


# ---------------------------------------------------------------------------
# parameter / cache trees
# ---------------------------------------------------------------------------

def _stack(trees: list):
    if isinstance(trees[0], dict):
        return {k: _stack([t[k] for t in trees]) for k in trees[0]}
    return torch.stack(trees)


def init_params(cfg, generator: torch.Generator, device="cuda") -> dict:
    """Random params on ``device`` from an explicit generator (which must
    live on that device).  Same tree as the reference; the numbers differ
    from jax.random's — tests carry JAX params over with
    :func:`params_from_numpy` instead."""
    device = resolve_device(device)
    check_supported(cfg)
    dtype = cfg.torch_dtype
    params: dict = {
        "embed": embed_init(generator, cfg.vocab_size, cfg.d_model, dtype,
                            device),
        "final_norm": rms_norm_init(cfg.d_model, dtype, device),
    }
    if not cfg.tie_embeddings:
        params["lm_head"] = embed_init(generator, cfg.vocab_size,
                                       cfg.d_model, dtype, device).T
    params["prefix"] = [block_init(k, cfg, generator, dtype, device)
                        for k in cfg.prefix_kinds]
    reps = [{f"b{i}": block_init(k, cfg, generator, dtype, device)
             for i, k in enumerate(cfg.scan_pattern)}
            for _ in range(cfg.scan_repeats)]
    params["scan"] = _stack(reps) if reps else {}
    params["suffix"] = [block_init(k, cfg, generator, dtype, device)
                        for k in cfg.suffix_kinds]
    return params


def init_cache_specs(cfg, batch: int, max_len: int) -> dict:
    """Meta-tensor stand-ins of the lane cache tree (the reference's
    ShapeDtypeStructs); ``SlotPool`` turns them into page pools."""
    cache: dict = {
        "prefix": [block_cache_spec(k, cfg, batch, max_len)
                   for k in cfg.prefix_kinds],
        "suffix": [block_cache_spec(k, cfg, batch, max_len)
                   for k in cfg.suffix_kinds],
    }
    one = {f"b{i}": block_cache_spec(k, cfg, batch, max_len)
           for i, k in enumerate(cfg.scan_pattern)}
    cache["scan"] = tree_map(
        lambda s: torch.empty((cfg.scan_repeats, *s.shape), dtype=s.dtype,
                              device="meta"), one) if cfg.scan_repeats else {}
    return cache


# ---------------------------------------------------------------------------
# serving step
# ---------------------------------------------------------------------------

def _embed_step(cfg, params, tokens):
    x = params["embed"][tokens]
    if cfg.scale_embeddings:
        x = x * torch.tensor(cfg.d_model ** 0.5, dtype=x.dtype)
    return x


def _unembed(cfg, params, x):
    """x: final-norm'd hidden -> softcapped f32 logits."""
    head = params["embed"].T if cfg.tie_embeddings else params["lm_head"]
    return softcap(x @ head, cfg.final_logit_softcap).float()


def _run_stack(cfg, params, cache, x, *, pos, ctx, q_lens, scales=None):
    """prefix + scan repeats + suffix blocks over the page pools and, under
    the codec, the scale pools (a tree mirroring ``cache``), which each
    block updates in place -> x.  Scan-stacked pools are sliced per repeat
    (``a[r]``, a view), so every write lands in the caller's trees."""
    def block(kind, p, x, at):
        return block_apply(kind, cfg, p, x, cache=at(cache), pos=pos,
                           paged=ctx, q_lens=q_lens,
                           scales=None if scales is None else at(scales))[0]

    for i, kind in enumerate(cfg.prefix_kinds):
        x = block(kind, params["prefix"][i], x, lambda t: t["prefix"][i])
    for r in range(cfg.scan_repeats):
        for i, kind in enumerate(cfg.scan_pattern):
            x = block(kind, tree_map(lambda a: a[r], params["scan"][f"b{i}"]),
                      x, lambda t: tree_map(lambda a: a[r],
                                            t["scan"][f"b{i}"]))
    for i, kind in enumerate(cfg.suffix_kinds):
        x = block(kind, params["suffix"][i], x, lambda t: t["suffix"][i])
    return x


def mixed_step(cfg, params, cache, table, tokens, poss, q_lens, *,
               paged_flags: tuple, page_size: int, pages_per_step: int = 1,
               scales=None):
    """One mixed serving step for every slot straight over the page pools:
    slot ``s`` contributes ``q_lens[s]`` tokens — a prefill chunk, one
    decode token, or nothing — out of the padded block ``tokens`` (S, Q),
    starting at position ``poss[s]``.

    ``cache`` has the tree of :func:`init_cache_specs` with every leaf a
    physical page pool ``(repeats?, n_pages, page, KH, D)`` (MLA:
    ``(repeats?, n_pages, page, r_kv)`` and ``(..., dr)``); ``table``
    (S, P) maps logical to physical pages.  The pools are updated in place
    and returned.  -> (logits (S, Q, V) f32, cache); rows past
    ``q_lens[s]`` are padding the caller ignores.

    ``scales`` (``kv_codec="cluster"``): the scale-pool tree, same tree as
    ``cache`` with f32 ``(repeats?, n_pages, page)`` pools, beside int8
    code pools; it is updated in place too and the return grows to
    ``(logits, cache, scales)``."""
    if not all(paged_flags):
        raise NotImplementedError("lane-backed (non-pageable) cache leaves "
                                  "are not ported yet")
    if pages_per_step != 1:
        raise NotImplementedError("pages_per_step > 1 is not ported yet")
    ctx = attn.PagedContext(table=table, page_size=page_size)
    x = _embed_step(cfg, params, tokens)
    x = _run_stack(cfg, params, cache, x, pos=poss, ctx=ctx, q_lens=q_lens,
                   scales=scales)
    x = rms_norm(params["final_norm"], x, cfg.norm_eps)
    if scales is not None:
        return _unembed(cfg, params, x), cache, scales
    return _unembed(cfg, params, x), cache

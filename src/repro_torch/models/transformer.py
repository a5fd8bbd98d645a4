"""Decoder-only LM (port of ``repro.models.transformer``).

Params are nested dicts of tensors in the same tree paths as the
reference's ``init_params`` (``embed``, ``final_norm``, ``lm_head``,
``prefix``, ``scan/b{i}`` stacked over repeats, ``suffix``), so a JAX tree
carries across leaf for leaf (:func:`params_from_numpy`).  The scan over
repeats becomes a Python loop over the stacked leaves' first axis.

Ported: dense attention blocks (kinds ``"attn"`` and ``"global"``, full
history, and ``"swa"``, ``"local"`` and ``"attn_local"``, a sliding
window), the Mixtral block (``"swa_moe"``: a sliding window and routed
experts), gemma2's sandwich norms (``cfg.post_norms``), MLA blocks with a
dense MLP or shared + routed experts (``"mla_dense"``, ``"mla_moe"``, the
deepseek-v2 stack), the recurrent blocks (``"ssm"``: mamba2's SSD mixer
without an MLP; ``"rglru"``: recurrentgemma's RG-LRU mixer and its MLP),
the encoder-decoder's blocks (``"bidir"``, ``"dec"`` with cross-attention;
the stack itself is ``models.encdec``), paligemma's vision prefix
(bidirectional, spliced before the scaled text embeddings), and every
step function of the reference's serving and scoring
paths: :func:`forward`/:func:`backbone` without a cache, monolithic
:func:`prefill`, :func:`prefill_chunk`, :func:`decode_step` and the
speculative :func:`verify_step` over lane caches (``kv_quant`` rounds
new K/V through the codec, as the gathered backend does under
``kv_codec="cluster"``), and the ragged
:func:`mixed_step` of the in-kernel backend over page pools, fp or int8
code pools plus a scale-pool tree, with rolling-window lanes beside them.
Caches are updated in place.  Training is :func:`loss_fn` through
autograd, with each scan repeat recomputed in the backward under
``cfg.remat`` (:func:`remat_wrap`).  Other block kinds raise
``NotImplementedError``.
"""

from __future__ import annotations

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch import resolve_device
from repro_torch.models import attention as attn
from repro_torch.models import moe as moe_mod
from repro_torch.models import rglru as rglru_mod
from repro_torch.models import ssm as ssm_mod
from repro_torch.models.layers import (chunked_cross_entropy, embed_init,
                                       mlp_apply, mlp_init, rms_norm,
                                       rms_norm_init, softcap)
from repro_torch.tree import (params_from_numpy, tree_leaves,  # noqa: F401
                              tree_map)

MOE_KINDS = ("swa_moe", "mla_moe", "moe")
MLA_KINDS = ("mla_dense", "mla_moe")
PORTED_KINDS = ("attn", "swa", "local", "global", "swa_moe", "mla_dense",
                "mla_moe", "ssm", "rglru", "attn_local", "bidir", "dec")


def check_supported(cfg) -> None:
    """Raise for configs that need modules this port does not have yet."""
    kinds = set(cfg.prefix_kinds) | set(cfg.scan_pattern) \
        | set(cfg.suffix_kinds)
    missing = sorted(kinds - set(PORTED_KINDS))
    if missing:
        raise NotImplementedError(
            f"{cfg.name}: block kinds {missing} are not ported to "
            f"repro_torch yet")


def remat_wrap(cfg, fn):
    """``fn`` under ``torch.utils.checkpoint`` when ``cfg.remat``: a scan
    repeat keeps only its input and is recomputed in the backward.  The
    reference's ``remat_policy="dots"`` (keep the matmul outputs) is a jax
    checkpoint policy with no torch counterpart and is taken as
    ``"full"``.  Without autograd recording (serving) ``fn`` runs as is."""
    if not cfg.remat:
        return fn

    def wrapped(*args):
        if not torch.is_grad_enabled():
            return fn(*args)
        return checkpoint(fn, *args, use_reentrant=False)
    return wrapped


def _attn_kind(kind: str) -> str:
    """Map block kind -> attention variant (the reference's map)."""
    return {"swa": "swa", "swa_moe": "swa", "local": "local",
            "attn_local": "local", "bidir": "bidir"}.get(kind, "attn")


# ---------------------------------------------------------------------------
# blocks
# ---------------------------------------------------------------------------

def block_init(kind: str, cfg, gen, dtype, device) -> dict:
    d = cfg.d_model
    p = {"ln1": rms_norm_init(d, dtype, device)}
    if kind == "ssm":
        p["mixer"] = ssm_mod.ssm_init(gen, cfg, dtype, device)
        return p
    if kind == "rglru":
        p["mixer"] = rglru_mod.rglru_init(gen, cfg, dtype, device)
    else:
        p["attn"] = (attn.mla_init if kind in MLA_KINDS
                     else attn.attn_init)(gen, cfg, dtype, device)
    if kind == "dec":
        p["ln_cross"] = rms_norm_init(d, dtype, device)
        p["cross"] = attn.cross_attn_init(gen, cfg, dtype, device)
    p["ln2"] = rms_norm_init(d, dtype, device)
    if kind in MOE_KINDS:
        p["moe"] = moe_mod.moe_init(gen, cfg, dtype, device)
    elif cfg.d_ff:
        p["mlp"] = mlp_init(gen, d, cfg.d_ff, cfg.mlp_act, dtype, device)
    if cfg.post_norms:
        p["post_ln1"] = rms_norm_init(d, dtype, device)
        p["post_ln2"] = rms_norm_init(d, dtype, device)
    return p


def block_apply(kind: str, cfg, p: dict, x: torch.Tensor, *, cache=None,
                pos=None, prefix_len: int = 0, paged=None, q_lens=None,
                scales=None, kv_quant: bool = False,
                per_lane: bool = False, enc_out=None):
    """-> (x, aux loss, None for a block without an MoE): the mixer
    (attention, GQA or MLA for the MLA kinds; or the recurrent ``ssm``,
    which has no MLP, or ``rglru``), for ``"dec"`` cross-attention over
    ``enc_out`` (a prefill, which caches its K/V) or over the cached
    cross K/V (one token and no ``enc_out``: decode), then the MLP
    (binarised when
    ``cfg.binarize_mlp``, the compressed serving mode) or the MoE, each
    output normed again under ``cfg.post_norms`` before the residual add.
    ``cache`` (and under the codec ``scales``, this block's scale pools
    with the cache's keys, implying int8 code pools) is updated in place; ``paged`` says it holds page pools, else lanes
    (see ``attention.attn_apply``).  ``per_lane`` runs every batch row as
    its own batch-1 sequence, as the reference's vmap over slots does:
    the MoE then shares no capacity across rows."""
    h = rms_norm(p["ln1"], x, cfg.norm_eps)
    if kind == "ssm":
        y, _ = ssm_mod.ssm_apply(p["mixer"], h, cfg, cache=cache, pos=pos,
                                 q_lens=q_lens)
        return x + y, None
    kw = dict(cache=cache, pos=pos, paged=paged, q_lens=q_lens,
              scales=scales, kv_quant=kv_quant)
    if kind == "rglru":
        y, _ = rglru_mod.rglru_apply(p["mixer"], h, cfg, cache=cache,
                                     pos=pos, q_lens=q_lens)
    elif kind in MLA_KINDS:
        y = attn.mla_apply(p["attn"], h, cfg, **kw)[0]
    else:
        if kind == "dec" and cache is not None:
            kw["cache"] = cache["self"]
        y = attn.attn_apply(p["attn"], h, cfg, kind=_attn_kind(kind),
                            prefix_len=prefix_len, **kw)[0]
    if cfg.post_norms:
        y = rms_norm(p["post_ln1"], y, cfg.norm_eps)
    x = x + y
    if kind == "dec":                     # cross-attention sub-layer
        hc = rms_norm(p["ln_cross"], x, cfg.norm_eps)
        # the cached cross K/V serve decode; a prefill computes them from
        # enc_out and caches them
        decode_mode = x.shape[1] == 1 and enc_out is None
        yc, cross_kv = attn.cross_attn_apply(
            p["cross"], hc, cfg, enc_out=enc_out,
            enc_kv=cache["cross"] if decode_mode and cache is not None
            else None)
        x = x + yc
        if cache is not None and not decode_mode:
            for name in ("k", "v"):
                cache["cross"][name].copy_(cross_kv[name])
    aux = None
    if "moe" in p or "mlp" in p:
        h2 = rms_norm(p["ln2"], x, cfg.norm_eps)
        if kind in MOE_KINDS:
            y2, aux = moe_mod.moe_apply(p["moe"], h2, cfg,
                                        regroup=not per_lane)
        else:
            y2 = mlp_apply(p["mlp"], h2, cfg.mlp_act,
                           binarized=cfg.binarize_mlp)
        if cfg.post_norms:
            y2 = rms_norm(p["post_ln2"], y2, cfg.norm_eps)
        x = x + y2
    return x, aux


def block_cache_spec(kind: str, cfg, batch: int, max_len: int) -> dict:
    """Shape/dtype stand-ins (meta tensors) of one block's cache: KV, or
    the recurrent state (``ssm``, ``rglru``), or for ``"dec"`` its
    self-attention KV beside the cross K/V of ``encoder_seq`` rows."""
    if kind == "ssm":
        return ssm_mod.ssm_cache_spec(cfg, batch)
    if kind == "rglru":
        return rglru_mod.rglru_cache_spec(cfg, batch)
    if kind in MLA_KINDS:
        return attn.mla_cache_spec(cfg, batch, max_len)
    if kind == "dec":
        shp = (batch, cfg.encoder_seq, cfg.num_kv_heads, cfg.head_dim)
        return {"self": attn.attn_cache_spec(cfg, "attn", batch, max_len),
                "cross": {n: torch.empty(shp, dtype=cfg.torch_dtype,
                                         device="meta") for n in ("k", "v")}}
    return attn.attn_cache_spec(cfg, _attn_kind(kind), batch, max_len)


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


def init_cache(cfg, batch: int, max_len: int, device="cuda") -> dict:
    """A zeroed lane cache tree on ``device``: leaves ``(batch, max_len,
    ...)`` (a rolling window's ``min(window, max_len)`` rows), scan-stacked
    leaves with a leading repeats axis."""
    device = resolve_device(device)
    return tree_map(lambda s: torch.zeros(s.shape, dtype=s.dtype,
                                          device=device),
                    init_cache_specs(cfg, batch, max_len))


# ---------------------------------------------------------------------------
# serving step
# ---------------------------------------------------------------------------

def _embed_step(cfg, params, tokens):
    x = params["embed"][tokens]
    if cfg.scale_embeddings:
        x = x * torch.tensor(cfg.d_model ** 0.5, dtype=x.dtype)
    return x


def _embed(cfg, params, tokens, vision_embeds=None):
    """A prompt's embeddings: the (scaled) text embeddings behind the
    unscaled vision embeddings (paligemma's prefix), when given."""
    x = _embed_step(cfg, params, tokens)
    if vision_embeds is not None:
        x = torch.cat([vision_embeds.to(x.dtype), x], dim=1)
    return x


def _unembed(cfg, params, x):
    """x: final-norm'd hidden -> softcapped f32 logits."""
    head = params["embed"].T if cfg.tie_embeddings else params["lm_head"]
    return softcap(x @ head, cfg.final_logit_softcap).float()


def _run_stack(cfg, params, cache, x, *, pos=None, prefix_len: int = 0,
               flags=None, ctx=None, q_lens=None, scales=None,
               kv_quant: bool = False, per_lane: bool = False):
    """prefix + scan repeats + suffix blocks -> (x, the MoE blocks' aux
    losses in block order; only the scoring forward sums them).

    The one block walker behind every step function; they differ in how
    ``x`` is embedded, which positions ride along and which logits are
    kept.  ``cache`` (None: no cache, the scoring forward) holds lanes, or
    page pools with ``ctx`` (an ``attention.PagedContext``) beside lanes:
    ``flags`` (a tree of bools mirroring ``cache``) says which leaves are
    pools, and a block whose leaves are all pools runs on them with
    ``ctx``, one whose leaves are all lanes on its lanes.  ``scales`` (the
    codec's scale-pool tree mirroring ``cache``, None at lane leaves)
    rides the pools.  Every block updates its part in place: scan-stacked
    leaves are sliced per repeat (``a[r]``, a view), so writes land in the
    caller's trees."""
    def block_ctx(f):
        leaves = tree_leaves(f)
        assert all(leaves) or not any(leaves), \
            "mixed paged/lane cache leaves within one block"
        return ctx if leaves and all(leaves) else None

    def block(kind, p, x, sub, leaf=lambda a: a):
        # ``sub`` picks the block's subtree of a cache-shaped tree, ``leaf``
        # slices each of its leaves (a scan repeat)
        paged = None if flags is None else block_ctx(sub(flags))
        return block_apply(
            kind, cfg, p, x,
            cache=None if cache is None else tree_map(leaf, sub(cache)),
            pos=pos, prefix_len=prefix_len, paged=paged, q_lens=q_lens,
            scales=None if scales is None or paged is None
            else tree_map(leaf, sub(scales)),
            kv_quant=kv_quant, per_lane=per_lane)

    def repeat(r, x):
        out = []
        for i, kind in enumerate(cfg.scan_pattern):
            x, a = block(kind, tree_map(lambda t: t[r],
                                        params["scan"][f"b{i}"]), x,
                         lambda t: t["scan"][f"b{i}"], lambda a: a[r])
            out.append(a)
        return x, out

    auxes = []
    for i, kind in enumerate(cfg.prefix_kinds):
        x, a = block(kind, params["prefix"][i], x, lambda t: t["prefix"][i])
        auxes.append(a)
    # the scoring forward (no cache) recomputes a repeat in the backward
    run = repeat if cache is not None else remat_wrap(cfg, repeat)
    for r in range(cfg.scan_repeats):
        x, a = run(r, x)
        auxes += a
    for i, kind in enumerate(cfg.suffix_kinds):
        x, a = block(kind, params["suffix"][i], x, lambda t: t["suffix"][i])
        auxes.append(a)
    return x, [a for a in auxes if a is not None]


def backbone(cfg, params, tokens, *, vision_embeds=None):
    """Embed + layer stack + final norm, no cache -> (hidden (B, S*, D),
    aux loss).  ``vision_embeds`` (B, V, D) is a bidirectional prefix
    before the text (S* = V + S)."""
    prefix_len = vision_embeds.shape[1] if vision_embeds is not None else 0
    x, auxes = _run_stack(cfg, params, None,
                          _embed(cfg, params, tokens, vision_embeds),
                          prefix_len=prefix_len)
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    for a in auxes:
        aux = aux + a
    return rms_norm(params["final_norm"], x, cfg.norm_eps), aux


def forward(cfg, params, tokens, *, vision_embeds=None):
    """Scoring forward -> (logits (B, S*, V) f32, aux loss)."""
    x, aux = backbone(cfg, params, tokens, vision_embeds=vision_embeds)
    return _unembed(cfg, params, x), aux


def loss_fn(cfg, params, batch) -> torch.Tensor:
    """Training loss of ``batch`` (``tokens``, ``labels`` (B, S), and
    paligemma's ``vision_embeds``): the chunked CE of the text positions
    (the vision rows are dropped before the head) plus 0.01 x the summed
    MoE aux losses."""
    vision = batch.get("vision_embeds")
    hidden, aux = backbone(cfg, params, batch["tokens"],
                           vision_embeds=vision)
    if vision is not None:
        hidden = hidden[:, vision.shape[1]:]
    head = params["embed"].T if cfg.tie_embeddings else params["lm_head"]
    ce = chunked_cross_entropy(hidden, head, batch["labels"],
                               softcap_val=cfg.final_logit_softcap)
    return ce + 0.01 * aux


def prefill(cfg, params, tokens, cache, *, vision_embeds=None):
    """The whole prompt ``tokens`` (B, S) from position 0, behind the
    bidirectional ``vision_embeds`` prefix (B, V, D) when given -> (last-
    token logits (B, 1, V), ``cache`` filled in place: V + S rows)."""
    prefix_len = vision_embeds.shape[1] if vision_embeds is not None else 0
    x, _ = _run_stack(cfg, params, cache,
                      _embed(cfg, params, tokens, vision_embeds),
                      prefix_len=prefix_len)
    x = rms_norm(params["final_norm"], x[:, -1:], cfg.norm_eps)
    return _unembed(cfg, params, x), cache


def prefill_chunk(cfg, params, cache, tokens, pos, *,
                  kv_quant: bool = False):
    """One prefill chunk ``tokens`` (B, S) at absolute positions
    ``pos``..``pos + S - 1`` against a partially filled lane cache ->
    (last-position logits (B, 1, V), cache updated in place).

    Feeding a prompt's chunks here in order is the gathered backend's
    chunk loop (the reference's oracle of chunked prefill); ``kv_quant``
    rounds the chunk's K/V through the codec so later chunks attend to
    the values the code pools will hold."""
    x, _ = _run_stack(cfg, params, cache, _embed_step(cfg, params, tokens),
                      pos=pos, kv_quant=kv_quant)
    x = rms_norm(params["final_norm"], x[:, -1:], cfg.norm_eps)
    return _unembed(cfg, params, x), cache


def decode_step(cfg, params, cache, tokens, pos, *, kv_quant: bool = False,
                per_lane: bool = False):
    """One token per lane, ``tokens`` (B, 1) at ``pos`` (shared, or per
    lane ``(B,)``), over a filled lane cache -> (logits (B, 1, V), cache
    updated in place).

    ``kv_quant`` rounds the new row's K/V through the codec before it is
    written and attended (quantise-then-attend, the kernel's numerics).
    ``per_lane`` decodes every lane as its own sequence — the reference's
    per-slot decode, a vmap of this function over slots — so lanes share
    no MoE capacity."""
    x, _ = _run_stack(cfg, params, cache, _embed_step(cfg, params, tokens),
                      pos=pos, kv_quant=kv_quant, per_lane=per_lane)
    x = rms_norm(params["final_norm"], x, cfg.norm_eps)
    return _unembed(cfg, params, x), cache


def verify_step(cfg, params, cache, tokens, pos, q_lens, *,
                kv_quant: bool = False, per_lane: bool = False):
    """Speculative verification: ``tokens`` (B, S) at absolute positions
    ``pos``..``pos + S - 1`` (shared, or per lane ``(B,)``) against a
    partially filled lane cache -> (full logits (B, S, V), cache updated
    in place).

    :func:`prefill_chunk` with every position's logits kept (row ``i``
    checks draft token ``i + 1``) and a ragged block: lane ``b``
    contributes ``q_lens[b]`` real tokens, and rows past that are padding
    whose cache writes are dropped and whose logits are garbage; a lane
    with ``q_lens[b] == 0`` leaves its cache as it was.  ``per_lane``
    scores every lane as its own sequence — the reference vmaps this
    function over slots — so lanes share no MoE capacity."""
    x, _ = _run_stack(cfg, params, cache, _embed_step(cfg, params, tokens),
                      pos=pos, q_lens=q_lens, kv_quant=kv_quant,
                      per_lane=per_lane)
    x = rms_norm(params["final_norm"], x, cfg.norm_eps)
    return _unembed(cfg, params, x), cache


def mixed_step(cfg, params, cache, table, tokens, poss, q_lens, *,
               paged_flags: tuple, page_size: int, pages_per_step: int = 1,
               scales=None):
    """One mixed serving step for every slot straight over the page pools:
    slot ``s`` contributes ``q_lens[s]`` tokens — a prefill chunk, one
    decode token, or nothing — out of the padded block ``tokens`` (S, Q),
    starting at position ``poss[s]``.

    ``cache`` has the tree of :func:`init_cache_specs`; ``paged_flags``
    (one bool a leaf, in :func:`tree_leaves` order, from
    ``models.api.cache_layout``) says which leaves are page pools.  A
    pageable leaf is a physical page pool ``(repeats?, n_pages, page, KH,
    D)`` (MLA: ``(repeats?, n_pages, page, r_kv)`` and ``(..., dr)``) shared
    by all slots; ``table`` (S, P) maps logical to physical pages and the
    kernel walks it.  Any other leaf is a rolling-window lane per slot,
    ``(repeats?, S, W, KH, D)``: its block runs the lane chunk attention
    with ragged ``q_lens``, writing after attending and dropping the rows
    past ``q_lens``, in the same step.  The pools and lanes are updated in
    place and returned.  -> (logits (S, Q, V) f32, cache); rows past
    ``q_lens[s]`` are padding the caller ignores.

    ``scales`` (``kv_codec="cluster"``): the scale-pool tree, same tree as
    ``cache`` with f32 ``(repeats?, n_pages, page)`` pools at the pageable
    leaves (beside int8 code pools) and None at the lanes, which stay raw;
    it is updated in place too and the return grows to ``(logits, cache,
    scales)``."""
    if pages_per_step != 1:
        raise NotImplementedError("pages_per_step > 1 is not ported yet")
    specs = init_cache_specs(cfg, 1, page_size)
    flat = iter(paged_flags)
    flags = tree_map(lambda _: next(flat), specs)
    ctx = attn.PagedContext(table=table, page_size=page_size)
    x, _ = _run_stack(cfg, params, cache, _embed_step(cfg, params, tokens),
                      pos=poss, flags=flags, ctx=ctx, q_lens=q_lens,
                      scales=scales)
    x = rms_norm(params["final_norm"], x, cfg.norm_eps)
    if scales is not None:
        return _unembed(cfg, params, x), cache, scales
    return _unembed(cfg, params, x), cache

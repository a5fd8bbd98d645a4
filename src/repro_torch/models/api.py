"""Model API: the entry points the runtime and the trainer call, family by
family, and the cache-layout probe (port of ``repro.models.api``)."""

from __future__ import annotations

import dataclasses
from typing import Any, Callable

from repro_torch.models import encdec, transformer
from repro_torch.tree import tree_leaves

# the attention backends this port serves with: "gathered" copies each
# slot's pages into a contiguous lane view per step and runs plain PyTorch
# attention over it (the reference's oracle), "cuda_paged" hands the page
# pools and page tables to mixed_step, whose CUDA kernel walks the table
ATTN_BACKENDS = ("gathered", "cuda_paged")

# block kinds whose caches can resume a prompt mid-prefill
CHUNKABLE_KINDS = frozenset(
    ("attn", "swa", "local", "global", "attn_local",
     "mla_dense", "mla_moe", "swa_moe", "moe", "ssm", "rglru"))

# block kinds the paged attention backend can serve
PAGEABLE_KINDS = frozenset(
    ("attn", "swa", "local", "global", "attn_local",
     "mla_dense", "mla_moe", "swa_moe", "moe"))


@dataclasses.dataclass(frozen=True)
class ModelAPI:
    init_params: Callable[..., Any]          # (cfg, generator, device)
    forward: Callable[..., Any]              # (cfg, params, tokens, *extra)
    prefill: Callable[..., Any]
    # (cfg, params, tokens, cache, *extra); extra: the audio family's
    # frame embeddings (the vlm's vision embeddings ride as a keyword)
    decode_step: Callable[..., Any]
    # (cfg, params, lane cache, tokens (B, 1), pos, *, kv_quant, per_lane)
    init_cache_specs: Callable[..., Any]     # (cfg, batch, max_len)
    init_cache: Callable[..., Any]           # (cfg, batch, max_len, device)
    loss_fn: Callable[..., Any]              # (cfg, params, batch) -> loss
    prefill_chunk: Callable[..., Any] | None = None
    # (cfg, params, lane cache, tokens (B, S), pos, *, kv_quant); the
    # gathered backend's chunk step over a standalone batch-1 cache; None
    # when the family cannot resume a prompt mid-cache (encoder-decoder)
    mixed_step: Callable[..., Any] | None = None
    # (cfg, params, paged cache, table, tokens (S, Q), poss (S,),
    #  q_lens (S,), *, paged_flags, page_size) -> (logits (S, Q, V), cache);
    # None when the family cannot consume a paged cache (encoder-decoder)
    verify_step: Callable[..., Any] | None = None
    # (cfg, params, lane cache, tokens (B, S), pos, q_lens (B,), *,
    #  kv_quant, per_lane) -> (full logits (B, S, V), cache); speculative
    # verification of ragged draft blocks; None for the encoder-decoder


def _kinds(cfg) -> tuple:
    return (tuple(cfg.prefix_kinds) + tuple(cfg.scan_pattern)
            + tuple(cfg.suffix_kinds))


def supports_chunked_prefill(cfg) -> bool:
    """True if every block resumes a prompt mid-cache and no multimodal
    prefix is spliced into the prompt."""
    if cfg.family in ("vlm", "audio"):
        return False
    return all(k in CHUNKABLE_KINDS for k in _kinds(cfg))


def supports_speculation(cfg) -> bool:
    """True if ``cfg`` can decode speculatively: drafts are verified by
    the resume-from-cache machinery chunked prefill uses, so the gate is
    the same."""
    return supports_chunked_prefill(cfg)


def supports_paged_attention(cfg) -> bool:
    """True if every block keeps an attention-style cache."""
    if cfg.family == "audio":
        return False
    return all(k in PAGEABLE_KINDS for k in _kinds(cfg))


def supports_prefix_share(cfg) -> bool:
    """True if ``cfg`` can map shared prefix KV pages into a request's
    page table: chunked prefill resumes, the paged backend serves it, and
    every cache leaf pages.  Rolling-window kinds keep lane leaves that a
    shared page cannot carry, so they are excluded by kind, as in the
    reference."""
    if not supports_chunked_prefill(cfg) or \
            not supports_paged_attention(cfg):
        return False
    windowed = ("swa", "local", "attn_local", "swa_moe")
    return all(k in PAGEABLE_KINDS and k not in windowed
               for k in _kinds(cfg))


def cache_layout(api: ModelAPI, cfg, slot_len: int):
    """Probe the cache-spec factory for each leaf's memory role ->
    ``(batch_axes, len_axes)``, aligned with the leaves of
    ``api.init_cache_specs(cfg, 1, slot_len)``: the axis that scales with
    the batch argument, and the axis that scales with cache length (None
    for leaves that do not, which are not pageable)."""
    leaves_a = tree_leaves(api.init_cache_specs(cfg, 1, slot_len))
    leaves_l = tree_leaves(api.init_cache_specs(cfg, 1, 2 * slot_len))
    leaves_b = tree_leaves(api.init_cache_specs(cfg, 2, slot_len))
    batch_axes, len_axes = [], []
    for sa, sl, sb in zip(leaves_a, leaves_l, leaves_b):
        bdiff = [i for i, (a, b) in enumerate(zip(sa.shape, sb.shape))
                 if a != b]
        assert len(bdiff) == 1 and sa.shape[bdiff[0]] == 1, \
            (sa.shape, sb.shape)
        batch_axes.append(bdiff[0])
        if sa.shape == sl.shape:
            len_axes.append(None)
            continue
        ldiff = [i for i, (a, b) in enumerate(zip(sa.shape, sl.shape))
                 if a != b]
        assert len(ldiff) == 1 and sa.shape[ldiff[0]] == slot_len, \
            (sa.shape, sl.shape)
        len_axes.append(ldiff[0])
    return tuple(batch_axes), tuple(len_axes)


def get_model(cfg) -> ModelAPI:
    transformer.check_supported(cfg)
    if cfg.family == "audio":
        return ModelAPI(init_params=encdec.init_params,
                        forward=encdec.forward, prefill=encdec.prefill,
                        decode_step=encdec.decode_step,
                        init_cache_specs=encdec.init_cache_specs,
                        init_cache=encdec.init_cache,
                        loss_fn=encdec.loss_fn)
    return ModelAPI(init_params=transformer.init_params,
                    forward=transformer.forward, prefill=transformer.prefill,
                    decode_step=transformer.decode_step,
                    prefill_chunk=transformer.prefill_chunk,
                    init_cache_specs=transformer.init_cache_specs,
                    init_cache=transformer.init_cache,
                    loss_fn=transformer.loss_fn,
                    mixed_step=transformer.mixed_step,
                    verify_step=transformer.verify_step)

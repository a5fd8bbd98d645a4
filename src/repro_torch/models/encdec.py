"""Whisper-style encoder-decoder backbone (port of ``repro.models.encdec``;
the audio frontend is a stub).

The encoder is the bidirectional transformer stack over precomputed frame
embeddings (B, Se, D); the decoder is causal with cross-attention, and
:func:`loss_fn` trains both.  As in the reference, positions use the shared substrate's RoPE rather than
Whisper's sinusoids.  Serving prefills the decoder prompt with the encoder
run once, caching each layer's cross K/V ``(B, Se, KH, hd)`` beside its
self-attention KV, and decodes against the cached cross K/V.  Caches are
updated in place; the stacks are Python loops over the stacked layers.
"""

from __future__ import annotations

import torch

from repro_torch import resolve_device
from repro_torch.models.layers import (chunked_cross_entropy, embed_init,
                                       rms_norm, rms_norm_init, softcap)
from repro_torch.models.transformer import (_stack, block_apply,
                                            block_cache_spec, block_init,
                                            remat_wrap)
from repro_torch.tree import tree_leaves, tree_map


def init_params(cfg, generator: torch.Generator, device="cuda") -> dict:
    """Random params on ``device`` in the reference's tree (``embed``,
    ``enc_scan/b0``, ``enc_norm``, ``scan/b0``, ``final_norm``)."""
    device = resolve_device(device)
    dtype = cfg.torch_dtype
    return {
        "embed": embed_init(generator, cfg.vocab_size, cfg.d_model, dtype,
                            device),
        "enc_scan": _stack([{"b0": block_init("bidir", cfg, generator, dtype,
                                              device)}
                            for _ in range(cfg.encoder_layers)]),
        "enc_norm": rms_norm_init(cfg.d_model, dtype, device),
        "scan": _stack([{"b0": block_init("dec", cfg, generator, dtype,
                                          device)}
                        for _ in range(cfg.num_layers)]),
        "final_norm": rms_norm_init(cfg.d_model, dtype, device),
    }


def _layers(stacked: dict):
    """The per-layer subtrees of a stack whose leaves lead with layers."""
    n = tree_leaves(stacked)[0].shape[0]
    return [tree_map(lambda a, r=r: a[r], stacked) for r in range(n)]


def encode(cfg, params, frame_embeds: torch.Tensor) -> torch.Tensor:
    """Frame embeddings (B, Se, D) -> the normed encoder output (each
    layer recomputed in the backward under ``cfg.remat``)."""
    x = frame_embeds.to(cfg.torch_dtype)
    layer = remat_wrap(cfg, lambda p, x: block_apply("bidir", cfg, p, x)[0])
    for p in _layers(params["enc_scan"]):
        x = layer(p["b0"], x)
    return rms_norm(params["enc_norm"], x, cfg.norm_eps)


def _decoder_hidden(cfg, params, tokens, frame_embeds):
    """Encoder, then the causal decoder over ``tokens`` with no cache ->
    the final-normed hidden (B, S, D)."""
    enc_out = encode(cfg, params, frame_embeds)
    layer = remat_wrap(cfg, lambda p, x: block_apply(
        "dec", cfg, p, x, enc_out=enc_out)[0])
    x = params["embed"][tokens]
    for p in _layers(params["scan"]):
        x = layer(p["b0"], x)
    return rms_norm(params["final_norm"], x, cfg.norm_eps)


def _logits(cfg, params, x):
    return softcap((x @ params["embed"].T).float(), cfg.final_logit_softcap)


def forward(cfg, params, tokens, frame_embeds):
    """Scoring forward -> (logits (B, S, V) f32, aux = 0)."""
    x = _decoder_hidden(cfg, params, tokens, frame_embeds)
    return _logits(cfg, params, x), torch.zeros((), dtype=torch.float32,
                                                device=x.device)


def loss_fn(cfg, params, batch) -> torch.Tensor:
    """Chunked CE of the decoder over ``batch`` (``tokens``, ``labels``,
    ``frame_embeds``), the tied embedding as the head."""
    hidden = _decoder_hidden(cfg, params, batch["tokens"],
                             batch["frame_embeds"])
    return chunked_cross_entropy(hidden, params["embed"].T, batch["labels"],
                                 softcap_val=cfg.final_logit_softcap)


def init_cache_specs(cfg, batch: int, max_len: int) -> dict:
    """Meta-tensor stand-ins of the decoder's lane cache: per layer the
    self-attention KV (length ``max_len``) and the cross K/V (length
    ``encoder_seq``), stacked over the decoder layers."""
    one = {"b0": block_cache_spec("dec", cfg, batch, max_len)}
    return {"scan": tree_map(
        lambda s: torch.empty((cfg.num_layers, *s.shape), dtype=s.dtype,
                              device="meta"), one)}


def init_cache(cfg, batch: int, max_len: int, device="cuda") -> dict:
    device = resolve_device(device)
    return tree_map(lambda s: torch.zeros(s.shape, dtype=s.dtype,
                                          device=device),
                    init_cache_specs(cfg, batch, max_len))


def _decoder(cfg, params, cache, x, **kw):
    for p, c in zip(_layers(params["scan"]), _layers(cache["scan"])):
        x, _ = block_apply("dec", cfg, p["b0"], x, cache=c["b0"], **kw)
    return x


def prefill(cfg, params, tokens, cache, frame_embeds):
    """The encoder once, then the decoder prompt ``tokens`` (B, S) ->
    (last-token logits (B, 1, V), ``cache`` filled in place with the
    self-attention KV and every layer's cross K/V)."""
    enc_out = encode(cfg, params, frame_embeds)
    x = _decoder(cfg, params, cache, params["embed"][tokens],
                 enc_out=enc_out)
    x = rms_norm(params["final_norm"], x[:, -1:], cfg.norm_eps)
    return _logits(cfg, params, x), cache


def decode_step(cfg, params, cache, tokens, pos, *, kv_quant: bool = False,
                per_lane: bool = False):
    """One token per lane at ``pos`` (shared, or per lane ``(B,)``) over
    the cached self-attention KV and cross K/V -> (logits (B, 1, V), cache
    updated in place).  ``per_lane`` changes nothing (no MoE); the
    reference's decoder has no codec path, so ``kv_quant`` is refused."""
    if kv_quant:
        raise NotImplementedError(
            "the encoder-decoder has no kv codec path (nor has the "
            "reference's)")
    x = _decoder(cfg, params, cache, params["embed"][tokens], pos=pos)
    x = rms_norm(params["final_norm"], x, cfg.norm_eps)
    return _logits(cfg, params, x), cache

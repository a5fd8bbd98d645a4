"""Serving launcher of the PyTorch/CUDA port (counterpart of
``repro.launch.serve`` for what the port serves).

The model's MLP projections are binarised, Huffman-compressed into the
WeightStore and rebuilt each step from the decode-tile cache (the decode
kernel runs on misses); requests flow through the slot scheduler.  An
omitted flag means what it means in the reference launcher: gemma2-2b,
the ``gathered`` backend (attention in plain PyTorch over lane views),
monolithic prefill at admission (no ``--prefill-chunk``) and one
monolithic lane per slot (no ``--kv-page-size``).  ``--attn-backend
cuda_paged`` needs ``--kv-page-size``: the paged-attention kernel walks
the page tables, and with ``--prefill-chunk`` every iteration is one
ragged mixed step of prefill chunks and decode tokens over the page
pools (rolling-window lanes beside them), without it each prompt is
prefilled alone and installed into its pages.  ``--kv-codec cluster``
keeps the pages as int8 codebook codes with per-token scales (decoded
inside the kernel, or at gather).  ``--prefix-share`` (with
``--kv-page-size`` and ``--prefill-chunk``) maps cached prompt prefixes'
pages into later requests' page tables and skips their chunks;
``--shared-prefix-len`` gives every prompt a common prefix to reuse.
``--speculate ngram`` or ``draft`` verifies up to ``--draft-k`` draft
tokens a slot a step; ``--prompt-pattern`` tiles each prompt from a
short pattern, the repetitive text where n-gram drafts are accepted.  It
prints the same summary lines as the reference launcher for what it
supports.  An arch that lacks what a flag asks for is downgraded as the
reference downgrades it, with a warning and a ``note:`` line: the
recurrent archs and whisper-large-v3 from ``cuda_paged`` to ``gathered``,
paligemma-3b and whisper from chunked to monolithic prefill.

Observability, as in the reference launcher: ``--trace-out trace.json``
records every request's lifecycle span tree (queued -> admitted ->
prefill chunks -> decode -> retired) plus engine phase spans as
Chrome-trace JSON (open it in ``chrome://tracing`` or ui.perfetto.dev;
``--trace-jsonl`` also dumps the raw events one a line), and
``--metrics-out metrics.prom`` dumps every serving counter, gauge and
histogram as Prometheus text.  A trace output turns on tracing; a metrics
output alone records the phase histograms only.  Both are checked before
exit (one ``request`` span per completed request, the JSON reloads, the
text re-parses) and neither changes the tokens.  The phases are timed on
the host clock: on the card a phase's time is the time to enqueue its
work unless it waits on the device (a token readback does).
``--cache-mb auto`` replays the materialize access pattern over a grid of
capacities and serves at the hit-rate-cliff knee.  The reference's
``--kernel-tune`` is not taken: it tunes TPU launch knobs.

  PYTHONPATH=src python -m repro_torch.launch.serve --scale tiny --device cpu
  PYTHONPATH=src python -m repro_torch.launch.serve --scale tiny \
      --device cuda --attn-backend cuda_paged --kv-page-size 16 \
      --prefill-chunk 16
  PYTHONPATH=src python -m repro_torch.launch.serve --arch deepseek-v2-236b \
      --scale tiny --device cpu --kv-page-size 16 --kv-codec cluster
  PYTHONPATH=src python -m repro_torch.launch.serve --arch minitron-8b \
      --scale full --batch 4 --requests 8 --prompt-len 128 --gen 16 \
      --attn-backend cuda_paged --prefill-chunk 64 --kv-page-size 16
  PYTHONPATH=src python -m repro_torch.launch.serve --arch mixtral-8x22b \
      --scale full --layers 2 --attn-backend cuda_paged \
      --prefill-chunk 64 --kv-page-size 16
  PYTHONPATH=src python -m repro_torch.launch.serve --device cpu \
      --scale tiny --arch minitron-8b --attn-backend cuda_paged \
      --kv-page-size 16 --prefill-chunk 16 --prefix-share \
      --shared-prefix-len 32 --speculate ngram --prompt-pattern 8
  PYTHONPATH=src python -m repro_torch.launch.serve --device cpu \
      --scale tiny --arch recurrentgemma-2b --attn-backend cuda_paged \
      --kv-page-size 16 --prefill-chunk 16
  PYTHONPATH=src python -m repro_torch.launch.serve --device cpu \
      --scale tiny --arch minitron-8b --cache-mb auto \
      --trace-out trace.json --trace-jsonl trace.jsonl \
      --metrics-out metrics.prom

At ``--scale full`` registration compresses every full-width dense MLP
matrix on the host first (about 10 s each on the H100 machine; 64 for
minitron-8b).  deepseek-v2-236b and mixtral-8x22b do not fit one card at
full depth, so their full scale needs a ``--layers`` cut, which keeps
their published widths.
"""

from __future__ import annotations

import argparse
import json
import time

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.configs import base as cfgs
from repro_torch.kernels import kv_codec as kvc
from repro_torch.launch.train import TINY_OVERRIDES, tiny_config  # noqa: F401
from repro_torch.models.api import get_model
from repro_torch.runtime import (Scheduler, ServeEngine, Telemetry,
                                 parse_prom, recommend_store_capacity)
from repro_torch.runtime.decode_cache import POLICIES

# archs whose full depth does not fit one card, and why
TOO_DEEP_FOR_ONE_CARD = {
    "deepseek-v2-236b": "236B parameters, about 472 GB in bf16, against "
                        "80 GB on one H100",
    "mixtral-8x22b": "141B parameters, about 282 GB in bf16, against 80 GB "
                     "on one H100"}


def init_params(cfg, generator: torch.Generator, device):
    """Random params of ``cfg``'s family (``models.api.get_model``)."""
    return get_model(cfg).init_params(cfg, generator, device)


def cut_depth(cfg, layers: int):
    """``cfg`` at its published widths with ``layers`` blocks: the prefix
    and suffix blocks kept, the repeated pattern cut (recurrentgemma: 5 =
    one rglru, rglru, attn_local repeat + its two suffix rglru blocks).
    An encoder-decoder keeps ``layers`` encoder and decoder layers."""
    fixed = len(cfg.prefix_kinds) + len(cfg.suffix_kinds)
    repeats = (layers - fixed) // len(cfg.scan_pattern)
    if repeats < 0 or fixed + repeats * len(cfg.scan_pattern) != layers:
        raise ValueError(f"{cfg.name}: cannot cut to {layers} layers "
                         f"({fixed} fixed + repeats of {cfg.scan_pattern})")
    if cfg.encoder_layers:
        return cfg.scaled(num_layers=layers, scan_repeats=repeats,
                          encoder_layers=layers)
    return cfg.scaled(num_layers=layers, scan_repeats=repeats)


def full_config(arch: str, layers: int | None = None):
    """The published config, depth cut to ``layers`` when given; an arch
    that does not fit one card at full depth needs the cut."""
    cfg = cfgs.get_config(arch)
    if layers is None:
        if arch in TOO_DEEP_FOR_ONE_CARD:
            raise ValueError(
                f"{arch} at full depth ({cfg.num_layers} layers) does not "
                f"fit one card: {TOO_DEEP_FOR_ONE_CARD[arch]}; pass "
                f"--layers N to serve it at its published widths with "
                f"N layers")
        return cfg
    return cut_depth(cfg, layers)


def codec_report(pool, m) -> None:
    """The reference launcher's three codec lines: page bytes and capacity,
    the error bound, and the at-rest Huffman report over the resident int8
    codes (a report only: the pool stays raw int8 for in-kernel decode)."""
    print(f"kv codec (cluster): page {pool.page_bytes_fp} fp bytes -> "
          f"{pool.page_bytes_resident} resident bytes "
          f"({m.kv_capacity_multiplier():.2f}x effective capacity, "
          f"{m.kv_bytes_avoided} resident bytes avoided)")
    print(f"kv codec error bound: {m.kv_codec_error_bound:.3e} "
          f"(max per-token scale / 254)")
    codes = [c.cpu().numpy().ravel() for c in pool.code_pools()]
    if codes:
        rep = kvc.huffman_report(np.concatenate(codes))
        print(f"kv codec at-rest huffman: {rep['avg_bits']:.2f} "
              f"bits/code ({rep['ratio']:.2f}x vs int8), clustered "
              f"{rep['clustered_avg_bits']:.2f} bits "
              f"({rep['clustered_ratio']:.2f}x)")


def _cache_mb(text: str):
    """``--cache-mb``: a capacity in MiB, or ``auto``."""
    if text == "auto":
        return text
    try:
        return float(text)
    except ValueError:
        raise argparse.ArgumentTypeError(
            f"expected a number of MiB or 'auto', got {text!r}") from None


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="gemma2-2b",
                    choices=[a for a in cfgs.PORTED if a != "reactnet"])
    ap.add_argument("--scale", choices=["tiny", "full"], default="tiny")
    ap.add_argument("--layers", type=int, default=None,
                    help="at --scale full: cut the depth to this many "
                         "layers (published widths)")
    ap.add_argument("--device", choices=["cuda", "cpu"], default="cuda",
                    help="cuda runs the CUDA kernels; cpu their plain "
                         "PyTorch versions")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=64)
    ap.add_argument("--gen", type=int, default=32)
    ap.add_argument("--requests", type=int, default=0,
                    help="total requests to serve (default: one full batch)")
    ap.add_argument("--cache-mb", type=_cache_mb, default=None,
                    help="decode-tile cache capacity in MiB (omit = "
                         "unbounded; 0 = caching disabled; 'auto' = sweep "
                         "the materialize access pattern over a capacity "
                         "grid and serve at the hit-rate-cliff knee)")
    ap.add_argument("--policy", choices=sorted(POLICIES), default="lru",
                    help="decode-cache eviction policy")
    ap.add_argument("--mode", choices=["continuous", "wave"],
                    default="continuous",
                    help="slot scheduling: continuous (admit-on-retire) or "
                         "wave (drain before admitting)")
    ap.add_argument("--attn-backend", choices=["gathered", "cuda_paged"],
                    default="gathered",
                    help="gathered (default): pages are copied into "
                         "contiguous lane views each step and attended in "
                         "plain PyTorch (the reference's oracle); "
                         "cuda_paged: the paged-attention kernel walks the "
                         "page tables in place (needs --kv-page-size)")
    ap.add_argument("--prefill-chunk", type=int, default=None,
                    help="prompt chunk size (omit = monolithic prefill at "
                         "admission); under cuda_paged the chunks ride one "
                         "mixed step with the decode tokens")
    ap.add_argument("--prefill-budget", type=int, default=None,
                    help="max prefill tokens per scheduler iteration "
                         "(default: one chunk)")
    ap.add_argument("--kv-page-size", type=int, default=None,
                    help="tokens per KV page (omit = one monolithic lane "
                         "per slot; cuda_paged needs it)")
    ap.add_argument("--kv-pages", type=int, default=None,
                    help="page-pool size (default: fully backs every slot)")
    ap.add_argument("--kv-codec", choices=list(kvc.KV_CODECS),
                    default="none",
                    help="KV page-pool codec: none (fp pages) or cluster "
                         "(int8 codebook codes + per-token f32 scales, "
                         "decoded inside the paged-attention kernel)")
    ap.add_argument("--prefix-share", action="store_true",
                    help="keep completed prompts' KV pages in a prefix "
                         "index; a request extending a cached prefix maps "
                         "the shared pages and skips that prefill "
                         "(copy-on-write guards them; needs "
                         "--kv-page-size and --prefill-chunk)")
    ap.add_argument("--prompt-pattern", type=int, default=0,
                    help="tile each prompt from its own repeating pattern "
                         "of this many tokens (0 = random prompts)")
    ap.add_argument("--shared-prefix-len", type=int, default=0,
                    help="give every prompt a common prefix of this many "
                         "tokens (0 = random prompts)")
    ap.add_argument("--speculate", default="off",
                    help="draft proposer: 'off', 'ngram' (the slot's own "
                         "history) or 'draft'/'draft:<arch>' (a tiny draft "
                         "model on the engine's weight store); greedy "
                         "verification keeps the tokens of 'off'")
    ap.add_argument("--draft-k", type=int, default=4,
                    help="most draft tokens a slot a step (the verify "
                         "block is 1 + k wide)")
    ap.add_argument("--no-prefetch", action="store_true",
                    help="disable next-layer tile prefetch")
    ap.add_argument("--no-compress", action="store_true",
                    help="uncompressed baseline on the same scheduler")
    ap.add_argument("--log-every", type=int, default=16)
    ap.add_argument("--trace-out", type=str, default=None,
                    help="write per-request lifecycle spans + engine phase "
                         "spans as Chrome-trace JSON to this path (open in "
                         "chrome://tracing or ui.perfetto.dev)")
    ap.add_argument("--trace-jsonl", type=str, default=None,
                    help="also dump the raw trace events as JSONL (one "
                         "event a line) to this path")
    ap.add_argument("--metrics-out", type=str, default=None,
                    help="write every serving counter/gauge/histogram in "
                         "Prometheus text-exposition format to this path")
    args = ap.parse_args(argv)

    device = resolve_device(args.device)
    if args.kv_page_size is not None and args.kv_page_size <= 0:
        ap.error("--kv-page-size must be positive")
    if args.scale == "tiny":
        if args.layers is not None:
            ap.error("--layers cuts the depth at --scale full only")
        cfg = tiny_config(args.arch)
    else:
        cfg = full_config(args.arch, args.layers)
        if args.layers is not None:
            enc = f" (encoder {cfg.encoder_layers})" \
                if cfg.encoder_layers else ""
            print(f"depth cut: {args.arch} "
                  f"{cfgs.get_config(args.arch).num_layers} -> "
                  f"{cfg.num_layers} layers{enc} (published widths)")
    n_requests = args.requests or args.batch
    cache_auto = args.cache_mb == "auto"
    cache_bytes = None if args.cache_mb is None or cache_auto \
        else int(args.cache_mb * 2 ** 20)
    # trace spans only when a trace sink was asked for; phase histograms
    # ride along whenever any telemetry output is; no flag, no recorder
    telemetry = Telemetry(trace=bool(args.trace_out or args.trace_jsonl)) \
        if (args.trace_out or args.trace_jsonl or args.metrics_out) \
        else None

    gen = torch.Generator(device=device).manual_seed(0)
    t0 = time.monotonic()
    params = init_params(cfg, gen, device)
    engine = ServeEngine(cfg, params, device=device,
                         compress=not args.no_compress,
                         cache_bytes=cache_bytes, cache_policy=args.policy,
                         prefetch=not args.no_prefetch, telemetry=telemetry)
    del params
    if cache_auto:
        if not engine.compressed:
            raise SystemExit("--cache-mb auto needs the compressed path; "
                             "drop --no-compress")
        rec = recommend_store_capacity(engine.store, engine.model_id,
                                       policy=args.policy)
        engine.cache.capacity_bytes = rec["capacity"]
        print(f"cache autotune: working set "
              f"{rec['working_set'] / 2 ** 20:.2f} MiB -> recommended "
              f"capacity {rec['capacity'] / 2 ** 20:.2f} MiB "
              f"({rec['fraction']:.2f}x, projected hit rate "
              f"{rec['hit_rate'] * 100:.1f}%, best "
              f"{rec['best_rate'] * 100:.1f}%)")
    if engine.compressed:
        rep = engine.report
        print(f"weight store: {rep['layers']} compressed MLP tensors, "
              f"{rep['packed_bytes']} packed bytes -> "
              f"{rep['stream_bytes']} stream bytes "
              f"({rep['ratio_stream']:.3f}x), registered in "
              f"{time.monotonic() - t0:.1f}s")
    else:
        print(f"weight store: no compressible MLPs in {args.arch}; "
              "serving uncompressed")

    sched = Scheduler(engine, batch_size=args.batch, mode=args.mode,
                      prefill_chunk=args.prefill_chunk,
                      prefill_budget=args.prefill_budget,
                      kv_page_size=args.kv_page_size,
                      kv_pages=args.kv_pages,
                      attn_backend=args.attn_backend,
                      kv_codec=args.kv_codec,
                      prefix_share=args.prefix_share,
                      speculate=args.speculate, draft_k=args.draft_k,
                      log_every=args.log_every)
    rng = np.random.default_rng(0)
    shared_len = min(args.shared_prefix_len, args.prompt_len - 1)
    common = rng.integers(0, cfg.vocab_size, max(shared_len, 0))
    for _ in range(n_requests):
        tail_len = args.prompt_len - len(common)
        if args.prompt_pattern:
            pat = rng.integers(0, cfg.vocab_size, args.prompt_pattern)
            tail = np.tile(pat, -(-tail_len // len(pat)))[:tail_len]
        else:
            tail = rng.integers(0, cfg.vocab_size, tail_len)
        sched.submit(np.concatenate([common, tail]), args.gen)
    t0 = time.monotonic()
    completed = sched.run()
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    wall = time.monotonic() - t0

    m = engine.metrics
    assert len(completed) == n_requests
    assert all(len(r.generated) == r.max_new_tokens for r in completed)
    print(f"served {len(completed)} requests in {wall:.2f}s "
          f"({args.mode} slots, batch {args.batch}, {m.prefills} prefills, "
          f"device {device})")
    ttfts = [r.first_token_latency() for r in completed]
    ttft = sum(t for t in ttfts if t is not None) / max(len(ttfts), 1)
    print(f"prefill: {m.prefill_s:.2f}s total "
          f"(mean time-to-first-token {ttft * 1000:.0f} ms)")
    for label, hist in (("ttft", m.ttft_hist), ("tpot", m.tpot_hist),
                        ("e2e ", m.e2e_hist)):
        if hist.n:
            p50, p90, p99 = hist.percentiles(50, 90, 99)
            print(f"{label}   : p50 {p50 * 1000:.1f} ms | "
                  f"p90 {p90 * 1000:.1f} ms | p99 {p99 * 1000:.1f} ms "
                  f"(n={hist.n})")
    if m.prefill_chunks:
        print(f"chunked prefill: {m.prefill_chunks} chunks of "
              f"<= {args.prefill_chunk} tokens, "
              f"{m.prefill_chunk_ms():.1f} ms/chunk, decode stalled "
              f"{m.decode_stall_s:.2f}s behind chunks")
    print(f"decode : {m.ms_per_token():.1f} ms/step "
          f"({m.tokens_per_s():.1f} tok/s, "
          f"occupancy {m.occupancy() * 100:.0f}%)")
    if m.pages_total:
        print(f"kv pages: {args.kv_page_size}-token pages, pool "
              f"{m.pages_total}, mean occupancy "
              f"{m.page_occupancy() * 100:.0f}%")
        print(f"kv gather ({sched.attn_backend} backend): "
              f"{m.kv_gather_bytes} bytes copied on the decode hot path, "
              f"{m.kv_gather_bytes_avoided} avoided in-kernel")
        print(f"prefill gather: {m.kv_prefill_gather_bytes} bytes copied "
              f"installing prefilled caches, "
              f"{m.kv_prefill_gather_bytes_avoided} avoided by "
              f"mixed-step in-pool prefill")
    if sched.prefix_share:
        pool = sched._pool
        print(f"prefix share: {m.prefix_hits} hits, "
              f"{m.prefix_tokens_reused} prompt tokens served from "
              f"cached pages ({m.prefill_chunks_avoided} prefill chunks "
              f"avoided), {m.prefix_cow_copies} copy-on-write page "
              f"copies, {m.prefix_evictions} index evictions")
        print(f"prefix index: {pool.prefix.n_nodes} cached pages "
              f"covering {pool.prefix.tokens_cached} tokens")
    if args.kv_codec == "cluster":
        codec_report(sched._pool, m)
    if engine.compressed:
        st = engine.cache.stats()
        print(f"decode-tile cache ({st['policy']}): {st['hits']} hits / "
              f"{st['misses']} misses / {st['evictions']} evictions")
        print(f"cache hit-rate: {st['hit_rate'] * 100:.1f}%")
        print(f"compressed bytes streamed: {st['bytes_streamed']}; "
              f"bytes avoided by cache: {st['bytes_avoided']}")
        if engine.store.prefetch_dispatched:
            print(f"tile prefetch: {engine.store.prefetch_dispatched} "
                  f"dispatched, {engine.store.prefetch_used} consumed")
    if m.spec_rounds:
        total = sum(len(r.generated) for r in completed)
        print(f"speculative ({sched.speculate}, k={sched.draft_k}): "
              f"{m.spec_accepted_tokens}/{m.spec_draft_tokens} draft "
              f"tokens accepted ({m.spec_acceptance_rate() * 100:.0f}%), "
              f"{m.decode_steps / max(total, 1):.2f} verify steps/token")
    print("sample token ids:", completed[0].generated[:16])

    if telemetry is not None and telemetry.tracing:
        tr = telemetry.tracer
        n_spans = sum(1 for e in tr.events
                      if e["ph"] == "X" and e["name"] == "request")
        assert n_spans == len(completed), \
            f"trace has {n_spans} request spans, served {len(completed)}"
        if args.trace_out:
            tr.write_chrome(args.trace_out)
            with open(args.trace_out) as f:
                loaded = json.load(f)          # self-check: valid JSON
            print(f"trace: {len(loaded['traceEvents'])} events "
                  f"({n_spans} request spans) -> {args.trace_out} "
                  f"(open in chrome://tracing or ui.perfetto.dev)")
        if args.trace_jsonl:
            tr.write_jsonl(args.trace_jsonl)
            print(f"trace events (JSONL) -> {args.trace_jsonl}")
    if args.metrics_out:
        text = engine.render_prom()
        parse_prom(text)                       # self-check: parseable
        with open(args.metrics_out, "w") as f:
            f.write(text)
        print(f"metrics: {len(text.splitlines())} lines of Prometheus "
              f"text exposition -> {args.metrics_out}")
    return completed


if __name__ == "__main__":
    main()

"""Serving counters and the periodic stats line (port of
``repro.runtime.metrics`` for the paths this port serves).

Same names and semantics as the reference: ``slot_steps`` /
``capacity_steps`` give occupancy, the chunk counters track chunked
prefill, the page gauges track the KV pool, the KV gather counters
record the copies the gathered backend makes (page gather and scatter a
decode step, the install copy of a standalone prefill) and those the
in-kernel backend avoids (its mixed path copies nothing), the codec
counters the resident KV bytes ``kv_codec="cluster"`` keeps out of the
pool, ``waves`` the wave-mode admission rounds, the ``prefix_*`` counters
prefix sharing (hits, reused prompt tokens, skipped chunks, copy-on-write
copies, index evictions, the shared-page gauge) and the ``spec_*``
counters speculative decoding (rounds, drafts proposed, accepted and
rolled back).

Everything is exportable as Prometheus text exposition through
:meth:`ServeMetrics.render_prom` (a pull-based
:class:`~repro_torch.runtime.telemetry.MetricsRegistry`), with the
reference's metric names, kinds and help strings, plus the decode-cache
and weight-store counters and the telemetry phase histograms when given.
The one counter of the reference's registry left out is
``kernel_qblock_rounded``: it counts gcd-rounded TPU ``q_block`` launches,
and the port takes no ``q_block``.
"""

from __future__ import annotations

import dataclasses
import time

from repro_torch.runtime.telemetry import Histogram, MetricsRegistry


def _fmt_bytes(n: float) -> str:
    for unit in ("B", "KB", "MB", "GB", "TB"):
        if abs(n) < 1024.0 or unit == "TB":
            return f"{n:.1f} {unit}"
        n /= 1024.0
    return f"{n:.1f} TB"


@dataclasses.dataclass
class ServeMetrics:
    tokens_generated: int = 0
    requests_completed: int = 0
    requests_admitted: int = 0
    prefills: int = 0
    decode_steps: int = 0
    slot_steps: int = 0        # sum over decode steps of active slots
    capacity_steps: int = 0    # sum over decode steps of total slots
    prefill_s: float = 0.0
    decode_s: float = 0.0
    waves: int = 0                     # admission rounds (wave mode only)
    prefill_chunks: int = 0            # chunked-prefill chunk count
    prefill_chunk_tokens: int = 0      # prompt tokens pushed through chunks
    decode_stall_s: float = 0.0        # chunk time while decoders waited
    pages_in_use: int = 0              # KV page gauges (last decode step)
    pages_total: int = 0
    page_use_steps: int = 0            # sum over steps of pages_in_use
    page_capacity_steps: int = 0       # sum over steps of pages_total
    kv_gather_bytes: int = 0           # decode-path KV copies (0 in-kernel)
    kv_gather_bytes_avoided: int = 0   # copies the in-kernel backend skipped
    kv_prefill_gather_bytes: int = 0   # prefill-path install copies
    kv_prefill_gather_bytes_avoided: int = 0  # install copies skipped
    kv_codec_bytes_fp: int = 0         # per-step resident page bytes the
    #                                    pool would hold uncompressed
    #                                    (kv_codec="cluster" only)
    kv_codec_bytes_resident: int = 0   # per-step resident page bytes the
    #                                    codec pool holds (int8 codes +
    #                                    per-token f32 scales)
    kv_bytes_avoided: int = 0          # fp - resident: device bytes the
    #                                    KV codec kept out of the pool
    kv_codec_error_bound: float = 0.0  # worst elementwise reconstruction
    #                                    error bound seen (max scale / 254)
    prefix_hits: int = 0               # admissions that mapped a cached
    #                                    prefix (prefix_share only)
    prefix_tokens_reused: int = 0      # prompt tokens served from shared
    #                                    pages, with no prefill work
    prefill_chunks_avoided: int = 0    # prefill chunks never executed
    prefix_cow_copies: int = 0         # shared pages copied on write
    prefix_evictions: int = 0          # index entries dropped under
    #                                    reservation pressure
    shared_pages: int = 0              # pages referenced >1x (last-step
    shared_page_steps: int = 0         # gauge; sum over steps for mean)
    spec_rounds: int = 0               # (speculative round x slot) pairs
    #                                    that carried >= 1 draft token
    spec_draft_tokens: int = 0         # draft tokens proposed to verify
    spec_accepted_tokens: int = 0      # drafts the model's argmax agreed
    #                                    with
    spec_rejected_tokens: int = 0      # drafts rolled back
    _t0: float = dataclasses.field(default_factory=time.monotonic)
    ttft_hist: Histogram = dataclasses.field(default_factory=Histogram)
    tpot_hist: Histogram = dataclasses.field(default_factory=Histogram)
    e2e_hist: Histogram = dataclasses.field(default_factory=Histogram)
    chunk_hist: Histogram = dataclasses.field(default_factory=Histogram)
    step_hist: Histogram = dataclasses.field(default_factory=Histogram)
    _win: dict = dataclasses.field(default_factory=dict)

    # -- recording ---------------------------------------------------------
    def record_admit(self, n_requests: int, dt: float,
                     tokens: int = 0) -> None:
        self.requests_admitted += n_requests
        self.prefills += n_requests
        self.prefill_s += dt
        self.tokens_generated += tokens

    def record_wave(self) -> None:
        """One drain-then-admit round (wave-mode scheduling only)."""
        self.waves += 1

    def record_prefill_chunk(self, n_tokens: int, dt: float,
                             stalled: bool = False) -> None:
        self.prefill_chunks += 1
        self.prefill_chunk_tokens += n_tokens
        self.prefill_s += dt
        self.chunk_hist.record(dt)
        if stalled:
            self.decode_stall_s += dt

    def record_pages(self, in_use: int, total: int) -> None:
        self.pages_in_use = in_use
        self.pages_total = total
        self.page_use_steps += in_use
        self.page_capacity_steps += total

    def record_kv_gather(self, moved: int, avoided: int) -> None:
        self.kv_gather_bytes += moved
        self.kv_gather_bytes_avoided += avoided

    def record_prefill_gather(self, moved: int, avoided: int) -> None:
        self.kv_prefill_gather_bytes += moved
        self.kv_prefill_gather_bytes_avoided += avoided

    def record_kv_codec(self, fp_bytes: int, resident_bytes: int) -> None:
        """Resident KV pool bytes after one decode step under
        ``kv_codec="cluster"``: what the live pages would weigh at fp vs
        what the code pool holds; the difference accumulates into
        ``kv_bytes_avoided``."""
        self.kv_codec_bytes_fp += fp_bytes
        self.kv_codec_bytes_resident += resident_bytes
        self.kv_bytes_avoided += fp_bytes - resident_bytes

    def record_prefix_hit(self, tokens: int, chunks_avoided: int) -> None:
        """One admission that mapped a cached prefix: ``tokens`` prompt
        positions rode shared pages and ``chunks_avoided`` prefill chunks
        were never executed."""
        self.prefix_hits += 1
        self.prefix_tokens_reused += tokens
        self.prefill_chunks_avoided += chunks_avoided

    def record_prefix_cow(self) -> None:
        """One shared page copied on write."""
        self.prefix_cow_copies += 1

    def record_prefix_evictions(self, n: int) -> None:
        """Prefix-index entries dropped under reservation pressure."""
        self.prefix_evictions += n

    def record_shared_pages(self, n: int) -> None:
        """Shared-page occupancy gauge after one decode step."""
        self.shared_pages = n
        self.shared_page_steps += n

    def record_kv_codec_error(self, bound: float) -> None:
        """Worst-case elementwise KV reconstruction error bound of the
        resident pool (monotone max across runs)."""
        self.kv_codec_error_bound = max(self.kv_codec_error_bound, bound)

    def kv_capacity_multiplier(self) -> float:
        """Effective-capacity multiplier of the KV codec: fp bytes per
        resident byte (1.0 when the codec is off or nothing resided)."""
        return self.kv_codec_bytes_fp / self.kv_codec_bytes_resident \
            if self.kv_codec_bytes_resident else 1.0

    def record_decode_step(self, n_tokens: int, dt: float,
                           n_slots: int = 0) -> None:
        self.decode_steps += 1
        self.tokens_generated += n_tokens
        self.slot_steps += n_tokens
        self.capacity_steps += n_slots
        self.decode_s += dt
        self.step_hist.record(dt)

    def record_spec(self, proposed: int, accepted: int) -> None:
        """One slot's speculative verification: ``proposed`` drafts
        scored, ``accepted`` of them matching the model's argmax chain
        (the rest rolled back).  No-op when nothing was proposed."""
        if proposed <= 0:
            return
        self.spec_rounds += 1
        self.spec_draft_tokens += proposed
        self.spec_accepted_tokens += accepted
        self.spec_rejected_tokens += proposed - accepted

    def spec_acceptance_rate(self) -> float:
        """Fraction of proposed draft tokens the verifier accepted."""
        return self.spec_accepted_tokens / self.spec_draft_tokens \
            if self.spec_draft_tokens else 0.0

    def record_completed(self, n_requests: int) -> None:
        self.requests_completed += n_requests

    def record_ttft(self, dt: float) -> None:
        self.ttft_hist.record(dt)

    def record_request_done(self, req) -> None:
        if req.t_done is None or req.t_submit is None:
            return
        self.e2e_hist.record(req.t_done - req.t_submit)
        if req.t_first is not None and len(req.generated) > 1:
            self.tpot_hist.record((req.t_done - req.t_first)
                                  / (len(req.generated) - 1))

    # -- derived -----------------------------------------------------------
    def tokens_per_s(self) -> float:
        """Decode throughput: decode-step tokens over decode time."""
        return self.slot_steps / self.decode_s if self.decode_s > 0 else 0.0

    def ms_per_token(self) -> float:
        steps = self.decode_steps
        return self.decode_s / steps * 1000.0 if steps else 0.0

    def occupancy(self) -> float:
        return self.slot_steps / self.capacity_steps \
            if self.capacity_steps else 0.0

    def page_occupancy(self) -> float:
        return self.page_use_steps / self.page_capacity_steps \
            if self.page_capacity_steps else 0.0

    def prefill_chunk_ms(self) -> float:
        return self.prefill_s / self.prefill_chunks * 1000.0 \
            if self.prefill_chunks else 0.0

    # -- interval windows --------------------------------------------------
    _RATE_FIELDS = ("tokens_generated", "slot_steps", "decode_steps",
                    "capacity_steps", "decode_s", "prefill_s",
                    "requests_completed", "requests_admitted")

    def _sample(self, cache=None) -> dict:
        snap = {f: getattr(self, f) for f in self._RATE_FIELDS}
        snap["cache_hits"] = cache.hits if cache is not None else 0
        snap["cache_misses"] = cache.misses if cache is not None else 0
        snap["t"] = time.monotonic()
        return snap

    def window(self, cache=None) -> dict:
        """Counter deltas since the previous call (the first spans the
        metrics' lifetime); the baseline advances."""
        cur = self._sample(cache)
        delta = {k: cur[k] - self._win.get(k, 0) for k in cur}
        if not self._win:
            delta["t"] = cur["t"] - self._t0
        self._win.clear()
        self._win.update(cur)
        return delta

    def stats_line(self, cache=None) -> str:
        w = self.window(cache)
        tok_s = w["slot_steps"] / w["decode_s"] if w["decode_s"] > 0 else 0.0
        ms_step = w["decode_s"] / w["decode_steps"] * 1000.0 \
            if w["decode_steps"] else 0.0
        parts = [
            f"tokens {self.tokens_generated}",
            f"{tok_s:.1f} tok/s",
            f"{ms_step:.1f} ms/step",
            f"reqs {self.requests_completed}/{self.requests_admitted}",
        ]
        if w["capacity_steps"]:
            parts.append(
                f"occupancy "
                f"{w['slot_steps'] / w['capacity_steps'] * 100:.0f}%")
        if self.prefill_chunks:
            parts.append(f"chunks {self.prefill_chunks} "
                         f"({self.prefill_chunk_ms():.1f} ms, "
                         f"stall {self.decode_stall_s:.2f}s)")
        if self.pages_total:
            parts.append(f"pages {self.pages_in_use}/{self.pages_total} "
                         f"({self.page_occupancy() * 100:.0f}% mean)")
        if self.kv_gather_bytes or self.kv_gather_bytes_avoided:
            parts.append(
                f"kv gather {_fmt_bytes(self.kv_gather_bytes)} "
                f"(avoided {_fmt_bytes(self.kv_gather_bytes_avoided)})")
        if self.kv_prefill_gather_bytes or \
                self.kv_prefill_gather_bytes_avoided:
            parts.append(
                f"prefill gather "
                f"{_fmt_bytes(self.kv_prefill_gather_bytes)} "
                f"(avoided "
                f"{_fmt_bytes(self.kv_prefill_gather_bytes_avoided)})")
        if self.kv_bytes_avoided:
            parts.append(
                f"kv codec {self.kv_capacity_multiplier():.2f}x "
                f"(avoided {_fmt_bytes(self.kv_bytes_avoided)})")
        if self.prefix_hits:
            parts.append(
                f"prefix {self.prefix_hits} hits "
                f"({self.prefix_tokens_reused} toks reused, "
                f"{self.prefill_chunks_avoided} chunks avoided, "
                f"{self.prefix_cow_copies} cow)")
        if self.spec_rounds:
            parts.append(
                f"spec {self.spec_accepted_tokens}/"
                f"{self.spec_draft_tokens} drafts accepted "
                f"({self.spec_acceptance_rate() * 100:.0f}%)")
        if self.ttft_hist.n:
            p50, p99 = self.ttft_hist.percentiles(50, 99)
            parts.append(f"ttft p50 {p50 * 1000:.0f}ms p99 {p99 * 1000:.0f}ms")
        if self.tpot_hist.n:
            p50, p99 = self.tpot_hist.percentiles(50, 99)
            parts.append(f"tpot p50 {p50 * 1000:.1f}ms p99 {p99 * 1000:.1f}ms")
        if cache is not None:
            acc = w["cache_hits"] + w["cache_misses"]
            rate = w["cache_hits"] / acc if acc else cache.hit_rate()
            parts.append(f"cache hit-rate {rate * 100:.1f}%")
            parts.append(f"streamed {_fmt_bytes(cache.bytes_streamed)}, "
                         f"avoided {_fmt_bytes(cache.bytes_avoided)}")
        return " | ".join(parts)

    # -- pull-based export -------------------------------------------------
    def registry(self, cache=None, store=None,
                 telemetry=None) -> MetricsRegistry:
        """Every serving counter/gauge/histogram — plus the decode-cache,
        weight-store, and telemetry phase metrics when given — registered
        by name in a pull-based :class:`MetricsRegistry`."""
        reg = MetricsRegistry()
        for field, help_ in (
                ("tokens_generated", "tokens produced (prefill + decode)"),
                ("requests_admitted", "requests admitted to a slot"),
                ("requests_completed", "requests retired"),
                ("prefills", "monolithic batch-1 prefills"),
                ("prefill_chunks", "chunked-prefill chunks"),
                ("prefill_chunk_tokens", "prompt tokens through chunks"),
                ("decode_steps", "batched decode steps"),
                ("slot_steps", "decode steps x active slots"),
                ("capacity_steps", "decode steps x total slots"),
                ("waves", "wave-mode admission rounds"),
                ("page_use_steps", "decode steps x pages in use"),
                ("page_capacity_steps", "decode steps x pool pages"),
                ("kv_gather_bytes", "decode-path KV gather/scatter bytes"),
                ("kv_gather_bytes_avoided",
                 "decode-path KV copies avoided (pallas_paged)"),
                ("kv_prefill_gather_bytes",
                 "prefill-path KV install-copy bytes"),
                ("kv_prefill_gather_bytes_avoided",
                 "prefill install copies avoided (mixed-step)"),
                ("kv_codec_bytes_fp",
                 "resident KV page bytes at fp (codec step sum)"),
                ("kv_codec_bytes_resident",
                 "resident KV page bytes compressed (codec step sum)"),
                ("kv_bytes_avoided",
                 "KV pool bytes the codec kept out of HBM"),
                ("prefix_hits",
                 "admissions that mapped a cached prefix"),
                ("prefix_tokens_reused",
                 "prompt tokens served from shared KV pages"),
                ("prefill_chunks_avoided",
                 "prefill chunks skipped via prefix sharing"),
                ("prefix_cow_copies",
                 "shared KV pages copied on write"),
                ("prefix_evictions",
                 "prefix-index entries evicted under pressure"),
                ("shared_page_steps",
                 "decode steps x shared pages (occupancy sum)"),
                ("spec_rounds",
                 "speculative verifications (round x slot pairs)"),
                ("spec_draft_tokens",
                 "draft tokens proposed for verification"),
                ("spec_accepted_tokens",
                 "draft tokens the verifier accepted"),
                ("spec_rejected_tokens",
                 "draft tokens rolled back after rejection")):
            reg.counter(f"{field}_total",
                        (lambda f=field: getattr(self, f)), help_)
        reg.counter("prefill_seconds_total", lambda: self.prefill_s,
                    "wall seconds spent in prefill")
        reg.counter("decode_seconds_total", lambda: self.decode_s,
                    "wall seconds spent in decode steps")
        reg.counter("decode_stall_seconds_total",
                    lambda: self.decode_stall_s,
                    "chunk seconds while decode work waited")
        reg.gauge("pages_in_use", lambda: self.pages_in_use,
                  "KV pages holding live request state (last step)")
        reg.gauge("pages_total", lambda: self.pages_total,
                  "KV page-pool size (last step)")
        reg.gauge("shared_pages", lambda: self.shared_pages,
                  "KV pages referenced by >1 owner (last step)")
        reg.gauge("kv_codec_error_bound", lambda: self.kv_codec_error_bound,
                  "worst elementwise KV reconstruction error bound")
        reg.gauge("kv_capacity_multiplier",
                  lambda: self.kv_capacity_multiplier(),
                  "effective KV capacity multiplier (fp/resident bytes)")
        reg.gauge("spec_acceptance_rate",
                  lambda: self.spec_acceptance_rate(),
                  "fraction of proposed draft tokens accepted")
        for name, hist, help_ in (
                ("ttft_seconds", self.ttft_hist, "time to first token"),
                ("tpot_seconds", self.tpot_hist, "time per output token"),
                ("e2e_seconds", self.e2e_hist, "request end-to-end latency"),
                ("prefill_chunk_seconds", self.chunk_hist,
                 "prefill chunk duration"),
                ("decode_step_seconds", self.step_hist,
                 "decode step duration")):
            reg.histogram(name, hist, help_)
        if cache is not None:
            for name, kind, getter, help_ in cache.prom_metrics():
                getattr(reg, kind)(f"cache_{name}", getter, help_)
        if store is not None:
            for name, kind, getter, help_ in store.prom_metrics():
                getattr(reg, kind)(f"store_{name}", getter, help_)
        if telemetry is not None:
            for phase in sorted(telemetry.phases):
                safe = phase.replace(".", "_").replace("-", "_")
                reg.histogram(f"phase_{safe}_seconds",
                              (lambda p=phase: telemetry.phases[p]),
                              f"wall seconds per {phase} phase")
        return reg

    def render_prom(self, cache=None, store=None, telemetry=None) -> str:
        """Prometheus text exposition of :meth:`registry`."""
        return self.registry(cache=cache, store=store,
                             telemetry=telemetry).render()

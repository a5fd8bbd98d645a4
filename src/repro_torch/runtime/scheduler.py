"""Slot-level continuous batching over paged KV, on the mixed-step path
(port of ``repro.runtime.scheduler`` for ``attn_backend="cuda_paged"``
with chunked prefill).

Every scheduler iteration, active slots contribute their decode token and
prefilling slots up to one prompt chunk to a *single* ragged
``mixed_step`` over the page pools (``Scheduler._mixed_tick``, the
reference's ``_mixed_tick``): chunk K/V is written straight into the
slot's pages, there is no standalone prefill cache and no install copy,
and the per-iteration KV gather bytes are zero on the prefill and decode
paths alike.

Invariants, as in the reference:

  * slot lifecycle — FREE (req is None) -> PREFILLING (chunks write into
    the slot's pages) -> ACTIVE (decode advances ``pos``) -> FREE (retire
    releases pages and reservations);
  * page ownership — a physical page is referenced by at most one slot's
    table row; page 0 is the dummy sink that absorbs padded writes and is
    never read as a valid position;
  * no mid-flight OOM — admission reserves every page the request can ever
    need; allocation during serving draws from that reservation.

Under ``kv_codec="cluster"`` the page pools hold int8 codebook codes with
one f32 scale per (page, token) in a scale-pool tree beside them; each
step encodes its K/V into them and the kernel decodes them in place.

Not ported yet, and refused with ``NotImplementedError`` rather than
served some other way: the ``gathered`` backend, monolithic prefill,
``mode="wave"``, prefix sharing, speculative decoding and the kernel
autotuner.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Callable

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.kernels import kv_codec as kv_codec_mod
from repro_torch.kernels.kv_codec import KV_CODECS
from repro_torch.models.api import (ATTN_BACKENDS, cache_layout, get_model,
                                    supports_chunked_prefill,
                                    supports_paged_attention)
from repro_torch.runtime.decode_cache import DecodeTileCache, EvictionPolicy
from repro_torch.runtime.metrics import ServeMetrics
from repro_torch.runtime.telemetry import NULL_TELEMETRY
from repro_torch.runtime.weight_store import WeightStore
from repro_torch.tree import tree_leaves, tree_map

MAX_PROMPT_LEN = 2048     # longest prompt submit() accepts
SLOT_LEN_QUANTUM = 16      # slot cache lengths round up to this many tokens
DUMMY_PAGE = 0             # physical page that absorbs padded writes


@dataclasses.dataclass
class Request:
    rid: int
    prompt: np.ndarray                    # (L,) int32 token ids
    max_new_tokens: int
    generated: list = dataclasses.field(default_factory=list)
    done: bool = False
    t_submit: float = 0.0                 # monotonic submission time
    t_admit: float | None = None          # monotonic admission time
    t_first: float | None = None          # monotonic first-token time
    t_done: float | None = None           # monotonic retire time

    @property
    def prompt_len(self) -> int:
        return int(self.prompt.shape[0])

    def first_token_latency(self) -> float | None:
        """Seconds from submission to the first generated token."""
        return None if self.t_first is None else self.t_first - self.t_submit


class PageAllocator:
    """Free-list allocator over a fixed set of physical KV page ids, with
    admission-time reservations.

    ``reserve(n)`` earmarks capacity; ``alloc`` hands out a page against
    an existing reservation, so allocation during serving can never fail
    mid-request.  Releasing a page that is not allocated raises.  (The
    reference's per-page refcounts come with prefix sharing.)
    """

    def __init__(self, page_ids):
        ids = list(page_ids)
        self.total = len(ids)
        self._free = sorted(ids, reverse=True)    # pop() -> ascending ids
        self._allocated: set[int] = set()
        self.reserved = 0

    @property
    def n_allocated(self) -> int:
        return len(self._allocated)

    def available(self) -> int:
        """Pages free and not spoken for by a reservation."""
        return len(self._free) - self.reserved

    def reserve(self, n: int) -> bool:
        """Earmark ``n`` future allocations; False if they could not all be
        satisfied (the caller should defer admission)."""
        if n > self.available():
            return False
        self.reserved += n
        return True

    def unreserve(self, n: int) -> None:
        assert 0 <= n <= self.reserved, (n, self.reserved)
        self.reserved -= n

    def alloc(self) -> int:
        """One page against an existing reservation."""
        assert self.reserved > 0, "alloc without reservation"
        assert self._free, "reservation invariant broken: no free pages"
        self.reserved -= 1
        pid = self._free.pop()
        self._allocated.add(pid)
        return pid

    def release(self, page_ids) -> None:
        """Return pages to the free list."""
        for pid in page_ids:
            if pid not in self._allocated:
                raise ValueError(f"double free of page {pid}")
            self._allocated.remove(pid)
            self._free.append(pid)


class ServeEngine:
    """Model + compressed weight store + decode cache + metrics, on
    ``device`` (default ``"cuda"``; ``"cpu"`` runs the plain versions).

    ``compress=True`` binarises and Huffman-compresses the MLP projections
    into the store and serves in BNN-MLP mode (``cfg.binarize_mlp``);
    ``compress=False`` serves the params as given.  ``params`` is the
    model's tree of tensors (moved to ``device``)."""

    def __init__(self, cfg, params, *, device="cuda", compress: bool = True,
                 cache_bytes: int | None = None,
                 cache_policy: str | EvictionPolicy | None = None,
                 prefetch: bool = True):
        self.device = resolve_device(device)
        params = tree_map(lambda a: a.to(self.device), params)
        self.cache = DecodeTileCache(cache_bytes, policy=cache_policy)
        self.telemetry = NULL_TELEMETRY
        self.store = WeightStore(self.cache, prefetch=prefetch,
                                 telemetry=self.telemetry)
        self.metrics = ServeMetrics()
        self.model_id = "lm"
        self.compressed = False
        self.report = None
        if compress:
            try:
                self.report = self.store.register_model(self.model_id,
                                                        params)
                self.compressed = True
                cfg = cfg.scaled(binarize_mlp=True)
            except ValueError:
                pass    # no compressible MLPs: serve the params as given
        self.cfg = cfg
        self.api = get_model(cfg)
        self._raw_params = None if self.compressed else params

    @property
    def supports_chunked_prefill(self) -> bool:
        return supports_chunked_prefill(self.cfg)

    @property
    def supports_paged_attention(self) -> bool:
        return supports_paged_attention(self.cfg)

    def mixed_step(self, params, kcache, table, toks, poss, q_lens, *,
                   paged_flags: tuple, page_size: int, kv_scales=None):
        """One ragged mixed step for every slot over the page pools:
        table (S, P), toks (S, Q), poss (S,), q_lens (S,) host int arrays
        -> (logits (S, Q, V) f32 on device, cache with pools updated in
        place).  ``kv_scales`` (``kv_codec="cluster"``): the scale-pool
        tree beside int8 code pools, updated in place too; the return
        grows to ``(logits, cache, scales)``."""
        dev = self.device

        def on_dev(a):
            return torch.from_numpy(np.ascontiguousarray(a, np.int32)).to(dev)

        with torch.no_grad():
            return self.api.mixed_step(
                self.cfg, params, kcache, on_dev(table), on_dev(toks),
                on_dev(poss), on_dev(q_lens), paged_flags=paged_flags,
                page_size=page_size, scales=kv_scales)

    def step_params(self):
        """Per-step serving params (tile-cache-served when compressed)."""
        if self.compressed:
            with torch.no_grad():
                return self.store.materialize(self.model_id)
        return self._raw_params

    def pos_offset(self, prompt_len: int) -> int:
        """Absolute position of the first generated token."""
        return prompt_len

    def cache_len(self, prompt_len: int, gen: int) -> int:
        return self.pos_offset(prompt_len) + gen

    def stats_line(self) -> str:
        return self.metrics.stats_line(self.cache if self.compressed
                                       else None)


@dataclasses.dataclass
class Slot:
    """One decode lane: its request and per-slot state.  ``tok`` is the
    most recent token (the next decode input), ``pos`` its absolute
    position; while ``prefilling``, ``prefill_cursor`` counts prompt
    tokens already written into the slot's pages.  ``reserved_left`` is
    the slot's outstanding page reservation."""

    index: int
    req: Request | None = None
    pos: int = 0
    tok: int = 0
    prefilling: bool = False
    prefill_cursor: int = 0
    reserved_left: int = 0


class SlotPool:
    """Fixed decode slots over shared KV page pools (identity layout).

    Each pageable cache leaf ``(repeats?, 1, slot_len, KH, D)`` becomes a
    pool ``(repeats?, n_pages, page_size, KH, D)`` on the engine's device,
    handed with the page table to ``mixed_step``, whose kernel walks the
    table in place.  Pages are allocated on demand as a slot's writes
    reach them and released at retire.

    ``kv_codec="cluster"``: the pools hold int8 codebook codes and
    ``kscales`` is a tree of the same shape with one f32 scale pool
    ``(repeats?, n_pages, page_size)`` at each leaf; ``page_bytes_fp`` and
    ``page_bytes_resident`` give a physical page's bytes over every leaf
    without and with the codec."""

    def __init__(self, engine: ServeEngine, n_slots: int, slot_len: int,
                 *, page_size: int, n_pages: int | None = None,
                 backend: str = "cuda_paged", kv_codec: str = "none"):
        if backend not in ATTN_BACKENDS:
            raise NotImplementedError(
                f"attention backend {backend!r} is not ported; this port "
                f"serves {ATTN_BACKENDS}")
        if kv_codec not in KV_CODECS:
            raise ValueError(f"unknown kv codec {kv_codec!r}; "
                             f"choose from {KV_CODECS}")
        self.codec = kv_codec == "cluster"
        if page_size is None or page_size <= 0:
            raise ValueError(f"page_size must be positive: {page_size}")
        self.engine = engine
        self.n_slots = n_slots
        self.page_size = page_size
        self.backend = backend
        slot_len = -(-slot_len // page_size) * page_size
        self.slot_len = slot_len
        self.pages_per_slot = slot_len // page_size
        self.slots = [Slot(i) for i in range(n_slots)]
        specs = engine.api.init_cache_specs(engine.cfg, 1, slot_len)
        leaves = tree_leaves(specs)
        # the reference's install-copy size: what a gathered admission
        # would have moved, counted as avoided by mixed-step prefill
        self.install_bytes = sum(s.numel() * s.element_size()
                                 for s in leaves)
        _, self._paged_axis = cache_layout(engine.api, engine.cfg, slot_len)
        self.paged_flags = tuple(ax is not None for ax in self._paged_axis)
        if not all(self.paged_flags):
            raise NotImplementedError("lane-backed (non-pageable) cache "
                                      "leaves are not ported yet")
        if n_pages is None:
            n_pages = n_slots * self.pages_per_slot + 1   # +1: dummy sink
        if n_pages < self.pages_per_slot + 1:
            raise ValueError(
                f"n_pages {n_pages} cannot back even one full slot "
                f"({self.pages_per_slot} pages + dummy)")
        self.n_pages = n_pages
        self.allocator = PageAllocator(range(1, n_pages))   # 0 = dummy
        self.table = np.zeros((n_slots, self.pages_per_slot), np.int32)
        # the gathered oracle copies every paged leaf's per-slot view twice
        # per step; the kernel backend copies none of it
        self.gather_bytes_per_step = 0
        self.gather_bytes_avoided_per_step = 2 * n_slots * sum(
            s.numel() * s.element_size() for s in leaves)
        # a physical page's bytes over every leaf: fp at rest vs the
        # codec's int8 codes + one f32 scale per (page, token)
        fp_page = codec_page = 0
        for spec, ax in zip(leaves, self._paged_axis):
            elems = spec.numel() // spec.shape[ax] * page_size
            feat = int(np.prod(spec.shape[ax + 1:])) or 1
            fp_page += elems * spec.element_size()
            codec_page += elems + (elems // feat) * 4
        self.page_bytes_fp = fp_page
        self.page_bytes_resident = codec_page if self.codec else fp_page

        def pools(leaf):
            """One pool per cache leaf: (repeats?, n_pages, page_size),
            then the trailing dims and dtype ``leaf(spec, ax)`` gives."""
            axes = iter(self._paged_axis)

            def make(spec):
                ax = next(axes)
                tail, dtype = leaf(spec, ax)
                return torch.zeros((*spec.shape[:ax - 1], n_pages,
                                    page_size, *tail), dtype=dtype,
                                   device=engine.device)
            return tree_map(make, specs)

        self.kcache = pools(lambda spec, ax: (
            spec.shape[ax + 1:], torch.int8 if self.codec else spec.dtype))
        self.kscales = pools(lambda spec, ax: ((), torch.float32)) \
            if self.codec else None

    # -- page bookkeeping ---------------------------------------------------
    def pages_needed(self, cache_len: int) -> int:
        return -(-cache_len // self.page_size)

    def pages_in_use(self) -> int:
        return self.allocator.n_allocated

    def _ensure_pages(self, slot: Slot, upto_pos: int) -> None:
        """Allocate table entries so positions [0, upto_pos] are backed."""
        need = upto_pos // self.page_size + 1
        assert need <= self.pages_per_slot, (need, self.pages_per_slot)
        for j in range(need):
            if self.table[slot.index, j] == DUMMY_PAGE:
                self.table[slot.index, j] = self.allocator.alloc()
                slot.reserved_left -= 1
                assert slot.reserved_left >= 0

    # -- slot queries ---------------------------------------------------
    def free(self) -> list[Slot]:
        return [s for s in self.slots if s.req is None]

    def active(self) -> list[Slot]:
        return [s for s in self.slots if s.req is not None
                and not s.prefilling]

    def prefilling(self) -> list[Slot]:
        return [s for s in self.slots if s.prefilling]

    def busy(self) -> bool:
        return any(s.req is not None for s in self.slots)

    # -- admission / retire -------------------------------------------------
    def reserve_for(self, slot: Slot, req: Request) -> bool:
        """Reserve every page ``req`` can need; False -> defer admission."""
        need = self.pages_needed(
            self.engine.cache_len(req.prompt_len, req.max_new_tokens))
        if not self.allocator.reserve(need):
            return False
        slot.reserved_left = need
        return True

    def retire(self, slot: Slot) -> None:
        """Release the slot's pages and outstanding reservation."""
        row = self.table[slot.index]
        self.allocator.release(int(p) for p in row if p != DUMMY_PAGE)
        row[:] = DUMMY_PAGE
        if slot.reserved_left:
            self.allocator.unreserve(slot.reserved_left)
        slot.reserved_left = 0
        slot.prefilling = False
        slot.req = None

    def codec_error_bound(self) -> float:
        """Worst-case elementwise KV reconstruction error of the resident
        pool (max per-token scale / 254); 0.0 when the codec is off."""
        if not self.codec:
            return 0.0
        top = max((float(s.max()) for s in tree_leaves(self.kscales)),
                  default=0.0)
        return float(kv_codec_mod.error_bound(top))

    def mixed_step(self, params, toks, poss, q_lens) -> torch.Tensor:
        """One ragged mixed step over the pools -> logits (S, Q, V).
        Pages backing every written position must already be ensured."""
        logits, self.kcache, *scales = self.engine.mixed_step(
            params, self.kcache, self.table, toks, poss, q_lens,
            paged_flags=self.paged_flags, page_size=self.page_size,
            kv_scales=self.kscales)
        if scales:
            self.kscales = scales[0]
        return logits


class Scheduler:
    """Admit -> chunked prefill and decode in one ragged mixed step per
    iteration -> retire, with admit-on-retire continuous batching.

    ``prefill_chunk=N`` splits each prompt into N-token chunks;
    ``prefill_budget`` caps the chunk tokens per iteration (default one
    chunk, and at least one chunk always runs).  ``kv_page_size=N`` backs
    the KV with N-token pages (``kv_pages`` overrides the pool size;
    default fully backs every slot)."""

    def __init__(self, engine: ServeEngine, *, batch_size: int = 4,
                 mode: str = "continuous", slot_len: int | None = None,
                 prefill_chunk: int | None = None,
                 prefill_budget: int | None = None,
                 kv_page_size: int | None = None,
                 kv_pages: int | None = None,
                 attn_backend: str = "cuda_paged",
                 kv_codec: str = "none",
                 prefix_share: bool = False,
                 kernel_tune: str | None = None,
                 speculate: str = "off",
                 log_every: int = 0, emit: Callable[[str], None] = print):
        refused = [
            (mode != "continuous", f"mode={mode!r}"),
            (attn_backend != "cuda_paged",
             f"attn_backend={attn_backend!r}"),
            (prefill_chunk is None, "monolithic prefill (prefill_chunk="
                                    "None)"),
            (kv_page_size is None, "unpaged KV lanes (kv_page_size=None)"),
            (prefix_share, "prefix_share"),
            ((kernel_tune or "off") != "off", f"kernel_tune={kernel_tune!r}"),
            ((speculate or "off") != "off", f"speculate={speculate!r}"),
            (not engine.supports_paged_attention,
             "archs without paged attention"),
            (not engine.supports_chunked_prefill,
             "archs without chunked prefill"),
        ]
        for bad, what in refused:
            if bad:
                raise NotImplementedError(
                    f"{what} is not ported to repro_torch yet; it serves "
                    "attn_backend='cuda_paged' with prefill_chunk and "
                    "kv_page_size set")
        if prefill_chunk <= 0:
            raise ValueError(f"prefill_chunk must be positive: "
                             f"{prefill_chunk}")
        if kv_codec not in KV_CODECS:
            raise ValueError(f"unknown kv codec {kv_codec!r}; "
                             f"choose from {KV_CODECS}")
        self.engine = engine
        self.batch_size = batch_size
        self.slot_len = slot_len
        self.prefill_chunk = prefill_chunk
        self.prefill_budget = prefill_budget or prefill_chunk
        self.kv_page_size = kv_page_size
        self.kv_pages = kv_pages
        self.attn_backend = attn_backend
        self.kv_codec = kv_codec
        self.log_every = log_every
        self.emit = emit
        self._queue: list[Request] = []
        self._pool: SlotPool | None = None
        self._next_rid = 0

    # -- admission ---------------------------------------------------------
    def submit(self, prompt, max_new_tokens: int) -> Request:
        prompt = np.asarray(prompt, np.int32).ravel()
        if prompt.shape[0] > MAX_PROMPT_LEN:
            raise ValueError(
                f"prompt length {prompt.shape[0]} exceeds {MAX_PROMPT_LEN} "
                f"tokens; truncate the prompt")
        req = Request(self._next_rid, prompt, int(max_new_tokens),
                      t_submit=time.monotonic())
        self._next_rid += 1
        self._queue.append(req)
        return req

    def _ensure_pool(self) -> SlotPool:
        """(Re)build the pool when the queue needs longer slot caches."""
        eng = self.engine
        needed = max(eng.cache_len(r.prompt_len, r.max_new_tokens)
                     for r in self._queue)
        slot_len = self.slot_len or \
            -(-needed // SLOT_LEN_QUANTUM) * SLOT_LEN_QUANTUM
        if self._pool is None or self._pool.slot_len < slot_len or \
                self._pool.n_slots != self.batch_size:
            slot_len = max(slot_len, self._pool.slot_len if self._pool
                           else 0)
            self._pool = SlotPool(eng, self.batch_size, slot_len,
                                  page_size=self.kv_page_size,
                                  n_pages=self.kv_pages,
                                  backend=self.attn_backend,
                                  kv_codec=self.kv_codec)
        return self._pool

    # -- serving -----------------------------------------------------------
    def run(self) -> list[Request]:
        """Serve the queue to completion -> completed requests."""
        if not self._queue:
            return []
        tel = self.engine.telemetry
        completed: list[Request] = []
        pool = self._ensure_pool()
        while self._queue or pool.busy():
            if self._queue:
                with tel.timed("admit"):
                    self._admit(pool, completed)
            with tel.timed("mixed_step"):
                self._mixed_tick(pool, completed)
        if pool.codec:
            self.engine.metrics.record_kv_codec_error(
                pool.codec_error_bound())
        return completed

    def _record_first_token(self, req: Request, tok: int) -> None:
        req.generated.append(tok)
        req.t_first = time.monotonic()
        self.engine.metrics.record_ttft(req.t_first - req.t_submit)

    def _start(self, pool: SlotPool, req: Request) -> None:
        """Place ``req`` in a free slot in the PREFILLING state: its chunks
        write straight into the slot's pages."""
        slot = pool.free()[0]
        need = self.engine.cache_len(req.prompt_len, req.max_new_tokens)
        if need > pool.slot_len:
            raise ValueError(f"request {req.rid} needs {need} cache "
                             f"positions > slot_len {pool.slot_len}")
        slot.req = req
        slot.prefilling = True
        slot.prefill_cursor = 0
        req.t_admit = time.monotonic()

    def _maybe_finish(self, pool: SlotPool, slot: Slot,
                      completed: list[Request]) -> None:
        req = slot.req
        if len(req.generated) >= req.max_new_tokens:
            req.done = True
            req.t_done = time.monotonic()
            pool.retire(slot)
            completed.append(req)
            self.engine.metrics.record_completed(1)
            self.engine.metrics.record_request_done(req)

    def _admit(self, pool: SlotPool, completed: list[Request]) -> None:
        while self._queue:
            if not pool.free():
                return
            req = self._queue[0]
            if not pool.reserve_for(pool.free()[0], req):
                if not pool.busy():
                    # idle pool that still can't reserve: no retire will
                    # ever free pages, so deferring would spin forever
                    need = pool.pages_needed(self.engine.cache_len(
                        req.prompt_len, req.max_new_tokens))
                    raise ValueError(
                        f"request {req.rid} needs {need} KV pages but "
                        f"the pool only has {pool.allocator.total}; "
                        f"raise kv_pages")
                return      # admit when a retire returns pages
            self._queue.pop(0)
            # the reference materialises params at every admission; kept
            # so the decode-cache accounting matches it access for access
            self.engine.step_params()
            self._start(pool, req)

    def _mixed_tick(self, pool: SlotPool,
                    completed: list[Request]) -> None:
        """One iteration: every active slot contributes its decode token
        and every prefilling slot up to one prompt chunk (the total capped
        by ``prefill_budget``, at least one chunk), all through one ragged
        ``mixed_step`` over the page pools.  Blocks are padded to one width
        — ``prefill_chunk`` while chunks are in flight, 1 for pure decode —
        so the step sees two shapes only."""
        m = self.engine.metrics
        active = pool.active()
        chunks: list[tuple[Slot, int]] = []
        spent = 0
        for slot in pool.prefilling():
            if spent >= self.prefill_budget and chunks:
                break
            c = min(self.prefill_chunk,
                    slot.req.prompt_len - slot.prefill_cursor)
            chunks.append((slot, c))
            spent += c
        if not active and not chunks:
            return
        width = min(self.prefill_chunk, pool.slot_len) if chunks else 1
        toks = np.zeros((pool.n_slots, width), np.int32)
        poss = np.zeros(pool.n_slots, np.int32)
        q_lens = np.zeros(pool.n_slots, np.int32)
        for slot in active:
            toks[slot.index, 0] = slot.tok
            poss[slot.index] = slot.pos
            q_lens[slot.index] = 1
            pool._ensure_pages(slot, slot.pos)
        for slot, c in chunks:
            cur = slot.prefill_cursor
            toks[slot.index, :c] = slot.req.prompt[cur:cur + c]
            poss[slot.index] = cur
            q_lens[slot.index] = c
            pool._ensure_pages(slot, cur + c - 1)
        t0 = time.monotonic()
        params = self.engine.step_params()
        logits = pool.mixed_step(params, toks, poss, q_lens)
        # one host transfer per step: each slot's next token and whether
        # its last real row is finite
        rows = torch.from_numpy(np.maximum(q_lens - 1, 0).astype(np.int64))
        last = logits[torch.arange(pool.n_slots), rows.to(logits.device)]
        nxt = torch.argmax(last, dim=-1).cpu().numpy().astype(np.int32)
        finite = torch.isfinite(last).all(dim=-1).cpu().numpy()
        dt = time.monotonic() - t0
        # wall time attributed to decode vs prefill by token share
        n_chunk_toks = sum(c for _, c in chunks)
        total = len(active) + n_chunk_toks
        dt_decode = dt * len(active) / total if total else 0.0
        for slot in active:
            if not finite[slot.index]:
                raise RuntimeError(
                    f"non-finite logits in mixed step for request "
                    f"{slot.req.rid} (compressed reconstruction or model "
                    f"numerics are broken)")
            slot.req.generated.append(int(nxt[slot.index]))
            slot.pos += 1
            slot.tok = int(nxt[slot.index])
            self._maybe_finish(pool, slot, completed)
        for slot, c in chunks:
            m.record_prefill_chunk(c, (dt - dt_decode) / len(chunks),
                                   stalled=bool(active))
            slot.prefill_cursor += c
            if slot.prefill_cursor >= slot.req.prompt_len:
                if not finite[slot.index]:
                    raise RuntimeError(
                        "non-finite prefill logits (compressed "
                        "reconstruction or model numerics are broken)")
                req = slot.req
                slot.prefilling = False
                slot.tok = int(nxt[slot.index])
                slot.pos = self.engine.pos_offset(req.prompt_len)
                self._record_first_token(req, slot.tok)
                m.record_admit(1, 0.0, tokens=1)
                # the install copy the gathered oracle performs at the
                # end of every prefill never happens here
                m.record_prefill_gather(0, pool.install_bytes)
                self._maybe_finish(pool, slot, completed)
        if active:
            m.record_decode_step(len(active), dt_decode,
                                 n_slots=pool.n_slots)
            m.record_pages(pool.pages_in_use(), pool.allocator.total)
            m.record_kv_gather(0, pool.gather_bytes_avoided_per_step)
            if pool.codec:
                m.record_kv_codec(pool.pages_in_use() * pool.page_bytes_fp,
                                  pool.pages_in_use() *
                                  pool.page_bytes_resident)
            if self.log_every and m.decode_steps % self.log_every == 0:
                self.emit(self.engine.stats_line())

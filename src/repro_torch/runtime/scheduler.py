"""Slot-level continuous batching over per-slot KV lanes or paged KV
(port of ``repro.runtime.scheduler``).

Two attention backends, as in the reference (``attn_backend``):

* ``"cuda_paged"`` with ``prefill_chunk`` set: every iteration, active
  slots contribute their decode token and prefilling slots up to one prompt
  chunk to a *single* ragged ``mixed_step`` over the page pools
  (``Scheduler._mixed_tick``): chunk K/V is written straight into the
  slot's pages and the paged-attention kernel walks the page tables, so
  no KV is copied on the prefill or the decode path.  With monolithic
  prefill (``prefill_chunk=None``) a request is prefilled alone into a
  batch-1 lane cache at admission, installed into its pages (encoded into
  the code pools under the codec), and then decodes on the kernel at Q=1.
* ``"gathered"`` (the reference's oracle): each decode step copies every
  slot's pages into contiguous lane views, decodes all slots in one
  batched call of plain PyTorch attention, and scatters the pages back
  (under the codec: decoded at gather, re-encoded at scatter, which is
  idempotent, so untouched pages round-trip bit for bit).  Prompts are
  prefilled at admission, or chunk by chunk on a standalone batch-1 cache
  (``_prefill_tick``), and installed into the pool when done.
  ``kv_page_size=None`` keeps one monolithic lane per slot and no pages.

``mode="wave"`` admits only into a drained pool, up to ``batch_size``
queued requests of the head request's length bucket a round.

Invariants, as in the reference:

  * slot lifecycle — FREE (req is None) -> PREFILLING (chunks write into
    the slot's pages or its standalone cache) -> ACTIVE (decode advances
    ``pos``) -> FREE (retire releases pages and reservations);
  * page ownership — pages are refcounted, and a page with more than one
    owner (slots, the prefix index) never changes: a write to it copies it
    first (``SlotPool._prepare_write``), and the gathered backend's
    rewrites of shared pages carry the bytes they already hold; page 0 is
    the dummy sink that absorbs padded and free-lane writes and is never
    read as a valid position;
  * no mid-flight OOM — admission reserves every page the request can ever
    need; allocation during serving draws from that reservation.

``prefix_share=True`` keeps completed prompts' pages in a
:class:`~repro_torch.runtime.prefix_index.PrefixIndex`: a request that
extends a cached prefix maps those pages into its table at admission and
starts prefilling past them.  ``speculate="ngram" | "draft"`` verifies up
to ``draft_k`` draft tokens a slot a step: under ``cuda_paged`` in the
mixed step itself (Q = 1 + ``draft_k`` on decode ticks; rejected writes
to the pages are rewritten before they are read, and rolling lanes are
snapshotted and restored), on the other layouts in two passes, a scoring
pass on a copy of the cache and a committing pass at the accepted
lengths.

With a :class:`~repro_torch.runtime.telemetry.Telemetry` on the engine
(``ServeEngine(telemetry=...)``) the scheduler records the reference's
request lifecycle on each request's track (``queued``, ``admitted``,
``prefix_hit``, ``prefill`` or ``prefill_chunk``, ``first_token``,
``decode``, ``request``, ``retired``) and times its phases (``admit``,
``mixed_step``, ``prefill``, ``decode``, the KV copies, the speculative
rounds) on the host clock; telemetry never changes what is served.

An arch that lacks a capability is downgraded as the reference
downgrades it, with a warning and a note (``Scheduler``).  The kernel
autotuner is not ported yet and is refused with ``NotImplementedError``
rather than served some other way.
"""

from __future__ import annotations

import dataclasses
import time
import warnings
from typing import Callable

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.kernels import kv_codec as kv_codec_mod
from repro_torch.kernels.kv_codec import KV_CODECS
from repro_torch.models.api import (ATTN_BACKENDS, cache_layout, get_model,
                                    supports_chunked_prefill,
                                    supports_paged_attention,
                                    supports_prefix_share,
                                    supports_speculation)
from repro_torch.runtime.decode_cache import DecodeTileCache, EvictionPolicy
from repro_torch.runtime.drafter import make_drafter
from repro_torch.runtime.metrics import ServeMetrics
from repro_torch.runtime.prefix_index import PrefixIndex
from repro_torch.runtime.telemetry import (NULL_TELEMETRY, PID_REQUEST,
                                           Telemetry)
from repro_torch.runtime.weight_store import WeightStore
from repro_torch.tree import tree_leaves, tree_map

DEFAULT_BUCKETS = (16, 32, 64, 128, 256, 512, 1024, 2048)
SLOT_LEN_QUANTUM = 16      # slot cache lengths round up to this many tokens
DUMMY_PAGE = 0             # physical page that absorbs padded writes

# capability downgrades warn once per (arch family, capability), as the
# reference's do
_FALLBACK_WARNED: set = set()


def _warn_fallback(family: str, capability: str, message: str) -> None:
    key = (family, capability)
    if key in _FALLBACK_WARNED:
        return
    _FALLBACK_WARNED.add(key)
    warnings.warn(message, RuntimeWarning, stacklevel=3)


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
    admission-time reservations and per-page refcounts.

    ``reserve(n)`` earmarks capacity; ``alloc`` hands out a page against
    an existing reservation at refcount 1, so allocation during serving
    can never fail mid-request.  ``share`` takes one more reference on an
    allocated page (prefix sharing: no free-list traffic, no
    reservation), and ``release`` drops one reference a call: a page
    returns to the free list when its last reference goes.  Releasing a
    page that is not allocated, or sharing one, raises ``ValueError``."""

    def __init__(self, page_ids):
        ids = list(page_ids)
        self.total = len(ids)
        self._free = sorted(ids, reverse=True)    # pop() -> ascending ids
        self._allocated: set[int] = set()
        self._refs: dict[int, int] = {}
        self.reserved = 0

    @property
    def n_free(self) -> int:
        return len(self._free)

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
        """One page against an existing reservation (refcount 1)."""
        assert self.reserved > 0, "alloc without reservation"
        assert self._free, "reservation invariant broken: no free pages"
        self.reserved -= 1
        pid = self._free.pop()
        self._allocated.add(pid)
        self._refs[pid] = 1
        return pid

    def share(self, pid: int) -> int:
        """One more reference on an allocated page."""
        if pid not in self._allocated:
            raise ValueError(f"share of unallocated page {pid}")
        self._refs[pid] += 1
        return pid

    def refcount(self, pid: int) -> int:
        return self._refs.get(pid, 0)

    def shared_pages(self) -> int:
        """Physical pages referenced by more than one owner."""
        return sum(1 for r in self._refs.values() if r >= 2)

    def release(self, page_ids) -> None:
        """Drop one reference a page; a page returns to the free list when
        its last reference goes."""
        for pid in page_ids:
            if pid not in self._allocated:
                raise ValueError(f"double free of page {pid}")
            self._refs[pid] -= 1
            if self._refs[pid] == 0:
                del self._refs[pid]
                self._allocated.remove(pid)
                self._free.append(pid)

    def add_pages(self, page_ids) -> None:
        """Grow the pool (``SlotPool.grow_pages``)."""
        ids = list(page_ids)
        assert not (set(ids) & self._allocated) and \
            not (set(ids) & set(self._free))
        self.total += len(ids)
        self._free.extend(sorted(ids, reverse=True))




def _on_device(a, device) -> torch.Tensor:
    """Host int array -> int32 tensor on ``device``."""
    return torch.from_numpy(np.ascontiguousarray(a, np.int32)).to(device)


def _unflatten(specs, leaves):
    """``leaves`` in :func:`tree_leaves` order, rebuilt in ``specs``'s
    tree."""
    it = iter(leaves)
    return tree_map(lambda _: next(it), specs)


class ServeEngine:
    """Model + compressed weight store + decode cache + metrics, on
    ``device`` (default ``"cuda"``; ``"cpu"`` runs the plain versions).

    ``compress=True`` binarises and Huffman-compresses the MLP projections
    into the store and serves in BNN-MLP mode (``cfg.binarize_mlp``);
    ``compress=False`` serves the params as given.  ``params`` is the
    model's tree of tensors (moved to ``device``).  ``telemetry`` accepts a
    :class:`~repro_torch.runtime.telemetry.Telemetry` recorder
    (request-lifecycle spans + phase histograms); the default is the
    zero-cost null recorder, and telemetry never changes generated
    tokens."""

    def __init__(self, cfg, params, *, device="cuda", compress: bool = True,
                 cache_bytes: int | None = None,
                 cache_policy: str | EvictionPolicy | None = None,
                 prefetch: bool = True,
                 telemetry: Telemetry | None = None):
        self.device = resolve_device(device)
        params = tree_map(lambda a: a.to(self.device), params)
        self.cache = DecodeTileCache(cache_bytes, policy=cache_policy)
        self.telemetry = telemetry if telemetry is not None \
            else NULL_TELEMETRY
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
        # each cache leaf's batch axis: a lane pool (n_slots, *leaf) is
        # viewed with its slot axis there for the batched slot decode
        self._batch_axes = cache_layout(self.api, cfg, SLOT_LEN_QUANTUM)[0]

    @property
    def supports_chunked_prefill(self) -> bool:
        return self.api.prefill_chunk is not None and \
            supports_chunked_prefill(self.cfg)

    @property
    def supports_paged_attention(self) -> bool:
        return self.api.mixed_step is not None and \
            supports_paged_attention(self.cfg)

    def mixed_step(self, params, kcache, table, toks, poss, q_lens, *,
                   paged_flags: tuple, page_size: int, kv_scales=None):
        """One ragged mixed step for every slot over the page pools:
        table (S, P), toks (S, Q), poss (S,), q_lens (S,) host int arrays
        -> (logits (S, Q, V) f32 on device, cache with pools updated in
        place).  ``kv_scales`` (``kv_codec="cluster"``): the scale-pool
        tree beside int8 code pools, updated in place too; the return
        grows to ``(logits, cache, scales)``."""
        dev = self.device
        with torch.no_grad():
            return self.api.mixed_step(
                self.cfg, params, kcache, _on_device(table, dev),
                _on_device(toks, dev), _on_device(poss, dev),
                _on_device(q_lens, dev), paged_flags=paged_flags,
                page_size=page_size, scales=kv_scales)

    def step_params(self):
        """Per-step serving params (tile-cache-served when compressed)."""
        if self.compressed:
            with torch.no_grad():
                return self.store.materialize(self.model_id)
        return self._raw_params

    def extra_inputs(self, batch: int) -> tuple:
        """The stubbed multimodal frontends' outputs, as the reference's:
        zero vision embeddings (vlm) or zero frame embeddings (audio) for
        ``batch`` prompts; nothing for the text-only families."""
        cfg = self.cfg
        rows = {"vlm": cfg.num_vision_tokens,
                "audio": cfg.encoder_seq}.get(cfg.family)
        if rows is None:
            return ()
        return (torch.zeros((batch, rows, cfg.d_model),
                            dtype=cfg.torch_dtype, device=self.device),)

    def pos_offset(self, prompt_len: int) -> int:
        """Absolute position of the first generated token: behind the
        vision prefix for a vlm."""
        if self.cfg.family == "vlm":
            return prompt_len + self.cfg.num_vision_tokens
        return prompt_len

    def cache_len(self, prompt_len: int, gen: int) -> int:
        return self.pos_offset(prompt_len) + gen

    def prefill(self, params, tokens, cache, *extra):
        """Whole-prompt prefill of ``tokens`` (B, S) into ``cache``, behind
        ``extra`` (:meth:`extra_inputs`) -> (last-token logits (B, 1, V),
        cache filled in place)."""
        with torch.no_grad():
            if self.cfg.family == "vlm":
                return self.api.prefill(self.cfg, params, tokens, cache,
                                        vision_embeds=extra[0])
            return self.api.prefill(self.cfg, params, tokens, cache, *extra)

    def prefill_request(self, params, prompt: np.ndarray, slot_len: int):
        """Batch-1 exact-position prefill -> (first generated token, filled
        slot cache with leaves (1, ...))."""
        cache = self.fresh_slot_cache(slot_len)
        logits, cache = self.prefill(
            params, _on_device(np.asarray(prompt)[None], self.device), cache,
            *self.extra_inputs(1))
        last = logits[0, -1]
        if not bool(torch.isfinite(last).all()):
            raise RuntimeError(
                "non-finite prefill logits (compressed reconstruction or "
                "model numerics are broken)")
        return int(torch.argmax(last)), cache

    def fresh_slot_cache(self, slot_len: int):
        """Zeroed batch-1 lane cache for a prefill."""
        return self.api.init_cache(self.cfg, 1, slot_len, self.device)

    def prefill_chunk_step(self, params, cache, chunk: np.ndarray,
                           pos: int, *, kv_quant: bool = False):
        """One prompt chunk at absolute positions pos..pos+len-1 ->
        (last-position logits, cache updated in place).  ``kv_quant``
        rounds the chunk's K/V through the cluster codec (the gathered
        backend under ``kv_codec="cluster"``)."""
        toks = _on_device(np.asarray(chunk)[None], self.device)
        with torch.no_grad():
            return self.api.prefill_chunk(self.cfg, params, cache, toks, pos,
                                          kv_quant=kv_quant)

    def _lane_views(self, pooled_cache):
        """Views of a slot pool's leaves (S, *lane leaf) with the slot
        axis where a lane cache's batch axis sits: writes through them
        land in the pool."""
        axes = iter(self._batch_axes)

        def lane_view(a):
            bax = next(axes)
            return a.squeeze(bax + 1).movedim(0, bax)

        return tree_map(lane_view, pooled_cache)

    def slot_decode(self, params, pooled_cache, toks, poss, *,
                    kv_quant: bool = False):
        """One decode step for every slot: ``pooled_cache`` leaves
        (S, *lane leaf), toks (S, 1, 1), poss (S,) host int arrays ->
        (logits (S, 1, 1, V), pooled cache updated in place).

        The reference vmaps a batch-1 decode over the slots; here the
        slots ride one batched call with per-lane positions over views
        of the pool that put the slot axis where the batch axis sits, and
        ``per_lane`` keeps their MoE capacity apart, as the vmap does."""
        lanes = self._lane_views(pooled_cache)
        s_n = toks.shape[0]
        with torch.no_grad():
            logits, _ = self.api.decode_step(
                self.cfg, params, lanes,
                _on_device(np.asarray(toks).reshape(s_n, 1), self.device),
                _on_device(poss, self.device), kv_quant=kv_quant,
                per_lane=True)
        return logits[:, None], pooled_cache

    def verify_slots(self, params, pooled_cache, toks, poss, q_lens, *,
                     kv_quant: bool = False):
        """Speculative verification over slot lanes: ``pooled_cache``
        leaves (S, *lane leaf), toks (S, 1, Q), poss (S,) start positions,
        q_lens (S,) real token counts (0: an idle lane, left as it was)
        host int arrays -> (full logits (S, 1, Q, V), pooled cache with
        each lane's ``q_lens`` tokens written in place).

        The reference vmaps a batch-1 ``verify_step`` over the slots; here
        they ride one batched call with per-lane positions and ``q_lens``
        over the same lane views :meth:`slot_decode` uses.  The reference
        keeps its scoring pass's cache by not donating it; this call
        always writes, so a caller that only scores passes a copy."""
        lanes = self._lane_views(pooled_cache)
        s_n = toks.shape[0]
        dev = self.device
        with torch.no_grad():
            logits, _ = self.api.verify_step(
                self.cfg, params, lanes,
                _on_device(np.asarray(toks).reshape(s_n, -1), dev),
                _on_device(poss, dev), _on_device(q_lens, dev),
                kv_quant=kv_quant, per_lane=True)
        return logits[:, None], pooled_cache

    def decode_step(self, params, cache, tok, pos: int):
        """Single shared-position decode of a batched lane cache (slot
        serving goes through :meth:`slot_decode`)."""
        with torch.no_grad():
            return self.api.decode_step(
                self.cfg, params, cache, _on_device(tok, self.device), pos)

    def stats_line(self) -> str:
        return self.metrics.stats_line(self.cache if self.compressed
                                       else None)

    def render_prom(self) -> str:
        """Prometheus text exposition of every serving metric: the
        ServeMetrics counters + histograms, the decode-cache and
        weight-store counters, and any telemetry phase histograms."""
        return self.metrics.render_prom(cache=self.cache, store=self.store,
                                        telemetry=self.telemetry)


@dataclasses.dataclass
class Slot:
    """One decode lane: its request and per-slot state.  ``tok`` is the
    most recent token (the next decode input), ``pos`` its absolute
    position; while ``prefilling``, ``prefill_cursor`` counts prompt
    tokens already written, into the slot's pages on the mixed path or
    into ``pcache`` (a standalone batch-1 lane cache, installed into the
    pool when the last chunk lands) on the chunk loop.  ``reserved_left``
    is the slot's outstanding page reservation.  ``prefix_matched``
    counts prompt tokens mapped from the prefix index at admission (the
    cursor starts there); ``_prefix_nodes`` holds the mapped nodes until
    the slot's standalone cache is seeded from them."""

    index: int
    req: Request | None = None
    pos: int = 0
    tok: int = 0
    prefilling: bool = False
    prefill_cursor: int = 0
    pcache: object = None
    reserved_left: int = 0
    prefix_matched: int = 0
    _prefix_nodes: list | None = None


class SlotPool:
    """Fixed decode slots over one pooled KV cache, in one of three
    layouts:

    * ``page_size=None``: monolithic — each cache leaf is one pool
      ``(n_slots, *lane leaf)`` (``(n_slots, 1, slot_len, ...)``; scan
      leaves ``(n_slots, R, 1, slot_len, ...)``), slot ``i`` its lane ``i``,
      decoded in place by the batched slot decode;
    * ``backend="gathered"``: each pageable leaf (one whose length scales
      with ``slot_len``, by ``models.api.cache_layout``'s probe) becomes a
      page pool ``(page_capacity, *lead, page_size, *rest)``; a decode step
      gathers every slot's pages into lane views, decodes them, and
      scatters them back (``gather_bytes_per_step``: two copies of every
      paged leaf's per-slot views).  Leaves that do not page
      (rolling-window KV) stay lanes ``(n_slots, *lane leaf)``.  Under
      ``kv_codec="cluster"`` the pools hold int8 codes with
      ``page_scales`` beside them, ``(page_capacity, *lead, page_size)``
      f32;
    * ``backend="cuda_paged"``: each pageable leaf becomes a pool
      ``(repeats?, page_capacity, page_size, KH, D)`` in the kernel's
      layout, handed with the page table to ``mixed_step``, whose kernel
      walks the table in place; ``kscales`` is the codec's scale-pool tree
      ``(repeats?, page_capacity, page_size)``.  A leaf that does not page
      (a rolling window shorter than the slot) is a lane in the kernel
      layout, ``(repeats?, n_slots, W, KH, D)``: its slot axis where the
      batch axis sits and the W rolling rows behind it, raw under the
      codec (None in ``kscales``); its block attends on the lanes in the
      same ``mixed_step``.  When no leaf pages, the kernel never runs.

    Pages are allocated on demand as a slot's writes reach them and
    released at retire; page 0 is the dummy sink.  ``prefix_share=True``
    (every leaf must page) keeps a :class:`PrefixIndex` over the
    allocator: completed prompts' pages are registered in it, a later
    request maps its matched prefix's pages into its table, and any write
    to a page with more than one reference copies it first
    (:meth:`_prepare_write`).  ``page_capacity``
    (default ``n_pages``) sizes the buffers: :meth:`grow_pages` within it
    only adds free pages.  ``page_bytes_fp`` and ``page_bytes_resident``
    give a physical page's bytes over every paged leaf without and with
    the codec."""

    def __init__(self, engine: ServeEngine, n_slots: int, slot_len: int,
                 *, page_size: int | None = None,
                 n_pages: int | None = None, backend: str = "cuda_paged",
                 page_capacity: int | None = None, kv_codec: str = "none",
                 prefix_share: bool = False):
        if backend not in ATTN_BACKENDS:
            raise ValueError(f"unknown attention backend {backend!r}; "
                             f"choose from {ATTN_BACKENDS}")
        if kv_codec not in KV_CODECS:
            raise ValueError(f"unknown kv codec {kv_codec!r}; "
                             f"choose from {KV_CODECS}")
        self.engine = engine
        self.n_slots = n_slots
        self.page_size = page_size
        self.paged = page_size is not None
        self.backend = backend
        self.codec = kv_codec == "cluster"
        if backend == "cuda_paged" and not self.paged:
            raise ValueError("the cuda_paged backend needs paged KV lanes; "
                             "set a page_size")
        if self.codec and not self.paged:
            raise ValueError("kv_codec='cluster' compresses the page "
                             "pools; set a kv page_size")
        if prefix_share and not self.paged:
            raise ValueError("prefix_share maps shared KV pages; set a "
                             "page_size")
        self.prefix: PrefixIndex | None = None
        # rolling lanes beside the cuda_paged pools: (leaf index, slot axis,
        # rows W) each; speculation snapshots the rows drafts overwrite,
        # and the fewest rows of any lane cap the draft depth
        self._lane_info: list[tuple[int, int, int]] = []
        self.lane_min_rows = None
        if self.paged:
            if page_size <= 0:
                raise ValueError(f"page_size must be positive: {page_size}")
            slot_len = -(-slot_len // page_size) * page_size
        self.slot_len = slot_len
        self.pages_per_slot = slot_len // page_size if self.paged else 0
        self.slots = [Slot(i) for i in range(n_slots)]
        self.kscales = None          # cuda_paged codec scale-pool tree
        self.page_scales = []        # gathered codec scale pools
        self.page_bytes_fp = self.page_bytes_resident = 0
        self._specs = engine.api.init_cache_specs(engine.cfg, 1, slot_len)
        leaves = tree_leaves(self._specs)
        # install() copies one prefilled batch-1 cache into the slot's
        # pages and lanes; the mixed-step path never installs
        self.install_bytes = sum(s.numel() * s.element_size()
                                 for s in leaves)
        dev = engine.device
        if not self.paged:
            self.cache = tree_map(
                lambda s: torch.zeros((n_slots, *s.shape), dtype=s.dtype,
                                      device=dev), self._specs)
            self.gather_bytes_per_step = 0
            self.gather_bytes_avoided_per_step = 0
            return
        self._batch_axis, self._paged_axis = cache_layout(
            engine.api, engine.cfg, slot_len)
        self.paged_flags = tuple(ax is not None for ax in self._paged_axis)
        if n_pages is None:
            n_pages = n_slots * self.pages_per_slot + 1   # +1: dummy sink
        if n_pages < self.pages_per_slot + 1:
            raise ValueError(
                f"n_pages {n_pages} cannot back even one full slot "
                f"({self.pages_per_slot} pages + dummy)")
        self.n_pages = n_pages
        self.page_capacity = cap = max(page_capacity or 0, n_pages)
        self.allocator = PageAllocator(range(1, n_pages))   # 0 = dummy
        self.table = np.zeros((n_slots, self.pages_per_slot), np.int32)
        # the gathered backend copies every paged leaf's per-slot view
        # twice per step (pool -> view, view -> pool); the kernel backend
        # copies none of it
        view_bytes = 2 * n_slots * sum(
            s.numel() * s.element_size()
            for s, ax in zip(leaves, self._paged_axis) if ax is not None)
        # a physical page's bytes over every paged leaf: fp at rest vs the
        # codec's int8 codes + one f32 scale per (page, token)
        for spec, ax in zip(leaves, self._paged_axis):
            if ax is None:
                continue
            elems = spec.numel() // spec.shape[ax] * page_size
            feat = int(np.prod(spec.shape[ax + 1:])) or 1
            self.page_bytes_fp += elems * spec.element_size()
            self.page_bytes_resident += elems + (elems // feat) * 4 \
                if self.codec else elems * spec.element_size()
        if prefix_share:
            # a mapped prefix must carry the request's whole state
            if not all(self.paged_flags):
                raise ValueError(
                    "prefix_share needs every cache leaf paged; this arch "
                    "keeps per-slot lanes a shared page cannot carry")
            self.prefix = PrefixIndex(self.allocator, page_size,
                                      page_bytes=self.page_bytes_resident)
        code_dtype = (lambda s: torch.int8 if self.codec else s.dtype)
        if backend == "cuda_paged":
            self.gather_bytes_per_step = 0
            self.gather_bytes_avoided_per_step = view_bytes

            def pools(leaf, lane):
                """One buffer per leaf: a pageable leaf's batch axis
                becomes the physical page axis and its length axis the
                page rows; any other leaf is ``lane(spec, batch axis)``."""
                axes = iter(zip(self._paged_axis, self._batch_axis))

                def make(spec):
                    ax, bax = next(axes)
                    if ax is None:
                        return lane(spec, bax)
                    tail, dtype = leaf(spec, ax)
                    return torch.zeros((*spec.shape[:ax - 1], cap,
                                        page_size, *tail), dtype=dtype,
                                       device=dev)
                return tree_map(make, self._specs)

            self.kcache = pools(
                lambda spec, ax: (spec.shape[ax + 1:], code_dtype(spec)),
                lambda spec, bax: torch.zeros(
                    (*spec.shape[:bax], n_slots, *spec.shape[bax + 1:]),
                    dtype=spec.dtype, device=dev))
            self.kscales = pools(lambda spec, ax: ((), torch.float32),
                                 lambda spec, bax: None) \
                if self.codec else None
            self._lane_info = [
                (li, bax, spec.shape[bax + 1]) for li, (spec, ax, bax) in
                enumerate(zip(leaves, self._paged_axis, self._batch_axis))
                if ax is None]
            self.lane_min_rows = min((w for _, _, w in self._lane_info),
                                     default=None)
            return
        self.gather_bytes_per_step = view_bytes
        self.gather_bytes_avoided_per_step = 0
        self.pages = [
            torch.zeros((cap, *s.shape[:ax], page_size, *s.shape[ax + 1:]),
                        dtype=code_dtype(s), device=dev)
            for s, ax in zip(leaves, self._paged_axis) if ax is not None]
        self.page_scales = [
            torch.zeros((cap, *s.shape[:ax], page_size),
                        dtype=torch.float32, device=dev)
            for s, ax in zip(leaves, self._paged_axis)
            if ax is not None] if self.codec else []
        self.unpaged = [
            torch.zeros((n_slots, *s.shape), dtype=s.dtype, device=dev)
            for s, ax in zip(leaves, self._paged_axis) if ax is None]

    # -- gathered backend: page pools <-> lane views ------------------------
    def _gather(self, table: torch.Tensor):
        """Every slot's pages as lane views (S, *lane leaf) — decoded to
        the leaf dtype under the codec — and the lane leaves themselves."""
        views, pi, ui = [], 0, 0
        for spec, ax in zip(tree_leaves(self._specs), self._paged_axis):
            if ax is None:
                views.append(self.unpaged[ui])
                ui += 1
                continue
            v = self.pages[pi][table]          # (S, P, *lead, page, *rest)
            if self.codec:
                sc = self.page_scales[pi][table]    # (S, P, *lead, page)
                v = kv_codec_mod.decode(
                    v, sc.reshape(*sc.shape, *(1,) * (v.ndim - sc.ndim))
                ).to(spec.dtype)
            pi += 1
            v = v.movedim(1, 1 + ax)           # (S, *lead, P, page, *rest)
            views.append(v.reshape(*v.shape[:1 + ax], self.slot_len,
                                   *v.shape[3 + ax:]))
        return _unflatten(self._specs, views)

    def _put_pages(self, pi: int, idx, v: torch.Tensor, rest: int) -> None:
        """Write page-major values ``v`` (..., page, *rest) into pool
        ``pi`` at physical pages ``idx``, re-encoded under the codec
        (one scale per (page, token) over the ``rest`` trailing dims)."""
        if self.codec:
            v, sc = kv_codec_mod.encode(v, tuple(range(v.ndim - rest,
                                                       v.ndim)))
            self.page_scales[pi][idx] = sc
        self.pages[pi][idx] = v.to(self.pages[pi].dtype)

    def _scatter(self, views, table: torch.Tensor) -> None:
        """Write lane views (S, *lane leaf) back into every slot's pages
        (the lanes were updated in place)."""
        pi = 0
        for leaf, ax in zip(tree_leaves(views), self._paged_axis):
            if ax is None:
                continue
            v = leaf.reshape(*leaf.shape[:1 + ax], self.pages_per_slot,
                             self.page_size, *leaf.shape[2 + ax:])
            self._put_pages(pi, table, v.movedim(1 + ax, 1),
                            leaf.ndim - ax - 2)
            pi += 1

    def _lane_scatter(self, cache1, row: torch.Tensor, i: int) -> None:
        """Install a batch-1 lane cache into the pages ``row`` of slot
        ``i`` and its lane leaves."""
        pi = ui = 0
        for leaf, ax in zip(tree_leaves(cache1), self._paged_axis):
            if ax is None:
                self.unpaged[ui][i] = leaf
                ui += 1
                continue
            v = leaf.reshape(*leaf.shape[:ax], self.pages_per_slot,
                             self.page_size, *leaf.shape[ax + 1:])
            self._put_pages(pi, row, v.movedim(ax, 0), leaf.ndim - ax - 1)
            pi += 1

    # -- cuda_paged: admission install and page copy ------------------------
    def _kernel_install(self, cache1, row: torch.Tensor, i: int) -> None:
        """Install a batch-1 lane cache into the slot's pages ``row`` of
        the kernel-layout pools, encoded into codes + scales under the
        codec, and into lane ``i`` of its lane leaves, raw."""
        sleaves = tree_leaves(self.kscales) if self.codec else None
        for li, (pool, src, ax, bax) in enumerate(zip(
                tree_leaves(self.kcache), tree_leaves(cache1),
                self._paged_axis, self._batch_axis)):
            if ax is None:
                pool.select(bax, i).copy_(src.squeeze(bax))
                continue
            # (*lead, 1, L, *rest) -> (*lead, P, page, *rest)
            v = src.reshape(*src.shape[:ax - 1], self.pages_per_slot,
                            self.page_size, *src.shape[ax + 1:])
            idx = (slice(None),) * (ax - 1) + (row,)
            if self.codec:
                v, sc = kv_codec_mod.encode(v, tuple(range(ax + 1, v.ndim)))
                sleaves[li][idx] = sc
            pool[idx] = v.to(pool.dtype)

    def _copy_page(self, src: int, dst: int) -> None:
        """Copy physical page ``src`` into ``dst`` across every pool and
        scale pool, in either backend's layout: the copy of
        :meth:`_prepare_write`.  Under the codec the scales travel with
        the codes, so the copy decodes to the same (page, token) values."""
        with self.engine.telemetry.timed("kv_cow"):
            if self.backend == "cuda_paged":
                pools = list(tree_leaves(self.kcache))
                if self.codec:
                    pools += tree_leaves(self.kscales)
                for pool, ax in zip(pools, self._paged_axis * 2):
                    if ax is None:           # a lane holds no pages
                        continue
                    lead = (slice(None),) * (ax - 1)
                    pool[lead + (dst,)] = pool[lead + (src,)]
                return
            for pool in self.pages + self.page_scales:
                pool[dst] = pool[src]

    # -- prefix sharing -----------------------------------------------------
    def map_prefix(self, slot: Slot, req: Request, align: int) -> int:
        """Map the longest cached prefix of ``req``'s prompt into the
        slot's page table (one reference a page, owned by the slot and
        released by retire) -> matched tokens.  ``align`` is the prefill
        chunk size: the match is floored to a chunk boundary, so the
        suffix is computed on the sharing-off run's chunks."""
        if self.prefix is None:
            return 0
        nodes, matched = self.prefix.lookup(req.prompt,
                                            req.prompt_len - 1, align)
        if not matched:
            return 0
        row = self.table[slot.index]
        for j, node in enumerate(nodes):
            row[j] = self.allocator.share(node.page)
        self.prefix.hit(nodes)
        slot.prefix_matched = matched
        slot._prefix_nodes = nodes
        return matched

    def unmap_prefix(self, slot: Slot) -> None:
        """Roll back :meth:`map_prefix` (the reservation failed)."""
        if not slot.prefix_matched:
            return
        row = self.table[slot.index]
        n = -(-slot.prefix_matched // self.page_size)
        self.allocator.release(int(row[j]) for j in range(n))
        row[:n] = DUMMY_PAGE
        slot.prefix_matched = 0
        slot._prefix_nodes = None

    def seed_pcache(self, slot: Slot) -> None:
        """Write the mapped prefix's raw-fp fragments into the slot's
        fresh standalone prefill cache at positions [0, matched): the
        values the sharing-off chunk loop computes there (gathered chunk
        loop only; the mixed step reads the shared pool pages in
        place)."""
        matched = slot.prefix_matched
        if not matched or slot.pcache is None:
            return
        leaves = tree_leaves(slot.pcache)
        P = self.page_size
        for k, node in enumerate(slot._prefix_nodes):
            lo, hi = k * P, min((k + 1) * P, matched)
            if hi <= lo:
                break
            frags = iter(node.frag)
            for leaf, ax in zip(leaves, self._paged_axis):
                if ax is None:
                    continue
                lead = (slice(None),) * ax
                leaf[lead + (slice(lo, hi),)] = \
                    next(frags)[lead + (slice(0, hi - lo),)]

    def register_prefix(self, slot: Slot, cache1=None) -> None:
        """Insert a just-prefilled slot's pages into the prefix index: its
        full prompt pages and the partial boundary page (whose first write
        by this slot then copies it, funded by one more reservation taken
        here).  ``cache1``: the gathered chunk loop's completed standalone
        cache, whose raw-fp page slices the nodes keep as fragments."""
        if self.prefix is None:
            return
        req = slot.req
        L, P = req.prompt_len, self.page_size
        row = self.table[slot.index]
        frags = self._extract_frags(cache1, -(-L // P)) \
            if cache1 is not None else None
        if L % P and self.allocator.reserve(1):
            if self.prefix.register(req.prompt, row, frags=frags,
                                    allow_partial=True):
                slot.reserved_left += 1
            else:
                self.allocator.unreserve(1)
        else:
            self.prefix.register(req.prompt, row, frags=frags,
                                 allow_partial=False)

    def _extract_frags(self, cache1, n_pages: int) -> list:
        """Each paged leaf's per-page slices of a standalone batch-1 cache,
        cloned on its device -> frags[page][leaf]."""
        P = self.page_size
        leaves = tree_leaves(cache1)
        return [[leaf[(slice(None),) * ax + (slice(j * P, (j + 1) * P),)]
                 .clone() for leaf, ax in zip(leaves, self._paged_axis)
                 if ax is not None] for j in range(n_pages)]

    def _prepare_write(self, slot: Slot, lo_pos: int, hi_pos: int) -> None:
        """Copy-on-write barrier: before positions [lo_pos, hi_pos] of the
        slot are written, every page backing them that has another
        reference (the prefix index, another slot) is copied into a fresh
        page, drawn on the slot's reservation, and swapped into its
        table row."""
        if self.prefix is None:
            return
        row = self.table[slot.index]
        P = self.page_size
        for j in range(lo_pos // P, hi_pos // P + 1):
            pid = int(row[j])
            if pid == DUMMY_PAGE or self.allocator.refcount(pid) < 2:
                continue
            new = self.allocator.alloc()
            slot.reserved_left -= 1
            assert slot.reserved_left >= 0
            self._copy_page(pid, new)
            row[j] = new
            self.allocator.release([pid])
            self.engine.metrics.record_prefix_cow()

    # -- speculative decoding -----------------------------------------------
    def _lane_rows(self, leaf: torch.Tensor, bax: int, poss, k: int):
        """A rolling lane viewed (slots, W, ...) and the index of rows
        (pos + 1 + i) % W, i < k, that draft tokens 0..k-1 write."""
        l2 = leaf.movedim((bax, bax + 1), (0, 1))
        dev = leaf.device
        p = torch.as_tensor(np.asarray(poss), dtype=torch.long, device=dev)
        rows = (p[:, None] + 1 + torch.arange(k, device=dev)) % l2.shape[1]
        return l2, (torch.arange(self.n_slots, device=dev)[:, None], rows)

    def spec_snapshot(self, poss, k: int):
        """Copies of the rolling-lane rows draft tokens will overwrite
        this step (``cuda_paged``; None without lanes)."""
        if not self._lane_info:
            return None
        leaves = tree_leaves(self.kcache)
        out = []
        for li, bax, _ in self._lane_info:
            l2, idx = self._lane_rows(leaves[li], bax, poss, k)
            out.append(l2[idx])
        return out

    def spec_restore(self, snaps, poss, keep) -> None:
        """Undo rejected drafts' rolling-lane writes: ``keep`` (S, k)
        marks the rows to put back.  Paged leaves need none of this: a
        position past the accepted ones is written again before any query
        can attend it."""
        keep = np.asarray(keep)
        if snaps is None or not keep.any():
            return
        leaves = tree_leaves(self.kcache)
        for (li, bax, _), snap in zip(self._lane_info, snaps):
            l2, idx = self._lane_rows(leaves[li], bax, poss, keep.shape[1])
            m = torch.from_numpy(keep).to(snap.device).reshape(
                *keep.shape, *(1,) * (snap.ndim - 2))
            l2[idx] = torch.where(m, snap, l2[idx])

    def spec_score(self, params, toks, poss, q_lens):
        """Speculative phase 1 on the gathered and monolithic layouts:
        score the ragged draft blocks on a copy of the slots' lanes, so
        the resident cache is left as it was -> (logits (S, 1, Q, V), the
        commit context).  The blocks write as they attend, and a rejected
        draft's K/V left in a lane would corrupt it (a rolling row holds
        an earlier position)."""
        assert self.backend != "cuda_paged"
        if self.paged:
            tel = self.engine.telemetry
            table = torch.from_numpy(self.table.astype(np.int64)).to(
                self.engine.device)
            with tel.timed("kv_decode" if self.codec else "kv_gather"):
                views = self._gather(table)
            logits, _ = self.engine.verify_slots(
                params, tree_map(torch.clone, views), toks, poss, q_lens,
                kv_quant=self.codec)
            return logits, (views, table)
        logits, _ = self.engine.verify_slots(
            params, tree_map(torch.clone, self.cache), toks, poss, q_lens)
        return logits, None

    def spec_commit(self, params, toks, poss, commit_lens, ctx) -> None:
        """Speculative phase 2: run the blocks again at the accepted
        lengths on the resident lanes (the gathered views, scattered back
        after), so exactly the accepted tokens' K/V lands."""
        assert self.backend != "cuda_paged"
        if self.paged:
            views, table = ctx
            self.engine.verify_slots(params, views, toks, poss, commit_lens,
                                     kv_quant=self.codec)
            with self.engine.telemetry.timed(
                    "kv_encode" if self.codec else "kv_scatter"):
                self._scatter(views, table)
        else:
            self.engine.verify_slots(params, self.cache, toks, poss,
                                     commit_lens)

    # -- page bookkeeping ---------------------------------------------------
    def pages_needed(self, cache_len: int) -> int:
        return -(-cache_len // self.page_size) if self.paged else 0

    def pages_in_use(self) -> int:
        return self.allocator.n_allocated if self.paged else 0

    def _ensure_pages(self, slot: Slot, upto_pos: int) -> None:
        """Allocate table entries so positions [0, upto_pos] are backed."""
        need = upto_pos // self.page_size + 1
        assert need <= self.pages_per_slot, (need, self.pages_per_slot)
        for j in range(need):
            if self.table[slot.index, j] == DUMMY_PAGE:
                self.table[slot.index, j] = self.allocator.alloc()
                slot.reserved_left -= 1
                assert slot.reserved_left >= 0

    def grow_pages(self, n_pages: int) -> None:
        """Grow the logical page pool to ``n_pages``.  Within
        ``page_capacity`` this is free-list bookkeeping only: no buffer is
        reallocated.  Beyond it the buffers grow with geometric headroom
        (at least double)."""
        assert self.paged, "grow_pages on a monolithic pool"
        if n_pages <= self.n_pages:
            return
        if n_pages > self.page_capacity:
            new_cap = max(n_pages, 2 * self.page_capacity)
            extra = new_cap - self.page_capacity

            def grow(pool, axis):
                pad = torch.zeros((*pool.shape[:axis], extra,
                                   *pool.shape[axis + 1:]), dtype=pool.dtype,
                                  device=pool.device)
                return torch.cat([pool, pad], dim=axis)

            if self.backend == "cuda_paged":
                # lanes (and their None scales) are per slot: left alone
                axes = iter(self._paged_axis)

                def grow_leaf(p):
                    ax = next(axes)
                    return p if ax is None else grow(p, ax - 1)

                self.kcache = tree_map(grow_leaf, self.kcache)
                if self.codec:
                    self.kscales = tree_map(
                        lambda s: s if s is None else grow(s, s.ndim - 2),
                        self.kscales)
            else:
                self.pages = [grow(p, 0) for p in self.pages]
                self.page_scales = [grow(s, 0) for s in self.page_scales]
            self.page_capacity = new_cap
        self.allocator.add_pages(range(self.n_pages, n_pages))
        self.n_pages = n_pages

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

    # -- admission / install / retire ---------------------------------------
    def reserve_for(self, slot: Slot, req: Request) -> bool:
        """Reserve every page ``req`` can need; False -> defer admission.
        A mapped prefix discounts its fully covered pages (a partially
        matched boundary page is written, so copied, and costs a page like
        any other).  Under pressure the prefix index evicts cold entries
        before admission is deferred."""
        if not self.paged:
            return True
        need = self.pages_needed(
            self.engine.cache_len(req.prompt_len, req.max_new_tokens)) \
            - slot.prefix_matched // self.page_size
        if not self.allocator.reserve(need):
            if self.prefix is None:
                return False
            evicted = self.prefix.evict_until(need)
            if evicted:
                self.engine.metrics.record_prefix_evictions(evicted)
            if not self.allocator.reserve(need):
                return False
        slot.reserved_left = need
        return True

    def install(self, slot: Slot, cache1, tok: int) -> None:
        """Write a freshly prefilled batch-1 lane cache into the slot's
        pages and lanes (or its monolithic lane) and flip it to ACTIVE with
        first token ``tok``; counted as prefill-path copied bytes."""
        end = self.engine.pos_offset(slot.req.prompt_len)
        if self.paged:
            # install rewrites the whole row; positions < prefix_matched
            # carry the bytes the shared pages already hold (the cache was
            # seeded from the prefix's fragments, and the codec encodes
            # each token alone), so only the partially matched boundary
            # page needs the copy-on-write barrier
            self._prepare_write(slot, slot.prefix_matched,
                                max(end - 1, slot.prefix_matched))
            self._ensure_pages(slot, max(end - 1, 0))
            row = torch.from_numpy(self.table[slot.index].astype(
                np.int64)).to(self.engine.device)
            if self.backend == "cuda_paged":
                self._kernel_install(cache1, row, slot.index)
            else:
                self._lane_scatter(cache1, row, slot.index)
        else:
            for pool, leaf in zip(tree_leaves(self.cache),
                                  tree_leaves(cache1)):
                pool[slot.index] = leaf
        slot.prefilling = False
        slot.pcache = None
        slot.tok = tok
        slot.pos = end
        self.engine.metrics.record_prefill_gather(self.install_bytes, 0)

    def retire(self, slot: Slot) -> None:
        """Release the slot's pages and outstanding reservation."""
        if self.paged:
            row = self.table[slot.index]
            self.allocator.release(int(p) for p in row if p != DUMMY_PAGE)
            row[:] = DUMMY_PAGE
            if slot.reserved_left:
                self.allocator.unreserve(slot.reserved_left)
        slot.reserved_left = 0
        slot.prefilling = False
        slot.pcache = None
        slot.prefix_matched = 0
        slot._prefix_nodes = None
        slot.req = None

    def codec_error_bound(self) -> float:
        """Worst-case elementwise KV reconstruction error of the resident
        pool (max per-token scale / 254); 0.0 when the codec is off."""
        if not self.codec:
            return 0.0
        scales = tree_leaves(self.kscales) \
            if self.backend == "cuda_paged" else self.page_scales
        top = max((float(s.max()) for s in scales if s is not None),
                  default=0.0)
        return float(kv_codec_mod.error_bound(top))

    def code_pools(self) -> list:
        """The int8 code pools under the codec (for the at-rest report)."""
        if not self.codec:
            return []
        if self.backend == "gathered":
            return list(self.pages)
        return [c for c, ax in zip(tree_leaves(self.kcache),
                                   self._paged_axis) if ax is not None]

    # -- stepping -----------------------------------------------------------
    def mixed_step(self, params, toks, poss, q_lens) -> torch.Tensor:
        """One ragged mixed step over the pools (``cuda_paged``) -> logits
        (S, Q, V).  Pages backing every written position must already be
        ensured."""
        logits, self.kcache, *scales = self.engine.mixed_step(
            params, self.kcache, self.table, toks, poss, q_lens,
            paged_flags=self.paged_flags, page_size=self.page_size,
            kv_scales=self.kscales)
        if scales:
            self.kscales = scales[0]
        return logits

    def decode_logits(self, params) -> torch.Tensor:
        """One decode step's logits (S, V) for every slot (a free slot's
        row is padding): each active slot's token is written at its
        position, but no slot advances.

        The backend seam: ``cuda_paged`` runs a Q=1 ``mixed_step`` on the
        kernel over the pools in place; ``gathered`` gathers the pages into
        lane views, runs the batched slot decode and scatters the pages
        back; monolithic lanes decode in place."""
        toks = np.zeros((self.n_slots, 1, 1), np.int32)
        poss = np.zeros(self.n_slots, np.int32)
        q_lens = np.zeros(self.n_slots, np.int32)
        for s in self.active():
            toks[s.index, 0, 0] = s.tok
            poss[s.index] = s.pos
            q_lens[s.index] = 1
            if self.paged:
                # a registered request's boundary page is shared with the
                # prefix index: the append lands on a private copy
                self._prepare_write(s, s.pos, s.pos)
                self._ensure_pages(s, s.pos)   # page for this step's write
        if self.backend == "cuda_paged":
            return self.mixed_step(params, toks[:, :, 0], poss,
                                   q_lens)[:, -1]
        if self.paged:
            tel = self.engine.telemetry
            # only active slots' rows: every lane decodes, and a
            # prefilling slot's lane (its token 0 written at position 0)
            # scattered back into the prefix pages it maps would overwrite
            # a shared page's first row.  The reference scatters it and
            # loses that row of the prefix (ROADMAP, reference caveats).
            rows = np.where(q_lens[:, None] > 0, self.table, DUMMY_PAGE)
            table = torch.from_numpy(rows.astype(np.int64)).to(
                self.engine.device)
            with tel.timed("kv_decode" if self.codec else "kv_gather"):
                views = self._gather(table)
            logits, views = self.engine.slot_decode(
                params, views, toks, poss, kv_quant=self.codec)
            with tel.timed("kv_encode" if self.codec else "kv_scatter"):
                self._scatter(views, table)
            return logits[:, 0, -1]
        logits, self.cache = self.engine.slot_decode(params, self.cache,
                                                     toks, poss)
        return logits[:, 0, -1]

    def decode(self, params) -> list[tuple[Slot, int, bool]]:
        """One decode step for every slot -> per active slot (slot, next
        token, logits finite); advances each active slot's (tok, pos)."""
        active = self.active()
        last = self.decode_logits(params)
        nxt = torch.argmax(last, dim=-1).cpu().numpy().astype(np.int32)
        finite = torch.isfinite(last).all(dim=-1).cpu().numpy()
        out = []
        for s in active:
            s.pos += 1
            s.tok = int(nxt[s.index])
            out.append((s, s.tok, bool(finite[s.index])))
        return out


class Scheduler:
    """Admit -> prefill (chunked or monolithic) -> continuous decode ->
    retire.

    ``mode="continuous"`` (default): admit-on-retire — a freed slot is
    refilled from the queue before the next step.  ``mode="wave"``:
    admission waits until every slot has drained, then takes up to
    ``batch_size`` queued requests sharing the head request's length
    bucket (``buckets``).

    ``attn_backend="cuda_paged"`` with ``prefill_chunk=N``: prompts go in
    N-token chunks through the one ragged mixed step of each iteration
    (``prefill_budget`` caps the chunk tokens an iteration, default one
    chunk, at least one always runs).  Otherwise prompts are prefilled
    alone at admission (``prefill_chunk=None``) or chunk by chunk on a
    standalone cache (the gathered backend's chunk loop, round-robin under
    the same budget), installed into the pool, and decoded one step for
    every slot at a time.  ``kv_page_size=N`` backs the KV with N-token
    pages (``kv_pages`` sets the pool size, default fully backing every
    slot); ``None`` keeps monolithic lanes (gathered backend only).

    ``prefix_share=True`` (needs ``kv_page_size`` and ``prefill_chunk``)
    maps cached prefix pages into each admitted request's table and skips
    their chunks.  ``speculate="ngram"``, ``"draft"`` or
    ``"draft:<arch>"`` verifies up to ``draft_k`` drafts a slot a step,
    token-identical to plain greedy decoding.

    What an arch cannot do is downgraded as in the reference, each with
    a ``RuntimeWarning`` (once per family and capability) and a ``note:``
    line: a multimodal prefix (vlm, audio) falls back to monolithic
    prefill, an arch without the verify step (audio) to plain decoding,
    an arch whose caches do not all page (the recurrent ssm and hybrid
    families, audio) from ``cuda_paged`` to ``gathered``, and one with
    lane leaves (rolling windows, recurrent state) or without chunked
    prefill to private pages.  Recurrent state and cross K/V stay per-slot
    lanes on every layout; speculation commits the accepted lengths, so a
    recurrent state advances by accepted tokens only."""

    def __init__(self, engine: ServeEngine, *, batch_size: int = 4,
                 buckets: tuple[int, ...] = DEFAULT_BUCKETS,
                 mode: str = "continuous", slot_len: int | None = None,
                 prefill_chunk: int | None = None,
                 prefill_budget: int | None = None,
                 kv_page_size: int | None = None,
                 kv_pages: int | None = None,
                 attn_backend: str = "cuda_paged",
                 kv_codec: str = "none",
                 prefix_share: bool = False,
                 kernel_tune: str | None = None,
                 speculate: str = "off", draft_k: int = 4,
                 log_every: int = 0, emit: Callable[[str], None] = print):
        if mode not in ("continuous", "wave"):
            raise ValueError(f"unknown scheduling mode {mode!r}")
        if draft_k < 1:
            raise ValueError(f"draft_k must be >= 1: {draft_k}")
        if prefill_chunk is not None and prefill_chunk <= 0:
            raise ValueError(f"prefill_chunk must be positive: "
                             f"{prefill_chunk}")
        if attn_backend not in ATTN_BACKENDS:
            raise ValueError(f"unknown attention backend {attn_backend!r}; "
                             f"choose from {ATTN_BACKENDS}")
        if attn_backend == "cuda_paged" and kv_page_size is None:
            raise ValueError("attn_backend='cuda_paged' needs paged KV "
                             "lanes; set kv_page_size")
        if kv_codec not in KV_CODECS:
            raise ValueError(f"unknown kv codec {kv_codec!r}; "
                             f"choose from {KV_CODECS}")
        if kv_codec == "cluster" and kv_page_size is None:
            raise ValueError("kv_codec='cluster' compresses the page "
                             "pools; set kv_page_size")
        if prefix_share and kv_page_size is None:
            raise ValueError("prefix_share maps shared KV pages; set "
                             "kv_page_size")
        if prefix_share and prefill_chunk is None:
            raise ValueError("prefix_share skips prefill chunk by chunk; "
                             "set prefill_chunk")
        if (kernel_tune or "off") != "off":
            raise NotImplementedError(
                f"kernel_tune={kernel_tune!r} is not ported to repro_torch "
                f"yet")
        self.engine = engine
        self.batch_size = batch_size
        self.buckets = tuple(sorted(buckets))
        self.mode = mode
        self.slot_len = slot_len
        self.prefill_chunk = prefill_chunk
        self.prefill_budget = prefill_budget or prefill_chunk
        self.kv_page_size = kv_page_size
        self.kv_pages = kv_pages
        self.attn_backend = attn_backend
        self.kv_codec = kv_codec
        self.prefix_share = prefix_share
        self.speculate = speculate or "off"
        self.draft_k = int(draft_k)
        self.drafter = None
        self.log_every = log_every
        self.emit = emit
        self._queue: list[Request] = []
        self._pool: SlotPool | None = None
        self._next_rid = 0
        family = engine.cfg.family
        if prefill_chunk is not None and \
                not engine.supports_chunked_prefill:
            self.prefill_chunk = None
            _warn_fallback(
                family, "chunked_prefill",
                f"{family} arch downgraded to monolithic "
                f"prefill: supports_chunked_prefill=False (a multimodal "
                f"prefix cannot resume a prompt mid-cache)")
            emit(f"note: {family} arch cannot resume a prompt "
                 "mid-cache; falling back to monolithic prefill")
        if self.speculate != "off" and (
                not supports_speculation(engine.cfg) or
                engine.api.verify_step is None):
            self.speculate = "off"
            _warn_fallback(
                family, "speculation",
                f"{family} arch downgraded to plain decoding: "
                f"supports_speculation=False (draft verification rides "
                f"the resume-from-cache machinery this arch lacks)")
            emit(f"note: {family} arch cannot verify draft tokens "
                 "mid-cache; speculative decoding off")
        if self.speculate != "off":
            self.drafter = make_drafter(self.speculate, engine)
        if attn_backend == "cuda_paged" and \
                not engine.supports_paged_attention:
            self.attn_backend = "gathered"
            _warn_fallback(
                family, "paged_attention",
                f"{family} arch downgraded to the gathered "
                f"attention backend: supports_paged_attention=False (no "
                f"attention-style cache to page)")
            emit(f"note: {family} arch has no paged decode "
                 "attention; falling back to the gathered backend")
        if self.prefix_share and (self.prefill_chunk is None or
                                  not supports_prefix_share(engine.cfg)):
            self.prefix_share = False
            _warn_fallback(
                family, "prefix_share",
                f"{family} arch downgraded to unshared KV pages: "
                f"supports_prefix_share=False (prefix sharing needs "
                f"chunked prefill and every cache leaf paged)")
            emit(f"note: {family} arch cannot map shared prefix pages; "
                 "serving each request's KV privately")

    # -- admission ---------------------------------------------------------
    def submit(self, prompt, max_new_tokens: int) -> Request:
        prompt = np.asarray(prompt, np.int32).ravel()
        if prompt.shape[0] > self.buckets[-1]:
            raise ValueError(
                f"prompt length {prompt.shape[0]} exceeds the largest "
                f"length bucket ({self.buckets[-1]}); truncate the prompt "
                f"or configure larger buckets")
        req = Request(self._next_rid, prompt, int(max_new_tokens),
                      t_submit=time.monotonic())
        self._next_rid += 1
        self._queue.append(req)
        return req

    def _bucket(self, n: int) -> int:
        for b in self.buckets:
            if n <= b:
                return b
        return self.buckets[-1]

    def _wave_group(self) -> list[Request]:
        """Up to batch_size queued requests sharing the head's bucket."""
        head_bucket = self._bucket(self._queue[0].prompt_len)
        group, rest = [], []
        for req in self._queue:
            if len(group) < self.batch_size and \
                    self._bucket(req.prompt_len) == head_bucket:
                group.append(req)
            else:
                rest.append(req)
        self._queue = rest
        return group

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
                                  kv_codec=self.kv_codec,
                                  prefix_share=self.prefix_share)
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
            if self._mixed_path(pool):
                with tel.timed("mixed_step"):
                    self._mixed_tick(pool, completed)
                continue
            if pool.prefilling():
                with tel.timed("prefill"):
                    self._prefill_tick(pool, completed)
            if not pool.active():
                continue
            if self.drafter is None:
                with tel.timed("decode"):
                    self._step(pool, completed)
            elif pool.backend == "cuda_paged":
                # the mixed step verifies drafts with no chunk in flight
                with tel.timed("mixed_step"):
                    self._mixed_tick(pool, completed)
            else:
                self._spec_step(pool, completed)
        if pool.codec:
            self.engine.metrics.record_kv_codec_error(
                pool.codec_error_bound())
        return completed

    def _mixed_path(self, pool: SlotPool) -> bool:
        """True when prefill chunks and decode tokens ride one ragged
        ``mixed_step`` an iteration (``cuda_paged`` with chunked
        prefill); the gathered backend keeps the standalone chunk loop."""
        return pool.backend == "cuda_paged" and \
            self.prefill_chunk is not None

    def _trace_admitted(self, req: Request, slot: Slot) -> None:
        """Close the request's queued span and mark its admission."""
        req.t_admit = time.monotonic()
        tr = self.engine.telemetry.tracer
        if tr.enabled:
            tr.name_track(PID_REQUEST, req.rid, f"request {req.rid}")
            tr.complete(PID_REQUEST, req.rid, "queued", req.t_submit,
                        req.t_admit, prompt_len=req.prompt_len)
            tr.instant(PID_REQUEST, req.rid, "admitted", req.t_admit,
                       slot=slot.index, backend=self.attn_backend)

    def _record_first_token(self, req: Request, tok: int) -> None:
        req.generated.append(tok)
        req.t_first = time.monotonic()
        self.engine.metrics.record_ttft(req.t_first - req.t_submit)
        tr = self.engine.telemetry.tracer
        if tr.enabled:
            tr.instant(PID_REQUEST, req.rid, "first_token", req.t_first,
                       token=tok)

    def _start_or_admit(self, pool: SlotPool, req: Request, params,
                        completed: list[Request]) -> None:
        """Place ``req`` in a free slot: chunked -> PREFILLING (its chunks
        write into the slot's pages on the mixed path, else into a fresh
        standalone cache), monolithic -> prefilled and installed now."""
        slot = pool.free()[0]
        need = self.engine.cache_len(req.prompt_len, req.max_new_tokens)
        if need > pool.slot_len:
            raise ValueError(f"request {req.rid} needs {need} cache "
                             f"positions > slot_len {pool.slot_len}")
        slot.req = req
        if self.prefill_chunk is not None:
            slot.prefilling = True
            # a mapped prefix starts the cursor past it: those prompt
            # tokens cost no prefill work
            slot.prefill_cursor = slot.prefix_matched
            slot.pcache = None if self._mixed_path(pool) else \
                self.engine.fresh_slot_cache(pool.slot_len)
            if slot.prefix_matched:
                pool.seed_pcache(slot)
                self.engine.metrics.record_prefix_hit(
                    slot.prefix_matched,
                    slot.prefix_matched // self.prefill_chunk)
            self._trace_admitted(req, slot)
            if slot.prefix_matched:
                tr = self.engine.telemetry.tracer
                if tr.enabled:
                    tr.instant(PID_REQUEST, req.rid, "prefix_hit",
                               req.t_admit, tokens=slot.prefix_matched)
            return
        t0 = time.monotonic()
        self._trace_admitted(req, slot)
        tok, cache1 = self.engine.prefill_request(params, req.prompt,
                                                  pool.slot_len)
        pool.install(slot, cache1, tok)
        t1 = time.monotonic()
        tr = self.engine.telemetry.tracer
        if tr.enabled:
            tr.complete(PID_REQUEST, req.rid, "prefill", t0, t1,
                        slot=slot.index, tokens=req.prompt_len)
        self._record_first_token(req, tok)
        self.engine.metrics.record_admit(1, t1 - t0, tokens=1)
        self._maybe_finish(pool, slot, completed)

    def _maybe_finish(self, pool: SlotPool, slot: Slot,
                      completed: list[Request]) -> None:
        req = slot.req
        if len(req.generated) >= req.max_new_tokens:
            req.done = True
            req.t_done = time.monotonic()
            tr = self.engine.telemetry.tracer
            if tr.enabled:
                pages = int((pool.table[slot.index] != DUMMY_PAGE).sum()) \
                    if pool.paged else 0
                if req.t_first is not None:
                    tr.complete(PID_REQUEST, req.rid, "decode",
                                req.t_first, req.t_done, slot=slot.index,
                                tokens=len(req.generated),
                                pages_held=pages)
                tr.complete(PID_REQUEST, req.rid, "request", req.t_submit,
                            req.t_done, prompt_len=req.prompt_len,
                            tokens=len(req.generated),
                            backend=self.attn_backend)
                tr.instant(PID_REQUEST, req.rid, "retired", req.t_done,
                           slot=slot.index)
            pool.retire(slot)
            completed.append(req)
            self.engine.metrics.record_completed(1)
            self.engine.metrics.record_request_done(req)

    def _admit(self, pool: SlotPool, completed: list[Request]) -> None:
        if self.mode == "wave":
            if pool.busy() or not self._queue:
                return                    # wave mode: drain before admitting
            group = self._wave_group()[:pool.n_slots]
            self.engine.metrics.record_wave()
        else:
            group = None                  # continuous: straight FIFO
        while self._queue or group:
            if group is not None:
                if not group:
                    return
                req = group[0]
            else:
                if not pool.free():
                    return
                req = self._queue[0]
            slot = pool.free()[0] if pool.free() else None
            ok = False
            if slot is not None:
                matched = pool.map_prefix(slot, req,
                                          self.prefill_chunk or 1)
                ok = pool.reserve_for(slot, req)
                if not ok and matched:
                    # the hit's remaining pages cannot be reserved: roll
                    # it back, the request may still fit unshared
                    pool.unmap_prefix(slot)
                    ok = pool.reserve_for(slot, req)
            if not ok:
                if slot is not None and not pool.busy():
                    # idle pool that still can't reserve: no retire will
                    # ever free pages, so deferring would spin forever
                    need = pool.pages_needed(self.engine.cache_len(
                        req.prompt_len, req.max_new_tokens))
                    raise ValueError(
                        f"request {req.rid} needs {need} KV pages but "
                        f"the pool only has {pool.allocator.total}; "
                        f"raise kv_pages")
                if group is not None:
                    self._queue = group + self._queue
                return      # admit when a retire returns pages
            (group if group is not None else self._queue).pop(0)
            self._start_or_admit(pool, req, self.engine.step_params(),
                                 completed)

    def _prefill_tick(self, pool: SlotPool,
                      completed: list[Request]) -> None:
        """Advance chunked prefills by up to ``prefill_budget`` prompt
        tokens (whole chunks; at least one a tick), each prefilling slot on
        its standalone batch-1 cache — the gathered backend's chunk loop.
        Chunks round-robin across prefilling slots, so a short prompt
        admitted beside a long one reaches its first token after its own
        few chunks."""
        if self.prefill_chunk is None:
            return
        m = self.engine.metrics
        spent = 0
        pending = pool.prefilling()
        while pending and spent < self.prefill_budget:
            for slot in pending:
                if spent >= self.prefill_budget:
                    break
                req = slot.req
                c = min(self.prefill_chunk,
                        req.prompt_len - slot.prefill_cursor)
                chunk = req.prompt[slot.prefill_cursor:
                                   slot.prefill_cursor + c]
                t0 = time.monotonic()
                params = self.engine.step_params()
                # under the codec the chunk's K/V is rounded through it, so
                # install's encode lands on the codec's own fixed point
                logits, slot.pcache = self.engine.prefill_chunk_step(
                    params, slot.pcache, chunk, slot.prefill_cursor,
                    kv_quant=pool.codec)
                dt = time.monotonic() - t0
                m.record_prefill_chunk(c, dt, stalled=bool(pool.active()))
                tr = self.engine.telemetry.tracer
                if tr.enabled:
                    tr.complete(PID_REQUEST, req.rid, "prefill_chunk",
                                t0, t0 + dt, slot=slot.index, tokens=c,
                                cursor=slot.prefill_cursor)
                slot.prefill_cursor += c
                spent += c
                if slot.prefill_cursor >= req.prompt_len:
                    last = logits[0, -1]
                    if not bool(torch.isfinite(last).all()):
                        raise RuntimeError(
                            "non-finite prefill logits (compressed "
                            "reconstruction or model numerics are broken)")
                    nxt = int(torch.argmax(last))
                    # install leaves the standalone cache as it is; the
                    # prefix index keeps its raw-fp pages as fragments
                    cache1 = slot.pcache
                    pool.install(slot, cache1, nxt)
                    pool.register_prefix(slot, cache1)
                    self._record_first_token(req, nxt)
                    m.record_admit(1, 0.0, tokens=1)
                    self._maybe_finish(pool, slot, completed)
            pending = [s for s in pending if s.prefilling]

    def _record_step(self, pool: SlotPool) -> None:
        """Pool gauges and copy counters after a decode step."""
        m = self.engine.metrics
        m.record_pages(pool.pages_in_use(),
                       pool.allocator.total if pool.paged else 0)
        if pool.prefix is not None:
            m.record_shared_pages(pool.allocator.shared_pages())
        m.record_kv_gather(pool.gather_bytes_per_step,
                           pool.gather_bytes_avoided_per_step)
        if pool.codec:
            m.record_kv_codec(pool.pages_in_use() * pool.page_bytes_fp,
                              pool.pages_in_use() *
                              pool.page_bytes_resident)
        if self.log_every and m.decode_steps % self.log_every == 0:
            self.emit(self.engine.stats_line())

    def _step(self, pool: SlotPool, completed: list[Request]) -> None:
        """One decode step for every slot (``SlotPool.decode``)."""
        t0 = time.monotonic()
        results = pool.decode(self.engine.step_params())
        for slot, tok, finite in results:
            if not finite:
                raise RuntimeError(
                    f"non-finite logits in decode step for request "
                    f"{slot.req.rid} (compressed reconstruction or model "
                    f"numerics are broken)")
            slot.req.generated.append(tok)
            self._maybe_finish(pool, slot, completed)
        self.engine.metrics.record_decode_step(
            len(results), time.monotonic() - t0, n_slots=pool.n_slots)
        self._record_step(pool)

    def _mixed_tick(self, pool: SlotPool,
                    completed: list[Request]) -> None:
        """One iteration: every active slot contributes its decode token
        (and its drafts) and every prefilling slot up to one prompt chunk
        (the chunks capped by ``prefill_budget``, at least one), all
        through one ragged ``mixed_step`` over the page pools.  Blocks are
        padded to one width — ``prefill_chunk`` while chunks are in flight
        (drafts clamped into it), ``1 + draft_k`` on a decode tick with
        drafts, 1 for plain decode — so the step sees few shapes.

        Every position a slot writes goes through the copy-on-write
        barrier first.  A rejected draft's K/V stays in the pages past the
        slot's new position, where the next write lands before any query
        can attend it; rolling lanes have no such slack, so their rows
        under the drafts are snapshotted before the step and the rejected
        ones restored after it."""
        m = self.engine.metrics
        tel = self.engine.telemetry
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
        drafts: dict[int, np.ndarray] = {}
        if self.drafter is not None and active:
            # the lane snapshot's depth caps how deep a draft may write
            cap = None if pool.lane_min_rows is None \
                else pool.lane_min_rows - 1
            with tel.timed("spec_draft"):
                drafts = self._propose_drafts(pool, active, cap=cap)
        width = min(self.prefill_chunk, pool.slot_len) if chunks else 1
        if chunks:
            drafts = {i: d[:width - 1] for i, d in drafts.items()}
        drafts = {i: d for i, d in drafts.items() if len(d)}
        if drafts and not chunks:
            width = 1 + self.draft_k
        toks = np.zeros((pool.n_slots, width), np.int32)
        poss = np.zeros(pool.n_slots, np.int32)
        q_lens = np.zeros(pool.n_slots, np.int32)
        for slot in active:
            d = drafts.get(slot.index, ())
            toks[slot.index, 0] = slot.tok
            toks[slot.index, 1:1 + len(d)] = d
            poss[slot.index] = slot.pos
            q_lens[slot.index] = 1 + len(d)
            pool._prepare_write(slot, slot.pos, slot.pos + len(d))
            pool._ensure_pages(slot, slot.pos + len(d))
        for slot, c in chunks:
            cur = slot.prefill_cursor
            toks[slot.index, :c] = slot.req.prompt[cur:cur + c]
            poss[slot.index] = cur
            q_lens[slot.index] = c
            # chunk K/V lands in the pool in place: shared pages under the
            # write range are copied first
            pool._prepare_write(slot, cur, cur + c - 1)
            pool._ensure_pages(slot, cur + c - 1)
        t0 = time.monotonic()
        params = self.engine.step_params()
        snaps = kk = None
        if drafts and pool.lane_min_rows is not None:
            kk = max(len(d) for d in drafts.values())
            snaps = pool.spec_snapshot(poss, kk)
        logits = pool.mixed_step(params, toks, poss, q_lens)
        # one host transfer a step: the argmax of each row a slot needs
        # (a decode slot's rows 0..drafts, a chunk's last row)
        n_rows = 1 + max((len(d) for d in drafts.values()), default=0)
        last = np.maximum(q_lens - 1, 0)[:, None]
        idx = np.minimum(np.arange(n_rows)[None], last)
        for slot, _ in chunks:
            idx[slot.index] = last[slot.index]
        sel = logits[torch.arange(pool.n_slots, device=logits.device)[:, None],
                     torch.from_numpy(idx).to(logits.device)]
        g = torch.argmax(sel, dim=-1).cpu().numpy()             # (S, R)
        ok_rows = torch.isfinite(sel).all(dim=-1).cpu().numpy()
        dt = time.monotonic() - t0
        # wall time attributed to decode vs prefill by token share
        n_chunk_toks = sum(c for _, c in chunks)
        n_dec_toks = int(sum(q_lens[s.index] for s in active))
        total = n_dec_toks + n_chunk_toks
        dt_decode = dt * n_dec_toks / total if total else 0.0
        emitted = 0
        acc: dict[int, int] = {}
        for slot in active:
            d = drafts.get(slot.index, ())
            a = 0
            while a < len(d) and int(d[a]) == int(g[slot.index, a]):
                a += 1
            acc[slot.index] = a
            if not ok_rows[slot.index, :a + 1].all():
                raise RuntimeError(
                    f"non-finite logits in mixed step for request "
                    f"{slot.req.rid} (compressed reconstruction or model "
                    f"numerics are broken)")
            slot.req.generated.extend(int(t) for t in g[slot.index, :a + 1])
            emitted += a + 1
            slot.pos += a + 1
            slot.tok = int(g[slot.index, a])
            m.record_spec(len(d), a)
            self._maybe_finish(pool, slot, completed)
        if snaps is not None:
            with tel.timed("spec_rollback"):
                keep = np.zeros((pool.n_slots, kk), bool)
                for i, d in drafts.items():
                    keep[i, acc[i]:len(d)] = True
                pool.spec_restore(snaps, poss, keep)
        tr = tel.tracer
        for slot, c in chunks:
            m.record_prefill_chunk(c, (dt - dt_decode) / len(chunks),
                                   stalled=bool(active))
            if tr.enabled:
                # chunks share one ragged step; each request's span covers
                # the step's prefill share
                tr.complete(PID_REQUEST, slot.req.rid, "prefill_chunk",
                            t0, t0 + (dt - dt_decode), slot=slot.index,
                            tokens=c, cursor=slot.prefill_cursor)
            slot.prefill_cursor += c
            if slot.prefill_cursor >= slot.req.prompt_len:
                if not ok_rows[slot.index, 0]:
                    raise RuntimeError(
                        "non-finite prefill logits (compressed "
                        "reconstruction or model numerics are broken)")
                req = slot.req
                slot.prefilling = False
                slot.tok = int(g[slot.index, 0])
                slot.pos = self.engine.pos_offset(req.prompt_len)
                # the index shares the kernel-written pages in place; the
                # codec encodes each (page, token) alone, so a later hit
                # reads what the sharing-off run computes
                pool.register_prefix(slot)
                self._record_first_token(req, slot.tok)
                m.record_admit(1, 0.0, tokens=1)
                # the install copy a standalone-cache prefill makes at its
                # end never happens here
                m.record_prefill_gather(0, pool.install_bytes)
                self._maybe_finish(pool, slot, completed)
        if active:
            m.record_decode_step(emitted, dt_decode, n_slots=pool.n_slots)
            self._record_step(pool)

    def _propose_drafts(self, pool: SlotPool, active: list[Slot],
                        cap: int | None = None) -> dict[int, np.ndarray]:
        """Up to ``draft_k`` drafts an active slot -> {slot.index: draft
        tokens}, each kept inside the request's token budget (the verified
        bonus token always fits) and the slot's cache; ``cap`` is a
        backend bound (the rolling-lane snapshot depth)."""
        hists = [np.concatenate([np.asarray(s.req.prompt, np.int64),
                                 np.asarray(s.req.generated, np.int64)])
                 for s in active]
        limits = []
        for s in active:
            lim = s.req.max_new_tokens - len(s.req.generated) - 1
            lim = min(lim, pool.slot_len - 1 - s.pos)
            if cap is not None:
                lim = min(lim, cap)
            limits.append(max(lim, 0))
        drafts = self.drafter.propose(hists, self.draft_k, limits=limits)
        return {s.index: np.asarray(d, np.int64)
                for s, d in zip(active, drafts)}

    def _spec_step(self, pool: SlotPool, completed: list[Request]) -> None:
        """One speculative round on the gathered and monolithic layouts:
        drafts -> one ragged scoring pass over every slot's lanes on a copy
        (phase 1) -> greedy accept on the host -> one pass at the accepted
        lengths on the resident lanes (phase 2).  Rejected drafts never
        reach the resident cache; greedy acceptance emits the argmax chain
        plain decoding would.  Two passes rather than one: MoE capacity is
        per row of the block, so a pass over ``1 + a`` tokens can drop
        other tokens than the scoring pass over all of them."""
        m = self.engine.metrics
        tel = self.engine.telemetry
        active = pool.active()
        t0 = time.monotonic()
        with tel.timed("spec_draft"):
            drafts = self._propose_drafts(pool, active)
        if not any(len(d) for d in drafts.values()):
            # nothing proposed: a plain decode step is cheaper than a
            # two-pass round at Q = 1
            with tel.timed("decode"):
                self._step(pool, completed)
            return
        qn = 1 + self.draft_k
        toks = np.zeros((pool.n_slots, 1, qn), np.int32)
        poss = np.zeros(pool.n_slots, np.int32)
        q_lens = np.zeros(pool.n_slots, np.int32)
        for s in active:
            d = drafts[s.index]
            toks[s.index, 0, 0] = s.tok
            toks[s.index, 0, 1:1 + len(d)] = d
            poss[s.index] = s.pos
            q_lens[s.index] = 1 + len(d)
            if pool.paged:
                # the real token and every draft write [pos, pos + d]
                pool._prepare_write(s, s.pos, s.pos + len(d))
                pool._ensure_pages(s, s.pos + len(d))
        params = self.engine.step_params()
        with tel.timed("spec_verify"):
            logits, ctx = pool.spec_score(params, toks, poss, q_lens)
            g = torch.argmax(logits[:, 0], dim=-1).cpu().numpy()    # (S, Q)
            finite = torch.isfinite(logits[:, 0]).all(dim=-1).cpu().numpy()
        accepted: dict[int, int] = {}
        commit_lens = np.zeros(pool.n_slots, np.int32)
        for s in active:
            d = drafts[s.index]
            a = 0
            while a < len(d) and int(d[a]) == int(g[s.index, a]):
                a += 1
            accepted[s.index] = a
            commit_lens[s.index] = 1 + a
        with tel.timed("spec_rollback"):
            pool.spec_commit(params, toks, poss, commit_lens, ctx)
        dt = time.monotonic() - t0
        emitted = 0
        for s in active:
            a = accepted[s.index]
            if not finite[s.index, :a + 1].all():
                raise RuntimeError(
                    f"non-finite logits in speculative step for request "
                    f"{s.req.rid} (compressed reconstruction or model "
                    f"numerics are broken)")
            s.req.generated.extend(int(t) for t in g[s.index, :a + 1])
            emitted += a + 1
            s.pos += a + 1
            s.tok = int(g[s.index, a])
            m.record_spec(len(drafts[s.index]), a)
            self._maybe_finish(pool, s, completed)
        m.record_decode_step(emitted, dt, n_slots=pool.n_slots)
        self._record_step(pool)

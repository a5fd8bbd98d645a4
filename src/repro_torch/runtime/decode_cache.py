"""Capacity-bounded cache of decoded weight tiles (port of
``repro.runtime.decode_cache``; pure Python, the values are device
tensors) — the software analogue of the paper's §IV hardware caching unit.

The hardware structure caches *decoded Huffman sequences* next to the
decoder so the hot, frequency-skewed majority of codes is never re-decoded;
here the unit of reuse is one decode tile (the (W, S) substream-parallel
block the decode kernel consumes), keyed ``(model, layer, tile)``.  During
batched decoding every step touches every tile of every compressed layer,
so a capacity that covers the decoded working set turns all steps after the
first into pure cache hits — the measured hit rate is the direct software
counterpart of the paper's decode-cell utilisation.

Eviction is pluggable behind :class:`EvictionPolicy`:

  * ``lru``  — least-recently-used (recency only; the classic choice, but a
    cyclic scan one tile larger than capacity degrades it to 0% hits);
  * ``lfu``  — least-frequently-used (observed access counts, insertion-age
    tie-break);
  * ``freq`` — :class:`FrequencyWeightedPolicy`, the paper-motivated policy:
    victims are picked by observed accesses *plus* a static prior seeded
    from ``core.frequency`` occurrence counts (§III-A skew, Fig. 3).  Tiles
    dominated by hot sequences are pinned before they have any access
    history, so a one-off cold scan cannot flush the hot set the way it
    flushes LRU.

Accounting:
  * miss  -> ``bytes_streamed``  += compressed tile bytes (HBM words fetched
             and pushed through the decoder);
  * hit   -> ``bytes_avoided``   += the same compressed bytes (traffic +
             decode work the cache absorbed);
  * evictions are counted, and the resident decoded bytes are bounded by
    ``capacity_bytes`` under every policy.  Re-inserting an existing key
    replaces it exactly (old ``nbytes`` released before the new are
    charged), so ``resident_bytes`` always equals the sum over live
    entries — tests/test_runtime.py locks this down.

Knobs, in one place:

  =====================  ===================================================
  knob                   effect
  =====================  ===================================================
  ``capacity_bytes``     ``None`` = unbounded (everything cached after its
                         first decode); ``0`` = caching disabled, the
                         paper's no-cache baseline; otherwise a hard bound
                         on resident decoded bytes.  Values larger than
                         capacity are never cached at all.
  ``policy``             ``"lru"`` | ``"lfu"`` | ``"freq"`` or any
                         ``EvictionPolicy`` instance; ``None`` = LRU.
  ``FrequencyWeighted-``
  ``Policy(prior_-``     weight of the static §III-A occurrence prior
  ``weight=0.8, ...)``   relative to one fresh access.  < 1 keeps live
                         history dominant (a just-touched tile always
                         outranks an idle pinned one — pinning can never
                         starve the working set); >= 1 lets the prior
                         dominate, appropriate when access recency carries
                         no signal (pure cyclic scans; the example drives
                         this with ``prior_weight=4``).
  ``... half_life=64``   access-count decay, in policy events (inserts +
                         hits).  Small = closer to LRU (history fades
                         fast); large = closer to pure frequency ranking.
                         ``1e6``-scale values effectively freeze counts so
                         the static prior decides victims.
  =====================  ===================================================
"""

from __future__ import annotations

import collections
import dataclasses
from typing import Any, Callable, Hashable

TileKey = Hashable   # canonically (model_id, layer_name, tile_index)


@dataclasses.dataclass
class _Entry:
    value: Any
    nbytes: int
    streamed_bytes: int     # compressed bytes needed to rebuild this tile


# ---------------------------------------------------------------------------
# eviction policies
# ---------------------------------------------------------------------------

class EvictionPolicy:
    """Victim-selection strategy for :class:`DecodeTileCache`.

    The cache owns the entries and the byte accounting; the policy only
    tracks the metadata it needs to answer :meth:`victim`.  The cache calls
    ``on_insert`` / ``on_hit`` / ``on_remove`` for every entry it holds, so
    a policy's key set always mirrors the cache's.  ``seed`` feeds static
    frequency priors (``core.frequency`` occurrence counts); policies that
    do not use priors ignore it.
    """

    name = "base"

    def on_insert(self, key: TileKey, nbytes: int) -> None:
        raise NotImplementedError

    def on_hit(self, key: TileKey) -> None:
        raise NotImplementedError

    def on_remove(self, key: TileKey) -> None:
        raise NotImplementedError

    def victim(self) -> TileKey:
        """Key to evict next (only called while entries exist)."""
        raise NotImplementedError

    def seed(self, key: TileKey, weight: float) -> None:
        """Static frequency prior for ``key`` (may precede insertion)."""

    def order(self) -> list:
        """Keys in eviction order (victim first) — introspection only."""
        raise NotImplementedError

    def clear(self) -> None:
        raise NotImplementedError


class LRUPolicy(EvictionPolicy):
    """Evict the least-recently-used entry."""

    name = "lru"

    def __init__(self):
        self._order: collections.OrderedDict[TileKey, None] = \
            collections.OrderedDict()

    def on_insert(self, key, nbytes):
        self._order[key] = None
        self._order.move_to_end(key)

    def on_hit(self, key):
        self._order.move_to_end(key)

    def on_remove(self, key):
        self._order.pop(key, None)

    def victim(self):
        return next(iter(self._order))

    def order(self):
        return list(self._order)

    def clear(self):
        self._order.clear()


class LFUPolicy(EvictionPolicy):
    """Evict the least-frequently-used entry (oldest breaks ties).

    Counts persist across evictions of the same key (classic LFU with
    perfect history): a tile that was hot, evicted, and re-decoded resumes
    its old count instead of restarting at the bottom of the pile.
    """

    name = "lfu"

    def __init__(self):
        self._count: collections.Counter = collections.Counter()
        self._tick = 0
        self._age: dict[TileKey, int] = {}

    def _score(self, key):
        return (self._count[key], self._age[key])

    def on_insert(self, key, nbytes):
        self._count[key] += 1
        self._tick += 1
        self._age[key] = self._tick

    def on_hit(self, key):
        self._count[key] += 1

    def on_remove(self, key):
        self._age.pop(key, None)

    def victim(self):
        return min(self._age, key=self._score)

    def order(self):
        return sorted(self._age, key=self._score)

    def clear(self):
        self._count.clear()
        self._age.clear()
        self._tick = 0


class FrequencyWeightedPolicy(EvictionPolicy):
    """Evict the entry with the lowest prior-seeded, aged frequency score.

    Score = exponentially aged access count + normalised static prior.
    The prior comes from ``core.frequency`` occurrence counts (how much of
    the paper's skewed sequence mass a tile carries) via :meth:`seed`; it
    ranks tiles before any access history exists and keeps hot tiles
    resident through access patterns that defeat recency (one-off scans,
    bursty cold tenants).  Observed counts decay with a half-life of
    ``half_life`` policy events, so a tenant that was hot long ago cannot
    starve the tiles a current burst is actively reusing — the aged count
    degrades gracefully to LRU-like behaviour on un-seeded keys while the
    prior keeps the statically hot set pinned.  ``prior_weight`` < 1 keeps
    the prior subordinate to live history: a tile with a fresh access
    always outranks an idle pinned one, so pinning can never starve the
    working set a current request is actively scanning.
    """

    name = "freq"

    def __init__(self, prior_weight: float = 0.8,
                 half_life: float = 64.0):
        self.prior_weight = prior_weight
        self.half_life = half_life
        self._prior: dict[TileKey, float] = {}
        self._prior_max = 0.0
        self._count: dict[TileKey, float] = {}
        self._touch: dict[TileKey, int] = {}   # tick of the last access
        self._tick = 0
        self._age: dict[TileKey, int] = {}     # resident keys -> insert tick

    def seed(self, key, weight):
        self._prior[key] = float(weight)
        self._prior_max = max(self._prior_max, float(weight))

    def _decayed(self, key) -> float:
        count = self._count.get(key, 0.0)
        if not count:
            return 0.0
        return count * 0.5 ** ((self._tick - self._touch[key])
                               / self.half_life)

    def _bump(self, key):
        self._tick += 1
        self._count[key] = self._decayed(key) + 1.0
        self._touch[key] = self._tick

    def _score(self, key):
        prior = self._prior.get(key, 0.0)
        norm = prior / self._prior_max if self._prior_max else 0.0
        return (self._decayed(key) + self.prior_weight * norm,
                self._age[key])

    def on_insert(self, key, nbytes):
        self._bump(key)
        self._age[key] = self._tick

    def on_hit(self, key):
        self._bump(key)

    def on_remove(self, key):
        self._age.pop(key, None)

    def victim(self):
        return min(self._age, key=self._score)

    def order(self):
        return sorted(self._age, key=self._score)

    def clear(self):
        self._count.clear()
        self._touch.clear()
        self._age.clear()
        self._tick = 0


POLICIES: dict[str, Callable[[], EvictionPolicy]] = {
    "lru": LRUPolicy,
    "lfu": LFUPolicy,
    "freq": FrequencyWeightedPolicy,
}


def make_policy(policy: str | EvictionPolicy | None) -> EvictionPolicy:
    """Policy instance from a name (``lru`` | ``lfu`` | ``freq``), an
    instance (passed through), or None (default LRU)."""
    if policy is None:
        return LRUPolicy()
    if isinstance(policy, EvictionPolicy):
        return policy
    try:
        return POLICIES[policy]()
    except KeyError:
        raise ValueError(
            f"unknown eviction policy {policy!r}; "
            f"expected one of {sorted(POLICIES)}") from None


# ---------------------------------------------------------------------------
# the cache
# ---------------------------------------------------------------------------

class DecodeTileCache:
    """Policy-driven cache of decoded tiles with hit/miss/bytes accounting.

    ``capacity_bytes=None`` means unbounded (serve everything from cache
    after first decode); ``0`` disables caching entirely (every access is a
    miss — the paper's no-cache baseline).
    """

    def __init__(self, capacity_bytes: int | None = None,
                 policy: str | EvictionPolicy | None = None):
        self.capacity_bytes = capacity_bytes
        self.policy = make_policy(policy)
        self._entries: dict[TileKey, _Entry] = {}
        self.hits = 0
        self.misses = 0
        self.evictions = 0
        self.bytes_streamed = 0
        self.bytes_avoided = 0
        self.resident_bytes = 0

    # -- core --------------------------------------------------------------
    def get(self, key: TileKey):
        """Decoded tile or None; counts the access and notifies the policy."""
        entry = self._entries.get(key)
        if entry is None:
            self.misses += 1
            return None
        self.hits += 1
        self.bytes_avoided += entry.streamed_bytes
        self.policy.on_hit(key)
        return entry.value

    def put(self, key: TileKey, value, *, nbytes: int | None = None,
            streamed_bytes: int = 0) -> None:
        """Insert a freshly decoded tile (the decode's stream traffic is
        charged here) and evict policy victims beyond capacity.

        Re-inserting an existing key *replaces* it: the old entry's bytes
        are released before the new are charged, so updates never inflate
        ``resident_bytes`` (regression-tested)."""
        nbytes = int(getattr(value, "nbytes", 0) if nbytes is None else nbytes)
        self.bytes_streamed += streamed_bytes
        old = self._entries.pop(key, None)
        if old is not None:
            self.resident_bytes -= old.nbytes
            self.policy.on_remove(key)
        if self.capacity_bytes is not None and nbytes > self.capacity_bytes:
            return                      # too large to ever cache
        self._entries[key] = _Entry(value, nbytes, streamed_bytes)
        self.resident_bytes += nbytes
        self.policy.on_insert(key, nbytes)
        if self.capacity_bytes is not None:
            while self.resident_bytes > self.capacity_bytes and self._entries:
                vk = self.policy.victim()
                self.resident_bytes -= self._entries.pop(vk).nbytes
                self.policy.on_remove(vk)
                self.evictions += 1

    def fill(self, key: TileKey, value) -> None:
        """Set the value of a resident entry without counting an access.
        A batched decode charges each missing tile with :meth:`put` in
        access order (so counters and evictions match per-tile decoding)
        and fills the values once the one launch for all of them is done;
        an entry evicted in between is simply not filled."""
        entry = self._entries.get(key)
        if entry is not None:
            entry.value = value

    def seed_frequency(self, key: TileKey, weight: float) -> None:
        """Record a static frequency prior (``core.frequency`` occurrence
        mass) for ``key``; no-op under policies that ignore priors."""
        self.policy.seed(key, weight)

    # -- introspection -----------------------------------------------------
    def __len__(self) -> int:
        return len(self._entries)

    def __contains__(self, key: TileKey) -> bool:
        return key in self._entries

    def keys(self):
        """Keys in eviction order (next victim first)."""
        return self.policy.order()

    @property
    def accesses(self) -> int:
        return self.hits + self.misses

    def hit_rate(self) -> float:
        total = self.hits + self.misses
        return self.hits / total if total else 0.0

    def stats(self) -> dict:
        return {
            "policy": self.policy.name,
            "hits": self.hits,
            "misses": self.misses,
            "evictions": self.evictions,
            "hit_rate": self.hit_rate(),
            "bytes_streamed": self.bytes_streamed,
            "bytes_avoided": self.bytes_avoided,
            "resident_bytes": self.resident_bytes,
            "entries": len(self._entries),
        }

    def prom_metrics(self) -> list:
        """(name, kind, getter, help) rows for a pull-based metrics
        registry (``ServeMetrics.registry`` prefixes them ``cache_``)."""
        return [
            ("hits_total", "counter", lambda: self.hits,
             "decode-tile cache hits"),
            ("misses_total", "counter", lambda: self.misses,
             "decode-tile cache misses"),
            ("evictions_total", "counter", lambda: self.evictions,
             "decode-tile cache evictions"),
            ("bytes_streamed_total", "counter", lambda: self.bytes_streamed,
             "compressed bytes fetched and decoded on misses"),
            ("bytes_avoided_total", "counter", lambda: self.bytes_avoided,
             "compressed bytes the cache absorbed on hits"),
            ("resident_bytes", "gauge", lambda: self.resident_bytes,
             "decoded bytes currently resident"),
            ("entries", "gauge", lambda: len(self._entries),
             "decoded tiles currently resident"),
        ]

    def reset_counters(self) -> None:
        self.hits = self.misses = self.evictions = 0
        self.bytes_streamed = self.bytes_avoided = 0

    def clear(self) -> None:
        self._entries.clear()
        self.policy.clear()
        self.resident_bytes = 0

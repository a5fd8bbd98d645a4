"""Prefix sharing: a page-granular token trie over the paged KV pool (port
of ``repro.runtime.prefix_index``; pure Python, the port's own copy).

:class:`PrefixIndex` caches the KV pages of completed prefills keyed by
the exact token span each page covers, so a later request whose prompt
extends a cached prefix maps those physical pages into its page table and
skips computing the prefix.

The trie's edges are token tuples.  A **full node** covers exactly
``page_size`` tokens and can branch; a **partial node** covers the
trailing ``prompt_len % page_size`` tokens of a registered prompt and is
always a leaf.  Each node owns one allocator reference on its physical
page (``PageAllocator.share`` at registration, dropped at eviction); a
slot that maps a cached page takes its own reference, released by the
normal retire path.  Copy-on-write in ``SlotPool._prepare_write`` keys
off ``refcount >= 2``, so a page the index holds is never mutated by a
slot, and a page whose node was evicted while a slot still maps it
becomes that slot's private page.

Registration dedupes on identical token spans (the existing page is kept,
no second reference is taken).  Lookup walks full-page children exactly,
then takes the longest common prefix into one more child, caps the match
below the prompt length (the last prompt token is always recomputed for
the first token's logits) and floors it to a multiple of the prefill
chunk size, so the suffix chunks start on the boundaries the sharing-off
run uses.

Eviction uses the decode cache's :class:`FrequencyWeightedPolicy`: every
lookup hit seeds a node's hit count as its prior and bumps its aged
frequency.  Only childless nodes are evictable; dropping a leaf can
expose its parent, so eviction loops until enough capacity is free.

Under the ``gathered`` backend a node also keeps ``frag``: per paged leaf,
the raw-fp cache slice backing its page, taken from the registering
slot's standalone prefill cache before install encoded it into the pool
(clones on the pool's device).  They seed a later hit's standalone cache
with exactly the values the sharing-off chunk loop computes there.  The
``cuda_paged`` mixed step reads the pool pages in place and needs none.
"""

from __future__ import annotations

import dataclasses

from repro_torch.runtime.decode_cache import (EvictionPolicy,
                                              FrequencyWeightedPolicy)


@dataclasses.dataclass(eq=False)
class PrefixNode:
    """One cached physical page covering ``tokens`` (<= page_size ids)."""

    tokens: tuple
    page: int
    parent: "PrefixNode | None"
    children: dict = dataclasses.field(default_factory=dict)
    hits: int = 0
    frag: list | None = None   # gathered backend: raw-fp per-leaf slices


class PrefixIndex:
    """Token-prefix trie mapping prompt spans to shared KV pages."""

    def __init__(self, allocator, page_size: int, *, page_bytes: int = 1,
                 policy: EvictionPolicy | None = None):
        self.allocator = allocator
        self.page_size = page_size
        self.page_bytes = max(int(page_bytes), 1)
        self.policy = policy if policy is not None \
            else FrequencyWeightedPolicy()
        self._root = PrefixNode(tokens=(), page=-1, parent=None)

    # -- introspection ------------------------------------------------------
    def _nodes(self):
        stack = list(self._root.children.values())
        while stack:
            node = stack.pop()
            stack.extend(node.children.values())
            yield node

    @property
    def n_nodes(self) -> int:
        return sum(1 for _ in self._nodes())

    @property
    def tokens_cached(self) -> int:
        return sum(len(n.tokens) for n in self._nodes())

    # -- lookup -------------------------------------------------------------
    def lookup(self, prompt, limit: int, align: int):
        """Longest cached prefix of ``prompt`` -> (nodes, matched tokens).

        ``limit`` caps the raw match (callers pass ``prompt_len - 1``);
        the match is then floored to a multiple of ``align`` (the prefill
        chunk size).  The nodes back positions ``[0, matched)`` page by
        page; ``matched == 0`` means no usable hit."""
        P = self.page_size
        toks = tuple(int(t) for t in prompt)
        node, path, i = self._root, [], 0
        while len(toks) - i >= P:
            child = node.children.get(toks[i:i + P])
            if child is None or len(child.tokens) < P:
                break
            path.append(child)
            node = child
            i += P
        # one more page of partial match: the child (full or partial)
        # sharing the longest common prefix with the remainder
        best, best_node = 0, None
        for child in node.children.values():
            n = 0
            for a, b in zip(child.tokens, toks[i:]):
                if a != b:
                    break
                n += 1
            if n > best:
                best, best_node = n, child
        matched = min(i + best, limit)
        matched -= matched % max(align, 1)
        if matched <= 0:
            return [], 0
        n_pages = -(-matched // P)
        if best_node is not None and n_pages > len(path):
            path.append(best_node)
        del path[n_pages:]
        return path, matched

    def hit(self, nodes) -> None:
        """Bump every mapped node: its hit count is re-seeded as the
        eviction policy's prior on top of the aged bump."""
        for node in nodes:
            node.hits += 1
            self.policy.seed(node, float(node.hits))
            self.policy.on_hit(node)

    # -- registration -------------------------------------------------------
    def register(self, prompt, row, frags=None,
                 allow_partial: bool = True) -> bool:
        """Insert ``prompt``'s pages (page-table ``row``) into the trie,
        one allocator reference per new node; spans already cached dedupe
        onto their page.  ``frags[j]`` (gathered backend) holds the raw-fp
        per-leaf slices backing page ``j``.  -> True iff a new partial
        boundary node was created (the caller funds its copy-on-write)."""
        P = self.page_size
        toks = tuple(int(t) for t in prompt)
        node, new_partial = self._root, False
        n_full = len(toks) // P
        for j in range(n_full):
            key = toks[j * P:(j + 1) * P]
            child = node.children.get(key)
            if child is None:
                child = self._insert(node, key, int(row[j]),
                                     frags[j] if frags else None)
            node = child
        rem = toks[n_full * P:]
        if rem and allow_partial and rem not in node.children:
            self._insert(node, rem, int(row[n_full]),
                         frags[n_full] if frags else None)
            new_partial = True
        return new_partial

    def _insert(self, parent, key, page, frag) -> PrefixNode:
        child = PrefixNode(tokens=key, page=self.allocator.share(page),
                           parent=parent, frag=frag)
        parent.children[key] = child
        self.policy.on_insert(child, self.page_bytes)
        return child

    # -- eviction -----------------------------------------------------------
    def _drop(self, node) -> None:
        del node.parent.children[node.tokens]
        self.policy.on_remove(node)
        self.allocator.release([node.page])

    def evict_until(self, need: int) -> int:
        """Drop childless nodes in eviction order until
        ``allocator.available() >= need`` -> nodes dropped.  A dropped
        node frees its page only when no slot still maps it, so the loop
        goes on past mapped victims."""
        dropped = 0
        while self.allocator.available() < need:
            victim = next((n for n in self.policy.order()
                           if not n.children), None)
            if victim is None:
                break
            self._drop(victim)
            dropped += 1
        return dropped

    def clear(self) -> int:
        """Drop every node (releasing the index's page references)."""
        dropped = 0
        while True:
            leaves = [n for n in self._nodes() if not n.children]
            if not leaves:
                break
            for node in leaves:
                self._drop(node)
                dropped += 1
        self.policy.clear()
        return dropped

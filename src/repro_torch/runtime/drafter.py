"""Draft-token proposers for speculative decoding (port of
``repro.runtime.drafter``).

The scheduler asks a :class:`Drafter` for up to ``k`` guesses of each
slot's next tokens, puts them after the slot's real next token as a
ragged ``q_lens[s] = 1 + k_s`` block, and scores the whole block in one
step.  Greedy verification accepts the longest prefix of drafts that
matches the model's own argmax chain, so any proposal leaves the output
token-identical to plain decoding; drafters only trade proposal cost
against acceptance.

* :class:`NGramDrafter` — no model: look the slot's recent suffix up in
  its own prompt + generation history and propose what followed it last
  time.
* :class:`DraftModelDrafter` — a tiny transformer whose binarised MLP
  tiles are registered in the engine's ``WeightStore`` as
  ``model_id="draft"``, so they decode through the same tile cache (and,
  on the card, the same Huffman-decode kernel) as the target's.
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch.configs.base import get_config
from repro_torch.models.transformer import forward, init_params
from repro_torch.tree import tree_map

_EMPTY = np.zeros((0,), np.int64)


class Drafter:
    """Interface: batched draft proposals.

    ``propose(histories, k, limits=None)`` takes one token history per
    decoding slot (prompt + everything generated so far) and returns one
    int64 array of 0..k draft tokens per slot; ``limits[i]`` caps slot
    ``i``'s proposal further.  Proposals are deterministic functions of
    the history."""

    name = "drafter"

    def propose(self, histories, k: int, limits=None):
        raise NotImplementedError


def _clamp(draft: np.ndarray, k: int, limit) -> np.ndarray:
    n = min(len(draft), k if limit is None else min(k, max(0, int(limit))))
    return np.asarray(draft[:n], np.int64)


class NGramDrafter(Drafter):
    """Suffix-match drafting from the slot's own history: for n-gram
    orders ``max_order`` down to 1, find the most recent earlier
    occurrence of the history's final n-gram and propose what followed
    it; the first order with a match wins, and a history whose suffix
    never occurred before proposes nothing."""

    name = "ngram"

    def __init__(self, max_order: int = 3):
        assert max_order >= 1, max_order
        self.max_order = max_order

    def _propose_one(self, hist: np.ndarray, k: int) -> np.ndarray:
        n = len(hist)
        if n == 0 or k <= 0:
            return _EMPTY
        for order in range(min(self.max_order, n), 0, -1):
            suffix = hist[n - order:]
            # most recent match with a full k-token continuation first;
            # inside a repeated run the latest matches sit flush against
            # the end, so the longest follow seen is the fallback
            best = _EMPTY
            for start in range(n - order - 1, -1, -1):
                follow = hist[start + order:start + order + k]
                if np.array_equal(hist[start:start + order], suffix):
                    if len(follow) == k:
                        return np.asarray(follow, np.int64)
                    if len(follow) > len(best):
                        best = follow
            if len(best):
                return np.asarray(best, np.int64)
        return _EMPTY

    def propose(self, histories, k: int, limits=None):
        out = []
        for i, hist in enumerate(histories):
            h = np.asarray(hist, np.int64).reshape(-1)
            lim = None if limits is None else limits[i]
            out.append(_clamp(self._propose_one(h, k), k, lim))
        return out


# the tiny draft arch: minitron's block layout at toy width
_DRAFT_SCALED = dict(num_layers=2, scan_repeats=2, d_model=64,
                     num_heads=4, num_kv_heads=2, head_dim=16, d_ff=128)


def draft_config(vocab_size: int, base: str = "minitron-8b"):
    """``base``'s architecture at toy scale, vocab-matched to the target
    (draft tokens index the target's logits rows)."""
    return get_config(base).scaled(dtype="float32",
                                   vocab_size=vocab_size, **_DRAFT_SCALED)


class DraftModelDrafter(Drafter):
    """Greedy drafting with a tiny transformer on the engine's weight
    store.

    Its params are drawn from ``seed`` by an explicit generator on the
    engine's device (or given as ``params``, a tree on any device) and
    its compressible weights registered in ``engine.store`` under
    ``model_id="draft"``; when that fails (nothing compressible, or a
    draft model already registered there) the params are served raw, as
    the reference does.  A proposal is ``k`` greedy forwards over the
    history's last ``window`` tokens, zero-padded to one shape: stateless,
    so no cache has to follow the scheduler's rollbacks."""

    name = "draft"

    def __init__(self, engine, *, base: str = "minitron-8b",
                 window: int = 32, seed: int = 0, params=None):
        self.window = int(window)
        self.device = engine.device
        cfg = draft_config(engine.cfg.vocab_size, base)
        if params is None:
            params = init_params(
                cfg, torch.Generator(device=self.device).manual_seed(seed),
                self.device)
        else:
            params = tree_map(lambda a: a.to(self.device), params)
        self.store = engine.store
        self._raw = None
        try:
            self.store.register_model("draft", params)
            cfg = cfg.scaled(binarize_mlp=True)
        except ValueError:
            self._raw = params
        self.cfg = cfg

    def _params(self):
        if self._raw is not None:
            return self._raw
        with torch.no_grad():
            return self.store.materialize("draft")

    def propose(self, histories, k: int, limits=None):
        params = self._params()
        out = []
        for i, hist in enumerate(histories):
            h = list(np.asarray(hist, np.int64).reshape(-1))
            lim = None if limits is None else limits[i]
            kk = k if lim is None else min(k, max(0, int(lim)))
            if not h or kk <= 0:
                out.append(_EMPTY)
                continue
            draft = []
            for _ in range(kk):
                tail = h[-self.window:]
                toks = np.zeros((1, self.window), np.int32)
                toks[0, :len(tail)] = tail
                with torch.no_grad():
                    logits = forward(self.cfg, params, torch.from_numpy(
                        toks).to(self.device))[0]
                nxt = int(torch.argmax(logits[0, len(tail) - 1]))
                draft.append(nxt)
                h.append(nxt)
            out.append(np.asarray(draft, np.int64))
        return out


def make_drafter(spec: str, engine=None) -> Drafter | None:
    """Resolve a ``--speculate`` spec: ``"off"`` -> None, ``"ngram"`` ->
    :class:`NGramDrafter`, ``"draft"`` / ``"draft:<base-arch>"`` ->
    :class:`DraftModelDrafter` on ``engine``'s weight store."""
    if spec in (None, "off", ""):
        return None
    if spec == "ngram":
        return NGramDrafter()
    if spec == "draft" or spec.startswith("draft:"):
        if engine is None:
            raise ValueError("draft-model speculation needs an engine")
        base = spec.split(":", 1)[1] if ":" in spec else "minitron-8b"
        return DraftModelDrafter(engine, base=base)
    raise ValueError(f"unknown speculate spec {spec!r}; expected "
                     "'off', 'ngram', 'draft' or 'draft:<arch>'")

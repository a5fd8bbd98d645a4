"""Serving-time autotuning of the decode-cache capacity (port of the
capacity half of ``repro.runtime.autotune``).

The paper's §IV working-set threshold reappears at serving time as a
cliff in the decode-cache hit-rate-vs-capacity curve: below the decoded
working set the cyclic materialize scan thrashes, at it the rate jumps
to ~(steps-1)/steps.  :func:`find_knee` locates that cliff on any
measured (capacity, hit-rate) curve and returns the knee -- the smallest
capacity past the cliff within a tolerance of the best measured rate,
past which more memory buys no hits.  The launcher's ``--cache-mb auto``
resolves through it.

:func:`recommend_store_capacity` runs the sweep against a registered
model: it replays the materialize access pattern (every step touches
every tile of every compressed layer) through fresh
:class:`DecodeTileCache` instances at a grid of fractions of the decoded
working set -- pure cache accounting on the host, no tile decodes and no
device work.  The reference's sweep re-tiles each layer from its stream
with a scalar loop (``StoredLayer.ensure_tiled``); the port reads the
tiles it cut at registration (``StoredLayer.tiled``), the same words.

The reference's kernel launch-shape tuner (``tune_kernel``) sweeps TPU
launch knobs the port does not take and is not ported.
"""

from __future__ import annotations

from repro_torch.runtime.decode_cache import DecodeTileCache

# the sweep grid: fine below 0.5 where the cliff usually sits
DEFAULT_FRACTIONS = (0.05, 0.1, 0.15, 0.2, 0.25, 0.3, 0.4,
                     0.5, 0.6, 0.75, 0.9, 1.0)


def find_knee(capacities, rates, tolerance: float = 0.02) -> int:
    """Index of the knee of a measured hit-rate-vs-capacity curve.

    The cliff is the largest hit-rate jump between consecutive
    capacities; the knee is the smallest capacity at/after the cliff
    whose hit rate is within ``tolerance`` of the best measured rate.
    Non-monotone curves where nothing past the cliff qualifies fall
    back to the best capacity itself, so the returned index always
    satisfies ``rates[i] >= max(rates) - tolerance``.

    Ties between equal-size jumps break toward the *latest* one: on a
    staircase curve (several equal jumps), the working-set cliff is the
    last riser -- picking the first would return a capacity still inside
    the thrashing region.
    """
    if len(capacities) != len(rates) or not rates:
        raise ValueError("need equal-length, non-empty capacity/rate lists")
    best = max(rates)
    best_i = max(range(len(rates)), key=lambda i: rates[i])
    jumps = [rates[i] - rates[i - 1] for i in range(1, len(rates))]
    cliff = max(range(len(jumps)), key=lambda i: (jumps[i], i)) + 1 \
        if jumps else 0
    return next((i for i in range(cliff, len(rates))
                 if rates[i] >= best - tolerance), best_i)


def sweep_store(store, model_id: str, *, steps: int = 8,
                policy: str | None = None,
                fractions=DEFAULT_FRACTIONS) -> tuple:
    """Replay ``steps`` materialize scans of ``model_id`` at each cache
    capacity fraction -> (capacities, hit_rates).

    The scan is simulated through the cache's own accounting (every
    step touches every tile of every layer, in registration order, with
    the layer's real decoded/compressed byte sizes and frequency
    priors) -- the access pattern is exact, only the tile *values* are
    stand-ins, so the hit rates match a real materialize sweep.
    """
    working_set = store.decoded_bytes(model_id)
    layers = [(layer, layer.tiled)
              for stack in store.layers(model_id).values()
              for layer in stack]
    # tiny models round int(working_set * frac) below a single decoded
    # tile (even to 0), making the low-fraction sweep points degenerate
    # caches that can never hold anything -- clamp every capacity to the
    # largest decoded tile so each point can at least cache one tile
    min_cap = max((ts.c * ts.s * 4 for _, ts in layers), default=1)
    caps, rates = [], []
    for frac in fractions:
        cap = max(int(working_set * frac), min_cap)
        cache = DecodeTileCache(cap, policy=policy)
        for layer, ts in layers:
            if layer.tile_freq is not None:
                for t in range(ts.n_tiles):
                    cache.seed_frequency((model_id, layer.name, t),
                                         float(layer.tile_freq[t]))
        for _ in range(steps):
            for layer, ts in layers:
                nbytes = ts.c * ts.s * 4            # decoded int32 tile
                streamed = layer.tile_compressed_bytes()
                for t in range(ts.n_tiles):
                    key = (model_id, layer.name, t)
                    if cache.get(key) is None:
                        cache.put(key, True, nbytes=nbytes,
                                  streamed_bytes=streamed)
        caps.append(cap)
        rates.append(cache.hit_rate())
    return caps, rates


def recommend_store_capacity(store, model_id: str, *, steps: int = 8,
                             policy: str | None = None,
                             fractions=DEFAULT_FRACTIONS,
                             tolerance: float = 0.02) -> dict:
    """Recommended decode-cache capacity for serving ``model_id``.

    Returns a dict: ``capacity`` (bytes, the knee), ``fraction`` (of
    the decoded working set), ``hit_rate`` (measured at the knee),
    ``best_rate``, ``working_set`` (decoded bytes), and the full
    ``capacities`` / ``rates`` sweep for reporting.
    """
    caps, rates = sweep_store(store, model_id, steps=steps, policy=policy,
                              fractions=fractions)
    knee = find_knee(caps, rates, tolerance=tolerance)
    return {
        "capacity": caps[knee],
        "fraction": fractions[knee],
        "hit_rate": rates[knee],
        "best_rate": max(rates),
        "working_set": store.decoded_bytes(model_id),
        "capacities": caps,
        "rates": rates,
    }

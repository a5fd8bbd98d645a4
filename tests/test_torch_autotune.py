"""The port's decode-cache autotuner (``--cache-mb auto``) against the JAX
package, on the CPU: ``find_knee`` gives the reference's index on its
cases and on seeded random curves and refuses the same input, and the
sweep clamps tiny models, recommends a capacity inside the working set
and leaves the store's own cache alone.  The sweep against the
reference's stores, serving at the recommended capacity and the launcher
are held in ``test_torch_autotune_serve.py``.
"""

import numpy as np
import pytest
import torch

from repro.runtime import autotune as jax_autotune
from repro_torch.runtime import (DecodeTileCache, WeightStore, find_knee,
                                 recommend_store_capacity, sweep_store)
from repro_torch.runtime import autotune

KNEE_CASES = [
    ([10, 20, 30, 40, 50], [0.05, 0.10, 0.80, 0.81, 0.82], 0.02),
    ([10, 20, 30], [0.10, 0.70, 0.80], 0.02),
    ([10, 20, 30], [0.10, 0.70, 0.80], 0.15),
    ([10, 20, 30, 40], [0.10, 0.40, 0.70, 1.00], 0.02),
    ([10, 20, 30], [0.0, 0.8, 0.81], 0.02),
    ([1], [0.3], 0.02),
    ([1, 2, 3, 4], [0.9, 0.1, 0.9, 0.1], 0.02),
    ([1, 2, 3], [0.0, 0.0, 0.0], 0.0),
]


class TestAutotune:
    @pytest.mark.parametrize("caps,rates,tol", KNEE_CASES)
    def test_find_knee_cases(self, caps, rates, tol):
        want = jax_autotune.find_knee(caps, rates, tolerance=tol)
        assert find_knee(caps, rates, tolerance=tol) == want
        assert rates[want] >= max(rates) - tol

    @pytest.mark.parametrize("seed", range(4))
    def test_find_knee_random_curves(self, seed):
        rng = np.random.default_rng(seed)
        for n in range(1, 14):
            rates = list(rng.uniform(0, 1, n))
            if seed % 2:
                rates = sorted(rates)
            for tol in (0.0, 0.02, 0.2):
                assert find_knee(list(range(n)), rates, tol) == \
                    jax_autotune.find_knee(list(range(n)), rates, tol)

    @pytest.mark.parametrize("fn", [find_knee, jax_autotune.find_knee],
                             ids=["port", "jax"])
    def test_find_knee_rejects_bad_input(self, fn):
        with pytest.raises(ValueError):
            fn([1, 2], [0.5])
        with pytest.raises(ValueError):
            fn([], [])

    def test_default_fractions(self):
        assert autotune.DEFAULT_FRACTIONS == jax_autotune.DEFAULT_FRACTIONS

    def test_sweep_store_clamps_tiny_models(self):
        """A model whose working set rounds ``int(ws * frac)`` below one
        decoded tile still sweeps caches that hold a tile."""
        store = WeightStore(DecodeTileCache())
        store.register_model("tiny", {"mlp": {"up": torch.ones(4, 16)}})
        caps, rates = sweep_store(store, "tiny", steps=8)
        tile = max(l.tiled.c * l.tiled.s * 4
                   for stack in store.layers("tiny").values() for l in stack)
        assert all(c >= tile for c in caps)
        assert rates[-1] == pytest.approx(7 / 8)
        rec = recommend_store_capacity(store, "tiny", steps=8)
        assert rec["capacity"] >= tile and rec["hit_rate"] > 0

    def test_recommend_store_capacity(self):
        rng = np.random.default_rng(0)
        w = torch.from_numpy(rng.standard_normal((64, 256)).astype(
            np.float32))
        store = WeightStore(DecodeTileCache())
        store.register_model("m", {"mlp": {"up": w}})
        rec = recommend_store_capacity(store, "m", steps=8)
        ws = store.decoded_bytes("m")
        assert rec["working_set"] == ws
        assert 0 < rec["capacity"] <= ws
        assert rec["capacity"] == int(ws * rec["fraction"])
        assert 0.0 <= rec["hit_rate"] <= rec["best_rate"] <= 1.0
        assert len(rec["capacities"]) == len(rec["rates"])
        assert rec["rates"][-1] == pytest.approx(7 / 8)

    def test_sweep_leaves_the_store_and_its_cache_alone(self):
        """The sweep is accounting on caches of its own: the store's cache
        and tiles are untouched, and nothing is decoded."""
        rng = np.random.default_rng(1)
        store = WeightStore(DecodeTileCache())
        store.register_model("m", {"mlp": {"up": torch.from_numpy(
            rng.standard_normal((128, 256)).astype(np.float32))}})
        words = [l.words.clone() for s in store.layers("m").values()
                 for l in s]
        recommend_store_capacity(store, "m")
        assert store.cache.stats()["hits"] == store.cache.misses == 0
        assert len(store.cache) == 0
        assert all(torch.equal(a, l.words) for a, l in zip(
            words, [l for s in store.layers("m").values() for l in s]))
